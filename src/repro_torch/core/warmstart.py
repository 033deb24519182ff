"""Warm start: the landmark distance cache and the query-result LRU.

Port of the reference's ``core/warmstart.py``, on the stacked ``sim``
representation and on a rank's shard of the ``shmap`` backend. Both
caches are owned by ``SsspEngine``:

1. **Landmark cache** (``LandmarkCache``): L pivot sources solved once,
   their distances kept on the engine's device as ``[P, L, block]``, the
   layout of the carry's ``dist`` (a rank of the shmap backend keeps its
   row, ``[1, L, block]``). The ``landmark`` warm-init stage seeds
   every query's distances with the triangle-inequality upper bound
   ``min_l(land[l, src] + land[l, v])`` instead of +inf, and every seeded
   vertex starts active, so the monotone round reaches the cold solve's
   fixpoint bit for bit (a repeated pivot in one round; other sources
   still wait for the exact values' cross-shard hops, since the inflated
   bound is never exact). The bound needs symmetric
   distances (every undirected generator gives them). Memory: 4 B x L x
   block a shard.
2. **Result cache** (``ResultCache``): an LRU of solved rows keyed by
   ``(source, graph_epoch)``; a hit costs no round. Bumping the engine's
   ``graph_epoch`` orphans every row and the landmark cache.

The ``warm_init`` phase registers here (``none | landmark``) so
``SsspConfig`` validates ``cfg.warm_start`` like every other phase.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import phases
from repro_torch.kernels.common import INF

# Relative inflation of every bound whose landmark-to-source leg is
# nonzero. The two-leg float sum can land a few ulps BELOW the value the
# cold solve reaches edge by edge along the same path, and the monotone
# pipeline would keep such a seed, breaking bit-identity with the cold
# solve; ~1.7e3 ulps of inflation keeps the seed at or above the cold
# fixpoint. A zero leg (the source IS the landmark) is not inflated:
# ``0 + land[l, v]`` is that pivot's solved row exactly, so a repeated
# pivot converges in one round. A float32 tensor, so that the product is
# taken in float32 as the reference takes it.
WARM_EPS = torch.tensor(1.0 + 1e-4, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class LandmarkCache:
    """L solved pivot sources, distances stored as the carry's.

    ``dist[p, l, v]`` = distance from landmark ``l`` to local vertex ``v``
    of shard ``p`` (+inf where unreachable or padding). ``epoch`` ties the
    cache to the graph state it was computed against."""

    sources: tuple          # the L landmark source ids
    dist: torch.Tensor      # [P, L, block] f32
    epoch: int              # graph epoch this cache is valid for

    @property
    def n_landmarks(self) -> int:
        return self.dist.shape[1]

    @property
    def nbytes_per_shard(self) -> int:
        """The cost model: 4 B x L x block per shard."""
        return 4 * self.dist.shape[1] * self.dist.shape[2]

    def __repr__(self):
        return (f"LandmarkCache(L={self.n_landmarks}, "
                f"sources={self.sources}, epoch={self.epoch}, "
                f"{self.nbytes_per_shard}B/shard)")


def landmark_seed_stacked(land: torch.Tensor, sources: torch.Tensor,
                          q_valid: torch.Tensor) -> torch.Tensor:
    """Warm seed over the stacked representation.

    ``land`` [P, L, block], ``sources`` [K] int, ``q_valid`` [K] bool, all
    on one device. Returns [P, K, block] = ``min_l(land[l, src_k] +
    land[p, l, v])`` (times ``WARM_EPS`` where ``land[l, src_k] != 0``),
    +inf for invalid (padded) queries so they start as the cold path's."""
    n_parts, n_land, block = land.shape
    flat = land.transpose(0, 1).reshape(n_land, n_parts * block)
    at_src = flat[:, sources.long()]                            # [L, K]
    eps = WARM_EPS.to(land.device)
    seed = torch.full((n_parts, sources.shape[0], block), INF,
                      device=land.device)
    for l in range(n_land):
        leg = at_src[l][None, :, None]
        bound = leg + land[:, l][:, None, :]
        bound = torch.where(leg == 0.0, bound, bound * eps)
        seed = torch.minimum(seed, bound)
    return torch.where(q_valid[None, :, None], seed, INF)


def landmark_seed_shard(land_loc: torch.Tensor, sources: torch.Tensor,
                        q_valid: torch.Tensor, rank: int, block: int,
                        min_all) -> torch.Tensor:
    """The warm seed on a rank of the shmap backend.

    ``land_loc`` [1, L, block] is this rank's landmark rows. The
    landmark-at-source leg needs the owner's value: each rank contributes
    ``land[l, src_k]`` where it owns ``src_k`` (+inf elsewhere) and
    ``min_all`` (an all-reduce min, one [L, K] collective) gives every
    rank the owner's. Returns [1, K, block], the rank's row of
    ``landmark_seed_stacked``, bit for bit."""
    owner = sources // block
    local = (sources % block).long()
    mine = (owner == rank) & q_valid                            # [K]
    contrib = torch.where(mine[None, :], land_loc[0][:, local], INF)
    at_src = min_all(contrib)                                   # [L, K]
    eps = WARM_EPS.to(land_loc.device)
    seed = torch.full((1, sources.shape[0], block), INF,
                      device=land_loc.device)
    for l in range(land_loc.shape[1]):
        leg = at_src[l][None, :, None]
        bound = leg + land_loc[:, l][:, None, :]
        bound = torch.where(leg == 0.0, bound, bound * eps)
        seed = torch.minimum(seed, bound)
    return torch.where(q_valid[None, :, None], seed, INF)


class WarmInitStage(NamedTuple):
    """Registry entry of a warm-init backend. ``needs_landmarks`` gates the
    engine's cache requirement; ``seed_stacked`` (the sim backend) and
    ``seed_shard`` (a rank of the shmap backend) make the seed that
    ``init_carry`` takes (None keeps the cold +inf start)."""
    name: str
    needs_landmarks: bool
    seed_stacked: Any   # (land, sources, q_valid) -> [P, K, block] | None
    seed_shard: Any = None  # (land_loc, sources, q_valid, rank, block,
                            #  min_all) -> [1, K, block] | None


phases.register("warm_init", "none")(WarmInitStage(
    "none", needs_landmarks=False, seed_stacked=None))
phases.register("warm_init", "landmark")(WarmInitStage(
    "landmark", needs_landmarks=True, seed_stacked=landmark_seed_stacked,
    seed_shard=landmark_seed_shard))


class CachedRow(NamedTuple):
    """One solved query kept across calls: the full distance row. A cache
    hit reports zero rounds and relaxations (the call did no work)."""
    dist: np.ndarray        # [n_vertices] f32


class ResultCache:
    """LRU over solved ``(source, graph_epoch)`` rows.

    ``get`` refreshes recency; ``put`` evicts the least recently used row
    once ``maxsize`` is exceeded. ``maxsize == 0`` disables the cache
    (every lookup misses, nothing is stored), the engine's default."""

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._rows: OrderedDict[tuple, CachedRow] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._rows)

    def get(self, source: int, epoch: int) -> CachedRow | None:
        if self.maxsize == 0:
            return None
        row = self._rows.get((source, epoch))
        if row is None:
            self.misses += 1
            return None
        self._rows.move_to_end((source, epoch))
        self.hits += 1
        return row

    def put(self, source: int, epoch: int, row: CachedRow) -> None:
        if self.maxsize == 0:
            return
        self._rows[(source, epoch)] = row
        self._rows.move_to_end((source, epoch))
        while len(self._rows) > self.maxsize:
            self._rows.popitem(last=False)

    def clear(self) -> None:
        self._rows.clear()
