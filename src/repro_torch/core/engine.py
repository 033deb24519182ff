"""Session-oriented SSSP query engine: build once, solve query batches.

Port of the reference's ``core/engine.py`` on the ``sim`` backend: all P
shards stacked on one device.

    eng = SsspEngine.build(graph_or_shards, cfg)          # on cuda
    res = eng.solve([3, 17, 1999])                        # QueryResult

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no ``device`` argument, ``build`` raises rather
than fall back to the CPU. A batch is padded to the next power-of-two
bucket: padded rows start with no frontier and ``done=True``, so results
are bit-identical to the unpadded solve. The host syncs once per round
(the termination check), as the reference's sim loop does.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.shards import SsspShards, build_shards
from repro_torch.core.sssp import (SsspConfig, SsspStats, _Carry,
                                   certificate_improved_sim,
                                   dispatches_per_round, init_carry,
                                   make_finalize, make_round)
from repro_torch.device import resolve_device


def bucket_k(k: int) -> int:
    """Bucket policy: the next power of two >= k."""
    if k < 1:
        raise ValueError("at least one source is required")
    return 1 << (k - 1).bit_length()


def _total(counts: torch.Tensor) -> np.int32:
    """A counter's total over shards (and queries), summed in int32 so that
    it wraps past 2**31 - 1 as the reference's ``np.sum(..., dtype=np.int32)``
    does."""
    return np.int32(int(counts.sum(dtype=torch.int32)))


def _as_sources(sources, n_vertices: int) -> tuple[int, ...]:
    if isinstance(sources, (int, np.integer)):
        srcs = (int(sources),)
    else:
        srcs = tuple(int(s) for s in sources)
    for s in srcs:
        if not 0 <= s < n_vertices:
            raise ValueError(f"source {s} out of range [0, {n_vertices})")
    return srcs


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Result of one solved batch. ``dist``/``q_rounds``/``q_relaxations``
    cover the real queries (padded rows sliced away).

    ``status``: ``"converged"`` (every query passed the fixpoint
    certificate), ``"max_rounds"`` (the round budget ran out first) or
    ``"degraded"`` (a detector fired but the certificate found an
    improvement)."""

    dist: np.ndarray            # [K, n_vertices]
    sources: tuple
    stats: SsspStats
    bucket_k: int
    backend: str
    wall_s: float
    device: str = "cpu"
    status: str = "converged"

    @property
    def q_rounds(self) -> np.ndarray:
        return np.asarray(self.stats.q_rounds)

    @property
    def q_relaxations(self) -> np.ndarray:
        return np.asarray(self.stats.q_relaxations)

    @property
    def q_converged(self) -> np.ndarray:
        return np.asarray(self.stats.q_converged)


class SsspEngine:
    """One per-graph session on the ``sim`` backend: owns the shards (on
    its device), the resolved round and, for the fused round, the exit-time
    merge of the last delivered batch."""

    def __init__(self, shards: SsspShards, cfg: SsspConfig,
                 backend: str = "sim", *, device=None):
        if backend == "shmap":
            raise NotImplementedError(
                "backend='shmap' is not ported yet: ROADMAP Queue 1 item 8")
        if backend != "sim":
            raise ValueError(f"unknown backend {backend!r}; valid: "
                             "['shmap', 'sim']")
        self.device = resolve_device(device)
        self.shards = shards.to(self.device)
        self.cfg = cfg
        self.backend = backend
        self.round_fn = make_round(self.shards, cfg)
        self._finalize = make_finalize(self.shards, cfg)

    @classmethod
    def build(cls, graph_or_shards, cfg: SsspConfig | None = None,
              backend: str = "sim", *, n_parts: int = 8, device=None,
              **shard_kwargs) -> "SsspEngine":
        """A session over ``SsspShards`` (used as-is) or a ``Graph``
        (partitioned here with ``n_parts`` and any ``build_shards``
        keyword)."""
        dev = resolve_device(device)      # fail before any host work without CUDA
        if isinstance(graph_or_shards, SsspShards):
            if shard_kwargs:
                raise ValueError("shard build options only apply when "
                                 "building from a Graph")
            sh = graph_or_shards
        else:
            sh = build_shards(graph_or_shards, n_parts, **shard_kwargs)
        return cls(sh, cfg or SsspConfig(), backend, device=dev)

    @property
    def n_vertices(self) -> int:
        return self.shards.n_vertices

    @property
    def n_parts(self) -> int:
        return self.shards.n_parts

    def start(self, sources, *, bucket: bool = True) -> _Carry:
        """The initial carry of a (padded) source batch."""
        srcs = _as_sources(sources, self.n_vertices)
        if not srcs:
            raise ValueError("at least one source is required")
        k = len(srcs)
        kb = bucket_k(k) if bucket else k
        src_arr = np.zeros((kb,), np.int32)
        src_arr[:k] = srcs
        q_valid = np.arange(kb) < k
        return init_carry(self.shards, src_arr, self.cfg, q_valid=q_valid)

    def solve(self, sources, *, bucket: bool = True) -> QueryResult:
        """Solve a source batch (int or sequence), padded to its bucket."""
        srcs = _as_sources(sources, self.n_vertices)
        k = len(srcs)
        t0 = time.perf_counter()
        carry = self.start(srcs, bucket=bucket)
        kb = carry.dist.shape[1]
        while carry.rounds < self.cfg.max_rounds:
            carry = self.round_fn(carry)
            if bool(carry.done.all()):          # one host sync per round
                break
        done_k = carry.done[0, :k].cpu().numpy()
        dist_pk = (carry.dist if self._finalize is None
                   else self._finalize(carry))
        dist = dist_pk.transpose(0, 1).reshape(kb, -1)[:k, :self.n_vertices]
        stats = SsspStats(
            rounds=np.int32(carry.rounds),
            relaxations=_total(carry.relaxations),
            msgs_sent=_total(carry.msgs_sent),
            msgs_recv=_total(carry.msgs_recv),
            pruned_edges=_total(carry.pruned),
            q_rounds=carry.q_rounds.amax(0)[:k].cpu().numpy(),
            q_relaxations=carry.relaxations.sum(0, dtype=torch.int32)[:k]
            .cpu().numpy(),
            stale_merges=np.int32(0), resends=np.int32(0),
            n_dispatches=np.int32(
                carry.rounds * dispatches_per_round(self.shards, self.cfg)),
            overlap_rounds=np.int32(0),
            bytes_moved=np.int32(int(carry.comm_bytes)))
        # the detector's word (done_k) is a claim; one extra unmasked relax
        # round is the proof, and overrides it in both directions
        q_conv = ~certificate_improved_sim(self.shards,
                                           dist_pk)[:k].cpu().numpy()
        if q_conv.all():
            status = "converged"
        elif (~q_conv & ~done_k).any():
            status = "max_rounds"
        else:
            status = "degraded"
        dist = dist.cpu().numpy()
        return QueryResult(dist=dist, sources=srcs,
                           stats=stats._replace(q_converged=q_conv),
                           bucket_k=kb, backend=self.backend,
                           wall_s=time.perf_counter() - t0,
                           device=str(self.device), status=status)

    def __repr__(self):
        return (f"SsspEngine(backend={self.backend!r}, device="
                f"{str(self.device)!r}, n_vertices={self.n_vertices}, "
                f"n_parts={self.n_parts})")
