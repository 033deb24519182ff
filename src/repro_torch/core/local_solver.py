"""Intra-partition solver: the paper's "Dijkstra within each node" as
iterated frontier-masked relaxation to a local fixpoint.

Port of the reference's ``core/local_solver.py`` (``bellman``, ``delta``
and ``pallas``). Every function takes the ``sim`` backend's stacked state:
dist/active ``[P, K, block]``, the Trishla mask ``pruned_loc [P, e_loc]``.
Each (shard, query) row iterates on its own, as the reference's vmapped
``while_loop`` lanes do.

- ``bellman``: each step relaxes the local edges whose source improved in
  the previous step (gather + scatter-min), until no row has a frontier.
- ``delta``: bellman's steps restricted to each row's near bucket, the
  frontier vertices within ``delta`` of the row's nearest one; the rest
  wait in the frontier for a later step (Dijkstra-order settling without
  a heap).
- ``pallas``: the dst-tiled relax kernel (dense or ragged, by the shards'
  layout) run as a fused multi-sweep fixpoint (``kernels/relax``),
  re-invoked from a host loop on the residual frontier until every shard's
  frontier is empty.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import phases
from repro_torch.kernels.common import INF, scatter_min_drop, take_fill
from repro_torch.kernels.relax import fixpoint_operands, relax_to_fixpoint


class LocalResult(NamedTuple):
    dist: torch.Tensor         # [P, K, block] f32
    relaxations: torch.Tensor  # [P, K] int32 edge relaxations performed


def _sweep(dist, frontier, loc_src, loc_dst, w):
    """One masked relaxation sweep over every row. Returns (dist',
    new_frontier, n_relax [P, K])."""
    src = loc_src[:, None, :]
    src_ok = take_fill(frontier, src, False)
    d_src = take_fill(dist, src, INF)
    cand = torch.where(src_ok, d_src + w[:, None, :], INF)
    new = scatter_min_drop(dist, loc_dst[:, None, :], cand)
    n_relax = (src_ok & (w[:, None, :] < INF)).sum(-1, dtype=torch.int32)
    return new, new < dist, n_relax


@phases.register("local_solver", "bellman")
def local_fixpoint_bellman(dist, active, sh, pruned_loc, *,
                           max_iters: int, sweeps: int,
                           delta: float) -> LocalResult:
    """Relax frontier edges until no local change. A row whose step budget
    ``max_iters`` is spent stops with its frontier, as the reference's
    lane does."""
    w = torch.where(pruned_loc, INF, sh.loc_w)
    it = torch.zeros(active.shape[:2], dtype=torch.int32, device=dist.device)
    nrel = torch.zeros_like(it)
    frontier = active
    while True:
        run = frontier.any(-1) & (it < max_iters)          # [P, K]
        if not bool(run.any()):
            break
        new, new_front, n = _sweep(dist, frontier & run[..., None],
                                   sh.loc_src, sh.loc_dst, w)
        dist = new
        frontier = torch.where(run[..., None], new_front, frontier)
        nrel += n
        it += run.to(torch.int32)
    return LocalResult(dist=dist, relaxations=nrel)


@phases.register("local_solver", "delta")
def local_fixpoint_delta(dist, active, sh, pruned_loc, *, max_iters: int,
                         sweeps: int, delta: float) -> LocalResult:
    """Near/far bucketed fixpoint. Each step, every running row relaxes
    from its near bucket, ``frontier & (dist <= lo + delta)`` with ``lo``
    the row's least frontier distance (never empty: the nearest vertex is
    in it); the far vertices stay in the frontier with those the step
    improved. A row stops once its frontier is empty or its ``max_iters``
    steps are spent, as the reference's lane does."""
    w = torch.where(pruned_loc, INF, sh.loc_w)
    it = torch.zeros(active.shape[:2], dtype=torch.int32, device=dist.device)
    nrel = torch.zeros_like(it)
    frontier = active
    while True:
        run = frontier.any(-1) & (it < max_iters)          # [P, K]
        if not bool(run.any()):
            break
        lo = torch.where(frontier, dist, INF).amin(-1, keepdim=True)
        near = frontier & (dist <= lo + delta) & run[..., None]
        dist, improved, n = _sweep(dist, near, sh.loc_src, sh.loc_dst, w)
        frontier = (frontier & ~near) | improved
        nrel += n
        it += run.to(torch.int32)
    return LocalResult(dist=dist, relaxations=nrel)


@phases.register("local_solver", "pallas")
def local_fixpoint_pallas(dist, active, sh, pruned_loc, *, max_iters: int,
                          sweeps: int, delta: float) -> LocalResult:
    """Fused kernel fixpoint over the dst-tiled layout ``sh.rx_*``: up to
    ``sweeps`` sweeps per launch, relaunched while any shard has a residual
    frontier and sweeps left of its ``max_iters`` (``relax_to_fixpoint``).
    A ragged layout (a 5-tuple, with the chunk->tile map) takes the ragged
    kernel; a dense one takes kernel 1 over its live chunks
    (``sh.relax_chunks``, derived once per shards object)."""
    block = dist.shape[-1]
    lay = sh.relax_layout
    if len(lay) == 5:                     # ragged: + chunk->tile map
        block_pad = -(-block // sh.rx_vb) * sh.rx_vb
    else:
        block_pad = lay[0].shape[1] * sh.rx_vb
    d, front, pruned_t = fixpoint_operands(dist, active, pruned_loc, lay[3],
                                           block_pad)
    d, nrel = relax_to_fixpoint(d, front, lay, pruned_t, vb=sh.rx_vb,
                                n_sweeps=sweeps, max_iters=max_iters,
                                chunks=sh.relax_chunks)
    return LocalResult(dist=d[..., :block], relaxations=nrel)
