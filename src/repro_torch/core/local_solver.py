"""Intra-partition solver: the paper's "Dijkstra within each node" as
iterated frontier-masked relaxation to a local fixpoint.

Port of the reference's ``core/local_solver.py`` (``bellman``, ``delta``
and ``pallas``).

- ``bellman``: each step relaxes the local edges whose source improved in
  the previous step (gather + scatter-min), until no row has a frontier.
- ``delta``: bellman's steps restricted to each row's near bucket, the
  frontier vertices within ``delta`` of the row's nearest one; the rest
  wait in the frontier for a later step (Dijkstra-order settling without
  a heap).
- ``pallas``: the dst-tiled relax kernel (dense or ragged, by the layout)
  run as a fused multi-sweep fixpoint (``kernels/relax``), re-invoked from
  a host loop on the residual frontier until the frontier is empty. It
  needs the dst-tiled layout of ``build_shards``; without one it falls
  back to ``bellman`` with a one-time warning.

The public functions take the reference's per-shard arguments: ONE shard's
arrays, dist/active ``[block]`` (``local_fixpoint*``) or ``[K, block]``
(``*_batch``). The registry entries (``_batch_bellman``, ``_batch_delta``,
``_batch_pallas``) take the ``sim`` backend's stacked state instead:
dist/active ``[P, K, block]``, the edge arrays and the Trishla mask
``[P, e_loc]``, the layout ``[P, ...]``. Each (shard, query) row iterates
on its own, as the reference's vmapped ``while_loop`` lanes do; the public
functions run them on a one-shard stack.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import phases
from repro_torch.kernels.common import INF, scatter_min_drop, take_fill
from repro_torch.kernels.relax import fixpoint_operands, relax_to_fixpoint


class LocalResult(NamedTuple):
    dist: torch.Tensor         # [block], [K, block] or [P, K, block] f32
    changed: torch.Tensor      # bool per row: any local improvement happened
    relaxations: torch.Tensor  # int32 per row: edge relaxations performed


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


def _frontier_loop(dist, active, loc_src, loc_dst, w, max_iters: int,
                   delta: float | None):
    """The bellman (``delta`` None) or delta fixpoint over stacked rows. A
    row stops once its frontier is empty or its ``max_iters`` steps are
    spent, keeping that frontier, as the reference's lane does. Under
    delta each running row relaxes from its near bucket, ``frontier &
    (dist <= lo + delta)`` with ``lo`` the row's least frontier distance
    (never empty: the nearest vertex is in it); the far vertices stay in
    the frontier with those the step improved."""
    it = torch.zeros(active.shape[:2], dtype=torch.int32, device=dist.device)
    nrel = torch.zeros_like(it)
    changed = torch.zeros(active.shape[:2], dtype=torch.bool,
                          device=dist.device)
    frontier = active
    while True:
        run = frontier.any(-1) & (it < max_iters)          # [P, K]
        if not bool(run.any()):
            break
        src = frontier & run[..., None]
        if delta is not None:
            lo = torch.where(frontier, dist, INF).amin(-1, keepdim=True)
            src = src & (dist <= lo + delta)
        dist, improved, n = _sweep(dist, src, loc_src, loc_dst, w)
        if delta is None:
            frontier = torch.where(run[..., None], improved, frontier)
        else:
            frontier = (frontier & ~src) | improved
        changed |= improved.any(-1)
        nrel += n
        it += run.to(torch.int32)
    return LocalResult(dist=dist, changed=changed, relaxations=nrel)


# ---- local-solver registry (phase "local_solver") ------------------------
# The reference's uniform batched signature, on the stacked state, so the
# round resolves the backend by name and SsspConfig validates it eagerly;
# every entry returns LocalResult with dist [P, K, block], changed [P, K],
# relaxations [P, K]. ``pallas_interpret`` is the reference's keyword,
# accepted and ignored; ``chunks`` is the dense layout's live chunks
# (``SsspShards.relax_chunks``), which kernel 1 walks.

@phases.register("local_solver", "bellman")
def _batch_bellman(dist, active, loc_src, loc_dst, loc_w, pruned_loc, *,
                   max_iters, delta, relax_layout, relax_vb, pallas_sweeps,
                   pallas_interpret=True, chunks=None) -> LocalResult:
    w = torch.where(pruned_loc, INF, loc_w)
    return _frontier_loop(dist, active, loc_src, loc_dst, w, max_iters, None)


@phases.register("local_solver", "delta")
def _batch_delta(dist, active, loc_src, loc_dst, loc_w, pruned_loc, *,
                 max_iters, delta, relax_layout, relax_vb, pallas_sweeps,
                 pallas_interpret=True, chunks=None) -> LocalResult:
    w = torch.where(pruned_loc, INF, loc_w)
    return _frontier_loop(dist, active, loc_src, loc_dst, w, max_iters,
                          delta)


@phases.register("local_solver", "pallas")
def _batch_pallas(dist, active, loc_src, loc_dst, loc_w, pruned_loc, *,
                  max_iters, delta, relax_layout, relax_vb, pallas_sweeps,
                  pallas_interpret=True, chunks=None) -> LocalResult:
    """Fused kernel fixpoint over the stacked dst-tiled layout: up to
    ``pallas_sweeps`` sweeps per launch, relaunched while any shard has a
    residual frontier and sweeps left of its ``max_iters``
    (``relax_to_fixpoint``). A ragged layout (a 5-tuple, with the
    chunk->tile map) takes kernel 2; a dense one kernel 1 over ``chunks``
    (found on the card when None)."""
    block = dist.shape[-1]
    if len(relax_layout) == 5:            # ragged: + chunk->tile map
        block_pad = max(-(-block // relax_vb), 1) * relax_vb
    else:
        block_pad = relax_layout[0].shape[1] * relax_vb
    d, front, pruned_t = fixpoint_operands(dist, active, pruned_loc,
                                           relax_layout[3], block_pad)
    d, nrel = relax_to_fixpoint(d, front, relax_layout, pruned_t,
                                vb=relax_vb, n_sweeps=pallas_sweeps,
                                max_iters=max_iters, chunks=chunks)
    new_dist = d[..., :block]
    return LocalResult(dist=new_dist, changed=(new_dist < dist).any(-1),
                       relaxations=nrel)


def solve_stacked(dist, active, loc_src, loc_dst, loc_w, pruned_loc, *,
                  solver: str, max_iters: int, delta: float, relax_layout,
                  relax_vb: int, pallas_sweeps: int, chunks=None
                  ) -> LocalResult:
    """Resolve ``solver`` and run it on the stacked state. ``pallas``
    without a dst-tiled layout (``relax_layout`` None: shards built with
    ``relax_layout=False``) warns once and runs ``bellman``, as the
    reference does."""
    if solver == "pallas" and relax_layout is None:
        phases.warn_once(
            "local_solver.pallas.no_layout",
            "local_solver='pallas' falling back to 'bellman': the shards "
            "carry no dst-tiled edge layout (build_shards was called with "
            "relax_layout=False)")
        solver = "bellman"
    impl = phases.resolve("local_solver", solver)
    return impl(dist, active, loc_src, loc_dst, loc_w, pruned_loc,
                max_iters=max_iters, delta=delta, relax_layout=relax_layout,
                relax_vb=relax_vb, pallas_sweeps=pallas_sweeps,
                chunks=chunks)


# ---- the reference's per-shard entry points ---------------------------------

def _row(res: LocalResult) -> LocalResult:
    """The one row of a [1, 1, ...] result."""
    return LocalResult(*(t[0, 0] for t in res))


def local_fixpoint_bellman(dist, active, loc_src, loc_dst, loc_w, pruned_loc,
                           max_iters: int) -> LocalResult:
    """Relax frontier edges until no local change (the local 'Dijkstra').
    dist/active [block]; returns dist [block], changed and relaxations as
    0-d tensors."""
    return _row(_batch_bellman(
        dist[None, None], active[None, None], loc_src[None], loc_dst[None],
        loc_w[None], pruned_loc[None], max_iters=max_iters, delta=None,
        relax_layout=None, relax_vb=None, pallas_sweeps=None))


def local_fixpoint_delta(dist, active, loc_src, loc_dst, loc_w, pruned_loc,
                         max_iters: int, delta: float) -> LocalResult:
    """Near/far bucketed fixpoint: Dijkstra-order settling without a heap.
    Shapes as ``local_fixpoint_bellman``."""
    return _row(_batch_delta(
        dist[None, None], active[None, None], loc_src[None], loc_dst[None],
        loc_w[None], pruned_loc[None], max_iters=max_iters, delta=delta,
        relax_layout=None, relax_vb=None, pallas_sweeps=None))


def local_fixpoint_pallas(dist, active, pruned_loc, relax_layout, *,
                          vb: int, max_iters: int, sweeps: int = 8,
                          interpret: bool = True) -> LocalResult:
    """Fused kernel fixpoint over one shard's dst-tiled layout
    ``relax_layout`` = (src_t, w_t, dstrel_t, eid_t), each [n_vtiles,
    n_chunks, EB], or the ragged 5-tuple: a K=1 batch of
    ``local_fixpoint_pallas_batch``. ``interpret`` is the reference's
    keyword, accepted and ignored."""
    res = local_fixpoint_pallas_batch(dist[None], active[None], pruned_loc,
                                      relax_layout, vb=vb,
                                      max_iters=max_iters, sweeps=sweeps,
                                      interpret=interpret)
    return LocalResult(*(t[0] for t in res))


def local_fixpoint_pallas_batch(dist, active, pruned_loc, relax_layout, *,
                                vb: int, max_iters: int, sweeps: int = 8,
                                interpret: bool = True) -> LocalResult:
    """Batched kernel fixpoint: dist/active [K, block] share one shard's
    layout and Trishla mask ``pruned_loc`` [e_loc]. A 5-tuple
    ``relax_layout`` is the ragged form (flat chunk rows + chunk->tile map)
    and launches kernel 2, a 4-tuple kernel 1 (on CUDA tensors; their plain
    versions on CPU tensors). Returns dist [K, block], changed [K],
    relaxations [K]. ``interpret`` is accepted and ignored."""
    res = _batch_pallas(dist[None], active[None], None, None, None,
                        pruned_loc[None], max_iters=max_iters, delta=None,
                        relax_layout=tuple(a[None] for a in relax_layout),
                        relax_vb=vb, pallas_sweeps=sweeps)
    return LocalResult(*(t[0] for t in res))


def local_fixpoint_batch(dist, active, loc_src, loc_dst, loc_w, pruned_loc, *,
                         solver: str = "bellman", max_iters: int = 10_000,
                         delta: float = 4.0, relax_layout=None,
                         relax_vb: int = 128, pallas_sweeps: int = 8,
                         pallas_interpret: bool = True) -> LocalResult:
    """Multi-query local solve of one shard: dist/active carry a leading
    [K] query axis; the edge arrays, the pruned mask and the layout are the
    shard's (query-invariant). Returns LocalResult with dist [K, block],
    changed [K], relaxations [K]. ``pallas_interpret`` is accepted and
    ignored."""
    res = solve_stacked(
        dist[None], active[None], loc_src[None], loc_dst[None], loc_w[None],
        pruned_loc[None], solver=solver, max_iters=max_iters, delta=delta,
        relax_layout=(None if relax_layout is None
                      else tuple(a[None] for a in relax_layout)),
        relax_vb=relax_vb, pallas_sweeps=pallas_sweeps)
    return LocalResult(*(t[0] for t in res))


def local_fixpoint(dist, active, loc_src, loc_dst, loc_w, pruned_loc, *,
                   solver: str = "bellman", max_iters: int = 10_000,
                   delta: float = 4.0, relax_layout=None, relax_vb: int = 128,
                   pallas_sweeps: int = 8,
                   pallas_interpret: bool = True) -> LocalResult:
    """Single-query local solve: a K=1 batch (the batched entry point owns
    the solver dispatch and the pallas-layout fallback rule)."""
    res = local_fixpoint_batch(
        dist[None], active[None], loc_src, loc_dst, loc_w, pruned_loc,
        solver=solver, max_iters=max_iters, delta=delta,
        relax_layout=relax_layout, relax_vb=relax_vb,
        pallas_sweeps=pallas_sweeps, pallas_interpret=pallas_interpret)
    return LocalResult(*(t[0] for t in res))
