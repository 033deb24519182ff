"""Host-side dst-tiled layout builders (dense and ragged), the standalone
kernel API of the single-query relax kernels, the operand padding of the
batched relax kernels and their relaunch loop (the reference's
``kernels/relax/ops.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import pad_last, take_fill
from repro_torch.kernels.relax.ref import relax_ref
from repro_torch.kernels.relax.relax import (relax_dst_ragged_fixpoint_batch,
                                            relax_dst_tiled,
                                            relax_dst_tiled_fixpoint,
                                            relax_dst_tiled_fixpoint_batch,
                                            relax_dst_tiled_masked)


def _by_dst_tile(src, dst, w, n_vertices: int, vb: int):
    """The finite-weight edges, stably sorted by dst, with each one's
    position in the original list. Returns (src, dst, w, eid, n_edges,
    n_vtiles, block_pad, per-tile counts, per-tile starts)."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    n_edges = len(src)
    eid = np.arange(n_edges, dtype=np.int64)
    keep = np.isfinite(w)
    src, dst, w, eid = src[keep], dst[keep], w[keep], eid[keep]
    n_vtiles = max(-(-n_vertices // vb), 1)
    order = np.argsort(dst, kind="stable")
    src, dst, w, eid = src[order], dst[order], w[order], eid[order]
    counts = np.bincount(dst // vb, minlength=n_vtiles)
    starts = np.zeros(n_vtiles + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    return src, dst, w, eid, n_edges, n_vtiles, n_vtiles * vb, counts, starts


def _i32(a):
    return torch.from_numpy(a.astype(np.int32))


def build_dst_tiled_layout(src, dst, w, n_vertices: int, *, vb: int = 128,
                           eb: int = 512, with_eid: bool = False):
    """One-time host preprocessing: edges -> [n_vtiles, n_chunks, EB].

    Padding entries use src = block_pad - 1 (the gather stays in range; the
    padded distance slot is +inf) and w = +inf so they never win the min.
    Returns (src_t, w_t, dstrel_t, block_pad) as int32/float32 torch
    tensors and an int. With ``with_eid=True`` it returns (src_t, w_t,
    dstrel_t, eid_t, block_pad): eid_t is each tiled slot's position in the
    ORIGINAL edge list (sentinel = len(src) for padding), so runtime
    per-edge state (the Trishla mask) gathers into tiled order."""
    (src, dst, w, eid, n_edges, n_vtiles, block_pad, counts,
     starts) = _by_dst_tile(src, dst, w, n_vertices, vb)
    n_chunks = max(int(-(-counts.max() // eb)) if counts.size else 1, 1)

    src_t = np.full((n_vtiles, n_chunks * eb), block_pad - 1, np.int64)
    w_t = np.full((n_vtiles, n_chunks * eb), np.inf, np.float32)
    dstrel_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    eid_t = np.full((n_vtiles, n_chunks * eb), n_edges, np.int64)
    for t in range(n_vtiles):
        lo, hi = starts[t], starts[t + 1]
        k = hi - lo
        src_t[t, :k] = src[lo:hi]
        w_t[t, :k] = w[lo:hi]
        dstrel_t[t, :k] = dst[lo:hi] - t * vb
        eid_t[t, :k] = eid[lo:hi]

    shape3 = (n_vtiles, n_chunks, eb)
    out = (_i32(src_t.reshape(shape3)), torch.from_numpy(w_t.reshape(shape3)),
           _i32(dstrel_t.reshape(shape3)))
    if with_eid:
        out += (_i32(eid_t.reshape(shape3)),)
    return out + (block_pad,)


def build_dst_ragged_layout(src, dst, w, n_vertices: int, *, vb: int = 128,
                            eb: int = 512, with_eid: bool = False):
    """CSR-chunked (ragged) dst layout: edges -> [total_chunks, EB] rows
    plus the [total_chunks] chunk->tile map ``ctile``.

    The same stable dst-sort and per-tile EB split as the dense builder, so
    chunk contents are identical; only the padding chunks of under-full
    tiles are dropped: ``total_chunks = sum_t ceil(count_t / EB)`` (at
    least 1; an all-padding chunk carries the sentinel tile ``n_vtiles``).
    ``ctile`` is non-decreasing, so each tile owns a contiguous chunk range.
    Padding inside a partly filled chunk mirrors the dense builder. Returns
    (src_r, w_r, dstrel_r[, eid_r], ctile, block_pad), eid_r with
    ``with_eid=True``."""
    (src, dst, w, eid, n_edges, n_vtiles, block_pad, counts,
     starts) = _by_dst_tile(src, dst, w, n_vertices, vb)
    total_chunks = max(int((-(-counts // eb)).sum()), 1)

    src_r = np.full((total_chunks, eb), block_pad - 1, np.int64)
    w_r = np.full((total_chunks, eb), np.inf, np.float32)
    dstrel_r = np.zeros((total_chunks, eb), np.int64)
    eid_r = np.full((total_chunks, eb), n_edges, np.int64)
    ctile = np.full(total_chunks, n_vtiles, np.int64)
    row = 0
    for t in range(n_vtiles):
        lo, hi = starts[t], starts[t + 1]
        for off in range(lo, hi, eb):
            k = min(eb, hi - off)
            src_r[row, :k] = src[off:off + k]
            w_r[row, :k] = w[off:off + k]
            dstrel_r[row, :k] = dst[off:off + k] - t * vb
            eid_r[row, :k] = eid[off:off + k]
            ctile[row] = t
            row += 1
    out = (_i32(src_r), torch.from_numpy(w_r), _i32(dstrel_r))
    if with_eid:
        out += (_i32(eid_r),)
    return out + (_i32(ctile), block_pad)


def _check_eb(src_t, eb: int):
    if src_t.shape[-1] != eb:
        raise ValueError(f"layout chunks hold {src_t.shape[-1]} edges, "
                         f"eb={eb}")


def relax_pallas(dist_pad, src_t, w_t, dstrel_t, *, vb: int = 128,
                 eb: int = 512, interpret: bool = True, chunks=None):
    """One unmasked Jacobi sweep (kernel 11) over the layout of
    ``build_dst_tiled_layout``: dist_pad [block_pad] f32 -> [block_pad].
    ``interpret`` is the reference's keyword, accepted and ignored;
    ``chunks``, the layout's ``live_chunks(w_t[None] < inf)``, spares the
    card's launch its pre-pass (``relax_dst_tiled``)."""
    _check_eb(src_t, eb)
    return relax_dst_tiled(dist_pad, src_t, w_t, dstrel_t, vb=vb,
                           chunks=chunks)


def relax_masked_pallas(dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t,
                        *, vb: int = 128, eb: int = 512,
                        interpret: bool = True, chunks=None):
    """One frontier-masked sweep (kernel 10). Returns (new_dist, n_relax
    scalar). ``chunks`` as ``relax_pallas``'s."""
    _check_eb(src_t, eb)
    new, nrel = relax_dst_tiled_masked(dist_pad, front_pad, src_t, w_t,
                                       dstrel_t, pruned_t, vb=vb,
                                       chunks=chunks)
    return new, nrel[0]


def relax_fixpoint_pallas(dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t,
                          *, vb: int = 128, eb: int = 512, n_sweeps: int = 8,
                          interpret: bool = True):
    """Fused multi-sweep solve (kernel 9). Returns (new_dist,
    residual_frontier, n_relax scalar)."""
    _check_eb(src_t, eb)
    new, resid, nrel = relax_dst_tiled_fixpoint(
        dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t, vb=vb,
        n_sweeps=n_sweeps)
    return new, resid, nrel[0]


def relax_fixpoint_batch_pallas(dist_pad, front_pad, src_t, w_t, dstrel_t,
                                pruned_t, *, vb: int = 128, eb: int = 512,
                                n_sweeps: int = 8, interpret: bool = True):
    """Batched fused solve of one shard (kernel 1 on CUDA tensors):
    dist_pad/front_pad [K, block_pad] share the dense layout
    [n_vtiles, n_chunks, EB]. Returns (new_dist [K, block_pad], residual
    frontier [K, block_pad], n_relax [K]). A one-shard stack of
    ``relax_dst_tiled_fixpoint_batch``; ``interpret`` is accepted and
    ignored."""
    _check_eb(src_t, eb)
    out = relax_dst_tiled_fixpoint_batch(
        dist_pad[None], front_pad[None], src_t[None], w_t[None],
        dstrel_t[None], pruned_t[None], vb=vb, n_sweeps=n_sweeps)
    return tuple(t[0] for t in out)


def relax_fixpoint_batch_ragged_pallas(dist_pad, front_pad, ctile, src_r, w_r,
                                       dstrel_r, pruned_r, *, vb: int = 128,
                                       eb: int = 512, n_sweeps: int = 8,
                                       interpret: bool = True):
    """The same over one shard's ragged layout (flat [total_chunks, EB]
    rows and the chunk->tile map ``ctile``): kernel 2 on CUDA tensors."""
    _check_eb(src_r, eb)
    out = relax_dst_ragged_fixpoint_batch(
        dist_pad[None], front_pad[None], ctile[None], src_r[None], w_r[None],
        dstrel_r[None], pruned_r[None], vb=vb, n_sweeps=n_sweeps)
    return tuple(t[0] for t in out)


def relax_jnp(dist, src, dst, w):
    """The flat-edge relaxation as plain tensor ops (a gather and a
    scatter-min), the reference's XLA path; the same function as
    ``relax_ref``."""
    return relax_ref(dist, src, dst, w)


def fixpoint_operands(dist, active, pruned_loc, eid_t, block_pad: int):
    """Rows and mask in the kernel's form: dist/active [P, K, block] padded
    to ``block_pad`` (+inf / 0), and the runtime Trishla mask ``pruned_loc``
    [P, e_loc] gathered into tiled edge order through ``eid_t`` (padding
    sentinel -> 0 = not pruned, so padding stays inert). ``eid_t`` is a
    dense [P, n_vtiles, n_chunks, EB] or ragged [P, total_chunks, EB]
    layout plane."""
    dist_pad = pad_last(dist, block_pad, float("inf"))
    front_pad = pad_last(active.float(), block_pad, 0.0)
    P = eid_t.shape[0]
    pruned_t = take_fill(pruned_loc.to(torch.int32), eid_t.reshape(P, -1),
                         0).reshape(eid_t.shape)
    return dist_pad, front_pad, pruned_t


def relax_to_fixpoint(dist, front, relax_layout, pruned_t, *, vb: int,
                      n_sweeps: int, max_iters: int, spent: int = 0,
                      chunks=None):
    """Relaunch the relax kernel (dense, or ragged for a 5-tuple layout
    with its chunk->tile map) on the residual frontier, up to ``n_sweeps``
    sweeps a launch, until every shard's frontier is empty or the shard has
    run ``max_iters`` sweeps, ``spent`` of them before the first launch
    (the reference's per-shard loop condition). A stopped shard gets an
    empty frontier in later launches, which makes its rows no-ops.
    ``chunks``: the dense layout's live chunks, passed to kernel 1
    (``relax_dst_tiled_fixpoint_batch``); ignored for a ragged layout.
    dist/front [P, K, block_pad]. Returns (dist, relaxations [P, K])."""
    src_t, w_t, dstrel_t = relax_layout[:3]
    if len(relax_layout) == 5:
        relax, lead, kw = (relax_dst_ragged_fixpoint_batch,
                           relax_layout[4:], {})
    else:
        relax, lead, kw = relax_dst_tiled_fixpoint_batch, (), {"chunks": chunks}
    P, K = dist.shape[:2]
    nrel = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    it = torch.full((P,), spent, dtype=torch.int32, device=dist.device)
    while True:
        run = (front > 0).flatten(1).any(-1) & (it < max_iters)   # [P]
        if not bool(run.any()):
            break
        dist, resid, n = relax(
            dist, front * run[:, None, None], *lead, src_t, w_t, dstrel_t,
            pruned_t, vb=vb, n_sweeps=n_sweeps, **kw)
        front = torch.where(run[:, None, None], resid, front)
        nrel += n
        it += n_sweeps * run.to(torch.int32)
    return dist, nrel
