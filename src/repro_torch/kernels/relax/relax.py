"""The relax family: the K-query local fixpoint over the dst-tiled local
edges (dense and ragged) and the single-query kernels of the standalone
kernel API.

Port of the reference's ``kernels/relax/relax.py:
relax_dst_tiled_fixpoint_batch`` and ``relax_dst_ragged_fixpoint_batch``
(kernels 1 and 2), and of ``relax_dst_tiled_fixpoint`` (kernel 9),
``relax_dst_tiled_masked`` (10) and ``relax_dst_tiled`` (11). Each wrapper
runs the CUDA kernel (``csrc/relax.cu``) on CUDA tensors and its plain
PyTorch version on CPU tensors; the ``*_plain`` functions are the plain
versions, callable on either device.

Shapes of kernels 1 and 2 carry the ``sim`` backend's leading shard axis:
rows are ``[P, K, block_pad]``; the dense layout is ``[P, n_vtiles,
n_chunks, EB]``, the ragged one ``[P, total_chunks, EB]`` with the
chunk->tile map ``ctile`` ``[P, total_chunks]``. Kernels 9-11 take one row
``[block_pad]`` and one dense layout ``[n_vtiles, n_chunks, EB]``, as the
reference does; their kernels order candidates by an order-preserving key
(``csrc/tile_reduce.cuh: min_key``), so they take any non-NaN distances,
negative ones included; kernels 10 and 11 (one cooperative launch over the
layout's live chunks) also give the plain version's NaN wherever it adds
-inf and +inf. Every kernel reads the layout as the builders make
it (sources in ``[0, block_pad)``, ``dstrel`` in ``[0, vb)``): the
wrappers check shapes and dtypes, not index values. Kernels 1, 2 and 9 run
the Hopper chain of ``csrc/sweeps_ragged.cuh`` (1 and 9 over the dense
layout's live chunks), which takes VB a multiple of 32, EB of 4 and 16-byte
aligned operands (``check_chain``) and has a cap on a row's vertex tiles
(``ragged_scratch``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (INF, check_chain, check_cuda,
                                        ragged_scratch, same_card)
from repro_torch.kernels.tile_reduce import tile_min_batch


def _relax_chunk(out, fcur, active, count, src_c, w_c, dstrel_c, pruned_c,
                 tile_idx, *, vb: int):
    """One Gauss–Seidel chunk step of every (shard, query) row, in place:
    gather the frontier candidates of chunk ``src_c`` etc. ([P, EB]) from
    the live rows, count them, and min them into the vertex tiles whose
    lanes ``tile_idx`` [P, vb] name (the rows of inactive queries stay)."""
    P, K, _ = out.shape
    src = src_c.long()[:, None, :].expand(P, K, -1)
    w = torch.where(pruned_c > 0, INF, w_c)[:, None, :]
    f_src = torch.gather(fcur, -1, src) > 0
    d_src = torch.gather(out, -1, src)            # live row: Gauss–Seidel
    cand = torch.where(f_src, d_src + w, INF)
    n = (f_src & (w < INF)).sum(-1, dtype=torch.int32)
    count += torch.where(active, n, 0)
    mins = tile_min_batch(cand, dstrel_c[:, None, :], width=vb)
    idx = tile_idx[:, None, :].expand(P, K, vb)
    cur = torch.gather(out, -1, idx)
    out.scatter_(-1, idx, torch.where(active[..., None],
                                      torch.minimum(cur, mins), cur))


def _fixpoint_plain(dist, front, chunks, *, vb: int, n_sweeps: int):
    """Up to ``n_sweeps`` frontier-chased sweeps over the chunk sequence
    ``chunks()`` (yields the ``_relax_chunk`` operands), with the per-row
    early-out at each sweep start. Returns (dist, residual frontier f32
    0/1, relaxations [P, K] int32)."""
    P, K, _ = dist.shape
    out = dist.clone()
    prev = dist.clone()
    fcur = front.clone()
    active = (front > 0).any(-1)                           # [P, K]
    count = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    for s in range(n_sweeps):
        if s > 0:
            live = active[..., None]
            newf = (out < prev).float()
            fcur = torch.where(live, newf, fcur)
            prev = torch.where(live, out, prev)
            active = active & (newf > 0).any(-1)
        if not bool(active.any()):
            break          # every row is done: later sweeps are no-ops
        for chunk in chunks():
            _relax_chunk(out, fcur, active, count, *chunk, vb=vb)
    return out, (out < prev).float(), count


def relax_dst_tiled_fixpoint_batch_plain(dist, front, src_t, w_t, dstrel_t,
                                         pruned_t, *, vb: int, n_sweeps: int):
    """Transliteration of the Pallas kernel's grid (sweep, vtile, chunk,
    query), the query axis vectorized: per (shard, query) row, up to
    ``n_sweeps`` frontier-chased Gauss–Seidel sweeps with a per-row
    early-out. Returns (dist [P, K, bp], residual frontier [P, K, bp] f32
    0/1, relaxations [P, K] int32)."""
    P = dist.shape[0]
    _, n_vtiles, n_chunks, _ = src_t.shape
    lanes = torch.arange(vb, device=dist.device)

    def chunks():
        for i in range(n_vtiles):
            idx = (i * vb + lanes).expand(P, vb)
            for j in range(n_chunks):
                yield (src_t[:, i, j], w_t[:, i, j], dstrel_t[:, i, j],
                       pruned_t[:, i, j], idx)
    return _fixpoint_plain(dist, front, chunks, vb=vb, n_sweeps=n_sweeps)


def relax_dst_ragged_fixpoint_batch_plain(dist, front, ctile, src_r, w_r,
                                          dstrel_r, pruned_r, *, vb: int,
                                          n_sweeps: int):
    """Transliteration of the Pallas ragged grid (sweep, chunk, query), the
    query axis vectorized: the same sweeps over each shard's flat chunk
    rows, chunk c landing in tile ``min(ctile[p, c], n_vtiles - 1)`` (a
    padding chunk is all +inf, so its step is a no-op). Same returns."""
    bp = dist.shape[-1]
    total_chunks = src_r.shape[1]
    tiles = ctile.long().clamp(max=bp // vb - 1)           # [P, total_chunks]
    lanes = torch.arange(vb, device=dist.device)

    def chunks():
        for c in range(total_chunks):
            yield (src_r[:, c], w_r[:, c], dstrel_r[:, c], pruned_r[:, c],
                   tiles[:, c, None] * vb + lanes)
    return _fixpoint_plain(dist, front, chunks, vb=vb, n_sweeps=n_sweeps)


def relax_dst_tiled_fixpoint_plain(dist_pad, front_pad, src_t, w_t,
                                   dstrel_t, pruned_t, *, vb: int,
                                   n_sweeps: int):
    """Kernel 9's plain version: the Pallas grid (sweep, vtile, chunk) for
    one row, i.e. kernel 1's chunk steps in grid order with P = K = 1.
    Returns (dist [bp], residual frontier [bp] f32 0/1, relaxations [1]
    int32)."""
    out, resid, nrel = relax_dst_tiled_fixpoint_batch_plain(
        dist_pad[None, None], front_pad[None, None], src_t[None], w_t[None],
        dstrel_t[None], pruned_t[None], vb=vb, n_sweeps=n_sweeps)
    return out[0, 0], resid[0, 0], nrel[0]


def _sweep_plain(dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t, *,
                 vb: int):
    """One Jacobi sweep (every gather reads the input ``dist_pad``), chunk
    index by chunk index, each step over all vertex tiles at once; masked
    and counted when ``front_pad`` is given. Returns (dist [bp], count [1]
    int32)."""
    n_vtiles, n_chunks, _ = src_t.shape
    out = dist_pad.reshape(n_vtiles, vb)
    count = torch.zeros(1, dtype=torch.int32, device=dist_pad.device)
    for j in range(n_chunks):
        src = src_t[:, j].long()                           # [n_vtiles, EB]
        d_src = dist_pad[src]
        if front_pad is None:
            cand = d_src + w_t[:, j]
        else:
            w = torch.where(pruned_t[:, j] > 0, INF, w_t[:, j])
            f_src = front_pad[src] > 0
            cand = torch.where(f_src, d_src + w, INF)
            count += (f_src & (w < INF)).sum(dtype=torch.int32)
        out = torch.minimum(out, tile_min_batch(cand, dstrel_t[:, j],
                                                width=vb))
    return out.reshape(-1), count


def relax_dst_tiled_masked_plain(dist_pad, front_pad, src_t, w_t, dstrel_t,
                                 pruned_t, *, vb: int):
    """Kernel 10's plain version: one frontier-masked, Trishla-pruned Jacobi
    sweep with relaxation counting. Returns (dist [bp], relaxations [1]
    int32)."""
    return _sweep_plain(dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t,
                        vb=vb)


def relax_dst_tiled_plain(dist_pad, src_t, w_t, dstrel_t, *, vb: int):
    """Kernel 11's plain version: one unmasked Jacobi min-plus sweep.
    Returns dist [bp]."""
    return _sweep_plain(dist_pad, None, src_t, w_t, dstrel_t, None, vb=vb)[0]


_SIGNATURES = {"relax_fixpoint_batch": build.signature(13, 9),
               "relax_ragged_fixpoint_batch": build.signature(11, 9),
               "relax_ragged_scratch_bytes": [ctypes.c_int] * 4,
               "relax_fixpoint": build.signature(11, 7),
               "relax_masked": build.signature(11, 4),
               "relax_sweep": build.signature(8, 4),
               "relax_sweep_scratch_words": [ctypes.c_int] * 6}


def _outputs(dist):
    """out, resid and nrel of kernels 1 and 2."""
    P, K, _ = dist.shape
    return (torch.empty_like(dist), torch.empty_like(dist),
            torch.empty((P, K), dtype=torch.int32, device=dist.device))


def relax_dst_tiled_fixpoint_batch(dist, front, src_t, w_t, dstrel_t,
                                   pruned_t, *, vb: int, n_sweeps: int,
                                   chunks=None):
    """Same contract as the plain version. CPU tensors take the plain
    version and ignore ``chunks``; CUDA tensors launch the kernel (one
    block per (shard, query) on the chain of ``csrc/sweeps_ragged.cuh``
    over the layout's live chunks). ``chunks``: those chunks, the (idx,
    bounds) pair of ``live_chunks(w_t < inf)``, as the shards derive it
    once (``SsspShards.round_chunks[1]``); without it the entry point
    finds them on the card first."""
    if not dist.is_cuda:
        return relax_dst_tiled_fixpoint_batch_plain(
            dist, front, src_t, w_t, dstrel_t, pruned_t, vb=vb,
            n_sweeps=n_sweeps)
    return _launch_tiled(dist, front, src_t, w_t, dstrel_t, pruned_t, vb=vb,
                         n_sweeps=n_sweeps, chunks=chunks)


def _launch_tiled(dist, front, src_t, w_t, dstrel_t, pruned_t, *, vb: int,
                  n_sweeps: int, chunks=None, hazard: bool = True):
    """Kernel 1's launch: the live-chunk pre-pass where ``chunks`` is None,
    then the chain, on the current stream. ``hazard=False`` is a planted
    fault for the checks alone (every source read from its early gather),
    which must differ from the plain version."""
    dev = same_card("relax", dist, front, src_t, w_t, dstrel_t, pruned_t,
                    chunks)
    P, K, bp = dist.shape
    _, n_vtiles, n_chunks, eb = src_t.shape
    if bp != n_vtiles * vb or front.shape != dist.shape:
        raise ValueError(f"relax: rows {tuple(dist.shape)} do not match "
                         f"{n_vtiles} tiles of {vb}")
    check_cuda("relax", torch.float32, dist, front, w_t)
    check_cuda("relax", torch.int32, src_t, dstrel_t, pruned_t)
    live = None
    if chunks is None:
        # the pre-pass's chunk flags, live lists and their lengths
        live = torch.empty(2 * P * n_vtiles * n_chunks + P,
                           dtype=torch.int32, device=dist.device)
        chunks = (None, None)
    else:
        idx, bounds = chunks
        if (idx.shape != (P, n_vtiles * n_chunks)
                or bounds.shape != (P, n_vtiles + 1)):
            raise ValueError(f"relax: live chunks {tuple(idx.shape)} / "
                             f"{tuple(bounds.shape)} do not match the layout "
                             f"{tuple(src_t.shape)}")
        check_cuda("relax", torch.int32, idx, bounds)
    check_chain("relax", eb, vb, dist, front, src_t, w_t, dstrel_t, pruned_t)
    lib = build.load("relax", _SIGNATURES)
    vstate = ragged_scratch("relax", lib, "relax_ragged_scratch_bytes", P * K,
                            (bp, n_vtiles, eb, vb), dev)
    outs = _outputs(dist)
    build.call(lib, "relax_fixpoint_batch", dev,
               *map(build.ptr_or_null, (dist, front, src_t, w_t, dstrel_t,
                                        pruned_t, *outs, *chunks, live,
                                        vstate)),
               P, K, bp, n_vtiles, n_chunks, eb, vb, n_sweeps, int(hazard),
               launch="relax")
    build.count_launch("relax")
    return outs


def relax_dst_ragged_fixpoint_batch(dist, front, ctile, src_r, w_r, dstrel_r,
                                    pruned_r, *, vb: int, n_sweeps: int):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one block per (shard, query)
    on the chain of ``csrc/sweeps_ragged.cuh``)."""
    if not dist.is_cuda:
        return relax_dst_ragged_fixpoint_batch_plain(
            dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, vb=vb,
            n_sweeps=n_sweeps)
    return _launch_ragged(dist, front, ctile, src_r, w_r, dstrel_r, pruned_r,
                          vb=vb, n_sweeps=n_sweeps)


def _launch_ragged(dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, *,
                   vb: int, n_sweeps: int, hazard: bool = True):
    """Kernel 2's launch. ``hazard=False`` is a planted fault for the
    checks alone (every source read from its early gather), which must
    differ from the plain version."""
    dev = same_card("relax_ragged", dist, front, ctile, src_r, w_r, dstrel_r,
                    pruned_r)
    P, K, bp = dist.shape
    _, total_chunks, eb = src_r.shape
    if bp % vb or front.shape != dist.shape or ctile.shape != (
            P, total_chunks):
        raise ValueError(f"relax_ragged: rows {tuple(dist.shape)} / ctile "
                         f"{tuple(ctile.shape)} do not match tiles of {vb} "
                         f"and {total_chunks} chunks")
    check_cuda("relax_ragged", torch.float32, dist, front, w_r)
    check_cuda("relax_ragged", torch.int32, ctile, src_r, dstrel_r, pruned_r)
    check_chain("relax_ragged", eb, vb, dist, front, src_r, w_r, dstrel_r,
                pruned_r)
    lib = build.load("relax", _SIGNATURES)
    outs = _outputs(dist)
    vstate = ragged_scratch("relax_ragged", lib, "relax_ragged_scratch_bytes",
                            P * K, (bp, bp // vb, eb, vb), dev)
    build.call(lib, "relax_ragged_fixpoint_batch", dev,
               *map(build.ptr, (dist, front, ctile, src_r, w_r, dstrel_r,
                                pruned_r, *outs)),
               build.ptr_or_null(vstate), P, K, bp, bp // vb, total_chunks,
               eb, vb, n_sweeps, int(hazard), launch="relax_ragged")
    build.count_launch("relax_ragged")
    return outs


def _single_operands(name, rows, planes, vb: int):
    """Raise unless ``rows`` are contiguous CUDA f32 [bp] vectors and
    ``planes`` = (src_t, w_t, dstrel_t[, pruned_t]) contiguous CUDA
    [n_vtiles, n_chunks, EB] planes (w_t f32, the others int32) with
    bp = n_vtiles * vb. Returns (n_vtiles, n_chunks, EB)."""
    shape = tuple(planes[0].shape)
    if (len(shape) != 3 or any(tuple(p.shape) != shape for p in planes)
            or any(r.shape != (shape[0] * vb,) for r in rows)):
        raise ValueError(
            f"{name}: rows {[tuple(r.shape) for r in rows]} and layout "
            f"{[tuple(p.shape) for p in planes]} do not match "
            f"[n_vtiles * {vb}] and one [n_vtiles, n_chunks, EB] shape")
    check_cuda(name, torch.float32, *rows, planes[1])
    check_cuda(name, torch.int32, planes[0], *planes[2:])
    return shape


def relax_dst_tiled_fixpoint(dist_pad, front_pad, src_t, w_t, dstrel_t,
                             pruned_t, *, vb: int, n_sweeps: int):
    """Kernel 9: same contract as the plain version. CPU tensors take the
    plain version; CUDA tensors launch the kernel (one block on the chain
    of ``csrc/sweeps_ragged.cuh`` over the layout's live chunks, which its
    entry point finds on the device first)."""
    if not dist_pad.is_cuda:
        return relax_dst_tiled_fixpoint_plain(
            dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t, vb=vb,
            n_sweeps=n_sweeps)
    return _launch_single(dist_pad, front_pad, src_t, w_t, dstrel_t,
                          pruned_t, vb=vb, n_sweeps=n_sweeps)


def _launch_single(dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t, *,
                   vb: int, n_sweeps: int, hazard: bool = True):
    """Kernel 9's launch: the live-chunk pre-pass and the chain, on the
    current stream. ``hazard=False`` is a planted fault for the checks
    alone (every source read from its early gather), which must differ from
    the plain version."""
    dev = same_card("relax_single", dist_pad, front_pad, src_t, w_t,
                    dstrel_t, pruned_t)
    n_vtiles, n_chunks, eb = _single_operands(
        "relax_single", (dist_pad, front_pad),
        (src_t, w_t, dstrel_t, pruned_t), vb)
    check_chain("relax_single", eb, vb, dist_pad, front_pad, src_t, w_t,
                dstrel_t, pruned_t)
    bp = n_vtiles * vb
    lib = build.load("relax", _SIGNATURES)
    vstate = ragged_scratch("relax_single", lib, "relax_ragged_scratch_bytes",
                            1, (bp, n_vtiles, eb, vb), dev)
    out, resid = torch.empty_like(dist_pad), torch.empty_like(dist_pad)
    nrel = torch.empty(1, dtype=torch.int32, device=dev)
    # the pre-pass's chunk flags, live list and its length
    live = torch.empty(2 * n_vtiles * n_chunks + 1, dtype=torch.int32,
                       device=dev)
    build.call(lib, "relax_fixpoint", dev,
               *map(build.ptr, (dist_pad, front_pad, src_t, w_t, dstrel_t,
                                pruned_t, out, resid, nrel, live)),
               build.ptr_or_null(vstate), bp, n_vtiles, n_chunks, eb, vb,
               n_sweeps, int(hazard), launch="relax_single")
    build.count_launch("relax_single")
    return out, resid, nrel


def relax_dst_tiled_masked(dist_pad, front_pad, src_t, w_t, dstrel_t,
                           pruned_t, *, vb: int, chunks=None):
    """Kernel 10: same contract as the plain version. CPU tensors take the
    plain version and ignore ``chunks``; CUDA tensors launch the kernel (one
    cooperative launch over the layout's live chunks, balanced by chunk:
    ``csrc/relax.cu``). ``chunks``: those chunks, the (idx, bounds) pair of
    ``live_chunks(w_t[None] < inf)``, which a caller that sweeps one layout
    many times derives once; without it the entry point finds them on the
    card first (two more launches, and the weights read in full)."""
    if not dist_pad.is_cuda:
        return relax_dst_tiled_masked_plain(
            dist_pad, front_pad, src_t, w_t, dstrel_t, pruned_t, vb=vb)
    return _launch_sweep("relax_masked", (dist_pad, front_pad),
                         (src_t, w_t, dstrel_t, pruned_t), vb, chunks)


def relax_dst_tiled(dist_pad, src_t, w_t, dstrel_t, *, vb: int, chunks=None):
    """Kernel 11: same contract as the plain version. CPU tensors take the
    plain version and ignore ``chunks``; CUDA tensors launch the kernel, as
    kernel 10's (``chunks`` likewise)."""
    if not dist_pad.is_cuda:
        return relax_dst_tiled_plain(dist_pad, src_t, w_t, dstrel_t, vb=vb)
    return _launch_sweep("relax_sweep", (dist_pad,), (src_t, w_t, dstrel_t),
                         vb, chunks)[0]


def _launch_sweep(name, rows, planes, vb: int, chunks):
    """Kernels 10 (``rows`` = (dist, front), four planes) and 11 (dist,
    three planes): the pre-pass where ``chunks`` is None, then the sweep, on
    the current stream. Returns (out, nrel) for kernel 10, (out,) for 11."""
    dev = same_card(name, *rows, *planes, *(chunks or ()))
    n_vtiles, n_chunks, eb = _single_operands(name, rows, planes, vb)
    if chunks is not None:
        idx, bounds = chunks
        if (idx.shape != (1, n_vtiles * n_chunks)
                or bounds.shape != (1, n_vtiles + 1)):
            raise ValueError(f"{name}: live chunks {tuple(idx.shape)} / "
                             f"{tuple(bounds.shape)} do not match the layout "
                             f"{tuple(planes[0].shape)}")
        check_cuda(name, torch.int32, idx, bounds)
    masked = len(rows) == 2
    lib = build.load("relax", _SIGNATURES)
    words = build.call(lib, "relax_sweep_scratch_words", dev, int(masked),
                       int(chunks is None), n_vtiles, n_chunks, eb, vb)
    if words < 0:
        raise ValueError(f"{name}: a layout of {n_vtiles} x {n_chunks} "
                         f"chunks and tiles of {vb} is past the sweep's "
                         f"scratch (int32 words) or its tile past shared "
                         f"memory")
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    outs = (torch.empty_like(rows[0]),)
    if masked:
        outs += (torch.empty(1, dtype=torch.int32, device=dev),)
    build.call(lib, name, dev,
               *map(build.ptr_or_null, (*rows, *planes,
                                        *(chunks or (None, None)), *outs,
                                        scratch)),
               n_vtiles, n_chunks, eb, vb, launch=name)
    build.count_launch(name)
    return outs
