"""K-query local fixpoint over the dst-tiled local edges.

Port of the reference's ``kernels/relax/relax.py:
relax_dst_tiled_fixpoint_batch``. ``relax_dst_tiled_fixpoint_batch`` runs
the CUDA kernel (``csrc/relax.cu``) on CUDA tensors and the plain PyTorch
version on CPU tensors; ``relax_dst_tiled_fixpoint_batch_plain`` is the
plain version, callable on either device.

Shapes carry the ``sim`` backend's leading shard axis: rows are
``[P, K, block_pad]`` and the layout ``[P, n_vtiles, n_chunks, EB]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import INF, check_cuda
from repro_torch.kernels.tile_reduce import tile_min_batch


def relax_dst_tiled_fixpoint_batch_plain(dist, front, src_t, w_t, dstrel_t,
                                         pruned_t, *, vb: int, n_sweeps: int):
    """Transliteration of the Pallas kernel's grid (sweep, vtile, chunk,
    query), the query axis vectorized: per (shard, query) row, up to
    ``n_sweeps`` frontier-chased Gauss–Seidel sweeps with a per-row
    early-out. Returns (dist [P, K, bp], residual frontier [P, K, bp] f32
    0/1, relaxations [P, K] int32)."""
    P, K, bp = dist.shape
    _, n_vtiles, n_chunks, eb = src_t.shape
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
        for i in range(n_vtiles):
            tile = slice(i * vb, (i + 1) * vb)
            for j in range(n_chunks):
                src = src_t[:, i, j].long()[:, None, :].expand(P, K, eb)
                w = torch.where(pruned_t[:, i, j] > 0, INF,
                                w_t[:, i, j])[:, None, :]
                f_src = torch.gather(fcur, -1, src) > 0
                d_src = torch.gather(out, -1, src)    # live row: Gauss–Seidel
                cand = torch.where(f_src, d_src + w, INF)
                n = (f_src & (w < INF)).sum(-1, dtype=torch.int32)
                count += torch.where(active, n, 0)
                mins = tile_min_batch(cand, dstrel_t[:, i, j][:, None, :],
                                      width=vb)
                cur = out[..., tile]
                out[..., tile] = torch.where(active[..., None],
                                             torch.minimum(cur, mins), cur)
    return out, (out < prev).float(), count


_SIGNATURES = {"relax_fixpoint_batch": build.signature(11, 8)}


def relax_dst_tiled_fixpoint_batch(dist, front, src_t, w_t, dstrel_t,
                                   pruned_t, *, vb: int, n_sweeps: int):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one CTA per (shard, query))."""
    if not dist.is_cuda:
        return relax_dst_tiled_fixpoint_batch_plain(
            dist, front, src_t, w_t, dstrel_t, pruned_t, vb=vb,
            n_sweeps=n_sweeps)
    P, K, bp = dist.shape
    _, n_vtiles, n_chunks, eb = src_t.shape
    if bp != n_vtiles * vb or front.shape != dist.shape:
        raise ValueError(f"relax: rows {tuple(dist.shape)} do not match "
                         f"{n_vtiles} tiles of {vb}")
    check_cuda("relax", torch.float32, dist, front, w_t)
    check_cuda("relax", torch.int32, src_t, dstrel_t, pruned_t)
    lib = build.load("relax", _SIGNATURES)
    out = torch.empty_like(dist)
    resid = torch.empty_like(dist)
    nrel = torch.empty((P, K), dtype=torch.int32, device=dist.device)
    prev = torch.empty_like(dist)          # scratch: previous-sweep rows
    fcur = torch.empty_like(dist)          # scratch: current frontier rows
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    code = lib.relax_fixpoint_batch(
        *map(build.ptr, (dist, front, src_t, w_t, dstrel_t, pruned_t, out,
                         resid, nrel, prev, fcur)),
        P, K, bp, n_vtiles, n_chunks, eb, vb, n_sweeps, stream)
    build.check(lib, "relax", code)
    build.count_launch("relax")
    return out, resid, nrel
