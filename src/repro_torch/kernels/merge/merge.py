"""Merge-phase scatter-min of incoming messages over the msg-tiled layout.

Port of the reference's ``kernels/merge/merge.py: merge_scatter_tiled``.
``merge_scatter_tiled`` runs the CUDA kernel (``csrc/merge.cu``) on CUDA
tensors and the plain PyTorch version on CPU tensors;
``merge_scatter_tiled_plain`` is the plain version, callable on either
device.

Shapes carry the ``sim`` backend's leading shard axis: dist ``[P, K, bp]``,
incoming ``[P, K, M]`` (M = P*C flattened bucket positions), layout
``[P, n_vtiles, n_chunks, EB]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import INF, check_cuda
from repro_torch.kernels.tile_reduce import tile_min_batch


def merge_scatter_tiled_plain(dist, incoming, pos_t, dstrel_t, valid_t, *,
                              vb: int):
    """Transliteration of the Pallas grid (vertex tile, chunk) with the
    whole query batch per step. Returns (new_dist [P, K, bp], new frontier
    [P, K, bp] f32 0/1, recvs [P, K] int32 finite messages seen)."""
    P, K, _ = dist.shape
    _, n_vtiles, n_chunks, eb = pos_t.shape
    out = dist.clone()
    front = torch.empty_like(dist)
    recvs = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    for i in range(n_vtiles):
        tile = slice(i * vb, (i + 1) * vb)
        for j in range(n_chunks):
            pos = pos_t[:, i, j].long()[:, None, :].expand(P, K, eb)
            valid = (valid_t[:, i, j] > 0)[:, None, :]
            v = torch.gather(incoming, -1, pos)
            cand = torch.where(valid, v, INF)
            recvs += (valid & (v < INF)).sum(-1, dtype=torch.int32)
            mins = tile_min_batch(cand, dstrel_t[:, i, j][:, None, :],
                                  width=vb)
            out[..., tile] = torch.minimum(out[..., tile], mins)
        # tile i complete: improved vertices form the next frontier
        front[..., tile] = (out[..., tile] < dist[..., tile]).float()
    return out, front, recvs


_SIGNATURES = {"merge_scatter_tiled": build.signature(8, 8)}


def merge_scatter_tiled(dist, incoming, pos_t, dstrel_t, valid_t, *, vb: int):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one CTA per (shard, tile))."""
    if not dist.is_cuda:
        return merge_scatter_tiled_plain(dist, incoming, pos_t, dstrel_t,
                                         valid_t, vb=vb)
    P, K, bp = dist.shape
    _, n_vtiles, n_chunks, eb = pos_t.shape
    if bp != n_vtiles * vb or incoming.shape[:2] != (P, K):
        raise ValueError(f"merge: rows {tuple(dist.shape)} / incoming "
                         f"{tuple(incoming.shape)} do not match {n_vtiles} "
                         f"tiles of {vb}")
    check_cuda("merge", torch.float32, dist, incoming)
    check_cuda("merge", torch.int32, pos_t, dstrel_t, valid_t)
    lib = build.load("merge", _SIGNATURES)
    out = torch.empty_like(dist)
    front = torch.empty_like(dist)
    recvs = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    code = lib.merge_scatter_tiled(
        *map(build.ptr, (dist, incoming, pos_t, dstrel_t, valid_t, out, front,
                         recvs)),
        P, K, bp, incoming.shape[-1], n_vtiles, n_chunks, eb, vb, stream)
    build.check(lib, "merge", code)
    build.count_launch("merge")
    return out, front, recvs
