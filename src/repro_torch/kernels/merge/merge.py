"""Merge-phase scatter-min of incoming messages over the msg-tiled layout,
dense and ragged.

Port of the reference's ``kernels/merge/merge.py: merge_scatter_tiled``
and ``merge_scatter_ragged``. Each wrapper runs the CUDA kernel
(``csrc/merge.cu``) on CUDA tensors and its plain PyTorch version on CPU
tensors; the ``*_plain`` functions are the plain versions, callable on
either device.

Shapes carry the ``sim`` backend's leading shard axis: dist ``[P, K, bp]``,
incoming ``[P, K, M]`` (M = P*C flattened bucket positions); the dense
layout is ``[P, n_vtiles, n_chunks, EB]``, the ragged one
``[P, total_chunks, EB]`` with the chunk->tile map ``ctile``
``[P, total_chunks]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (INF, check_cuda, chunk_bounds,
                                        same_card)
from repro_torch.kernels.tile_reduce import tile_min_batch


def _chunk_minima(incoming, recvs, pos_c, dstrel_c, valid_c, *, vb: int):
    """Per-vertex minima [P, K, vb] of one chunk's messages, for every
    query; adds the chunk's finite messages to ``recvs`` in place."""
    P, K, _ = incoming.shape
    pos = pos_c.long()[:, None, :].expand(P, K, -1)
    valid = (valid_c > 0)[:, None, :]
    v = torch.gather(incoming, -1, pos)
    recvs += (valid & (v < INF)).sum(-1, dtype=torch.int32)
    return tile_min_batch(torch.where(valid, v, INF), dstrel_c[:, None, :],
                          width=vb)


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
            mins = _chunk_minima(incoming, recvs, pos_t[:, i, j],
                                 dstrel_t[:, i, j], valid_t[:, i, j], vb=vb)
            out[..., tile] = torch.minimum(out[..., tile], mins)
        # tile i complete: improved vertices form the next frontier
        front[..., tile] = (out[..., tile] < dist[..., tile]).float()
    return out, front, recvs


def merge_scatter_ragged_plain(dist, incoming, ctile, pos_r, dstrel_r,
                               valid_r, *, vb: int):
    """Transliteration of the Pallas ragged grid (chunk,) with the whole
    query batch per step: chunk c of shard p min-accumulates into vertex
    tile ``min(ctile[p, c], n_vtiles - 1)``; init (out = dist) and finalize
    (frontier) run once over the whole row, so a tile with no chunks keeps
    its distances and gets an empty frontier. Same returns."""
    P, K, bp = dist.shape
    tiles = ctile.long().clamp(max=bp // vb - 1)            # [P, total_chunks]
    lanes = torch.arange(vb, device=dist.device)
    out = dist.clone()
    recvs = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    for c in range(pos_r.shape[1]):
        mins = _chunk_minima(incoming, recvs, pos_r[:, c], dstrel_r[:, c],
                             valid_r[:, c], vb=vb)
        idx = (tiles[:, c, None] * vb + lanes)[:, None, :].expand(P, K, vb)
        out.scatter_(-1, idx, torch.minimum(torch.gather(out, -1, idx), mins))
    return out, (out < dist).float(), recvs


_SIGNATURES = {"merge_scatter_tiled": build.signature(8, 8),
               "merge_scatter_ragged": build.signature(9, 8),
               "merge_smem_bytes": [ctypes.c_int] * 2}


def _outputs(name, lib, dist, vb: int):
    """out, front, and recvs [P, K], which the C entry point zeroes on the
    launch's stream (no fill kernel of its own). Any K runs: the kernel
    splits the queries into groups whose [Kg, vb] tiles fit in shared
    memory. Raises when a tile of ``vb`` vertices is too wide for even one
    query."""
    if dist.shape[1] and build.call(lib, "merge_smem_bytes", dist.device,
                                    dist.shape[1], vb) < 0:
        raise ValueError(f"{name}: a tile of {vb} vertices does not fit in "
                         f"shared memory for even one query; use narrower "
                         f"vertex tiles")
    return (torch.empty_like(dist), torch.empty_like(dist),
            dist.new_empty(dist.shape[:2], dtype=torch.int32))


def merge_scatter_tiled(dist, incoming, pos_t, dstrel_t, valid_t, *, vb: int):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one CTA per (shard, tile), its
    threads over the tile's message quads)."""
    if not dist.is_cuda:
        return merge_scatter_tiled_plain(dist, incoming, pos_t, dstrel_t,
                                         valid_t, vb=vb)
    dev = same_card("merge", dist, incoming, pos_t, dstrel_t, valid_t)
    P, K, bp = dist.shape
    _, n_vtiles, n_chunks, eb = pos_t.shape
    if bp != n_vtiles * vb or incoming.shape[:2] != (P, K):
        raise ValueError(f"merge: rows {tuple(dist.shape)} / incoming "
                         f"{tuple(incoming.shape)} do not match {n_vtiles} "
                         f"tiles of {vb}")
    check_cuda("merge", torch.float32, dist, incoming)
    check_cuda("merge", torch.int32, pos_t, dstrel_t, valid_t)
    lib = build.load("merge", _SIGNATURES)
    outs = _outputs("merge", lib, dist, vb)
    build.call(lib, "merge_scatter_tiled", dev,
               *(t.data_ptr() for t in (dist, incoming, pos_t, dstrel_t,
                                        valid_t, *outs)),
               P, K, bp, incoming.shape[-1], n_vtiles, n_chunks, eb, vb,
               launch="merge")
    build.count_launch("merge")
    return outs


def merge_scatter_ragged(dist, incoming, ctile, pos_r, dstrel_r, valid_r, *,
                         vb: int, bounds=None):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one CTA per (shard, vertex
    tile), over the tile's chunk range). ``bounds`` [P, n_vtiles + 1] are
    the tile -> chunk ranges of ``ctile`` (``chunk_bounds``); callers that
    launch often pass them precomputed."""
    if not dist.is_cuda:
        return merge_scatter_ragged_plain(dist, incoming, ctile, pos_r,
                                          dstrel_r, valid_r, vb=vb)
    dev = same_card("merge_ragged", dist, incoming, ctile, pos_r, dstrel_r,
                    valid_r, bounds)
    P, K, bp = dist.shape
    _, total_chunks, eb = pos_r.shape
    n_vtiles = bp // vb
    if bounds is None:
        bounds = chunk_bounds(ctile, n_vtiles)
    if (bp % vb or incoming.shape[:2] != (P, K)
            or ctile.shape != (P, total_chunks)
            or bounds.shape != (P, n_vtiles + 1)):
        raise ValueError(f"merge_ragged: rows {tuple(dist.shape)} / incoming "
                         f"{tuple(incoming.shape)}, ctile "
                         f"{tuple(ctile.shape)} or bounds "
                         f"{tuple(bounds.shape)} do not match tiles of {vb} "
                         f"and {total_chunks} chunks")
    check_cuda("merge_ragged", torch.float32, dist, incoming)
    check_cuda("merge_ragged", torch.int32, bounds, pos_r, dstrel_r, valid_r)
    lib = build.load("merge", _SIGNATURES)
    outs = _outputs("merge_ragged", lib, dist, vb)
    build.call(lib, "merge_scatter_ragged", dev,
               *(t.data_ptr() for t in (dist, incoming, bounds, pos_r,
                                        dstrel_r, valid_r, *outs)),
               P, K, bp, incoming.shape[-1], n_vtiles, total_chunks, eb, vb,
               launch="merge_ragged")
    build.count_launch("merge_ragged")
    return outs
