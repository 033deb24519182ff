"""Send-phase segment-min pack over the slot-tiled cut-edge layout, dense
and ragged.

Port of the reference's ``kernels/send/send.py: send_pack_tiled`` and
``send_pack_ragged``. Each wrapper runs the CUDA kernel (``csrc/send.cu``)
on CUDA tensors and its plain PyTorch version on CPU tensors; the
``*_plain`` functions are the plain versions, callable on either device.

Shapes carry the ``sim`` backend's leading shard axis: dist ``[P, K, bp]``,
last_sent ``[P, K, S_pad]``, valid ``[P, S_pad]``; the dense layout is
``[P, n_stiles, n_chunks, EB]``, the ragged one ``[P, total_chunks, EB]``
with the chunk->tile map ``ctile`` ``[P, total_chunks]``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (INF, check_cuda, chunk_bounds,
                                        same_card)
from repro_torch.kernels.tile_reduce import tile_min_batch


def _chunk_minima(dist, src_c, w_c, segrel_c, pruned_c, *, sb: int):
    """Per-slot minima [P, K, sb] of one chunk's candidates dist[src] + w
    (Trishla-pruned edges count as +inf), for every query."""
    P, K, _ = dist.shape
    src = src_c.long()[:, None, :].expand(P, K, -1)
    w = torch.where(pruned_c > 0, INF, w_c)
    cand = torch.gather(dist, -1, src) + w[:, None, :]
    return tile_min_batch(cand, segrel_c[:, None, :], width=sb)


def _finalize(acc, last, valid):
    """Improvement mask against last_sent: (send value, +inf where not
    improved; new last_sent; counts of improved slots [.., K] int32)."""
    improved = (valid[:, None, :] > 0) & (acc < last)
    return (torch.where(improved, acc, INF), torch.where(improved, acc, last),
            improved.sum(-1, dtype=torch.int32))


def send_pack_tiled_plain(dist, last, valid, src_t, w_t, segrel_t, pruned_t,
                          *, sb: int):
    """Transliteration of the Pallas grid (slot tile, chunk) with the whole
    query batch per step. Returns (send_val [P, K, S_pad], +inf where not
    improved; new_last [P, K, S_pad]; sends [P, K] int32)."""
    P, K, _ = dist.shape
    _, n_stiles, n_chunks, eb = src_t.shape
    val = torch.empty_like(last)
    new_last = torch.empty_like(last)
    sends = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    for i in range(n_stiles):
        tile = slice(i * sb, (i + 1) * sb)
        acc = torch.full((P, K, sb), INF, device=dist.device)
        for j in range(n_chunks):
            acc = torch.minimum(acc, _chunk_minima(
                dist, src_t[:, i, j], w_t[:, i, j], segrel_t[:, i, j],
                pruned_t[:, i, j], sb=sb))
        # tile i complete: improvement mask, last_sent update, counts
        val[..., tile], new_last[..., tile], n = _finalize(
            acc, last[..., tile], valid[:, tile])
        sends += n
    return val, new_last, sends


def send_pack_ragged_plain(dist, last, valid, ctile, src_r, w_r, segrel_r,
                           pruned_r, *, sb: int):
    """Transliteration of the Pallas ragged grid (chunk,) with the whole
    query batch per step: chunk c of shard p min-accumulates into slot
    tile ``min(ctile[p, c], n_stiles - 1)``; init (+inf) and finalize run
    once over the whole [K, S_pad] row, so a tile with no chunks finalizes
    to +inf with no send. Same returns as the dense version."""
    P, K, sp = last.shape
    tiles = ctile.long().clamp(max=sp // sb - 1)            # [P, total_chunks]
    lanes = torch.arange(sb, device=dist.device)
    acc = torch.full_like(last, INF)
    for c in range(src_r.shape[1]):
        mins = _chunk_minima(dist, src_r[:, c], w_r[:, c], segrel_r[:, c],
                             pruned_r[:, c], sb=sb)
        idx = (tiles[:, c, None] * sb + lanes)[:, None, :].expand(P, K, sb)
        acc.scatter_(-1, idx, torch.minimum(torch.gather(acc, -1, idx), mins))
    return _finalize(acc, last, valid)


_SIGNATURES = {"send_pack_tiled": build.signature(11, 8),
               "send_pack_ragged": build.signature(12, 8),
               "send_smem_bytes": [ctypes.c_int] * 2}


def _outputs(name, lib, dist, last, sb: int):
    """The interleaved rows' scratch, P * bp * K words and K of padding
    that a last query group's pair loop may read past the rows (None at
    K = 1), val, new_last, and the zeroed sends [P, K]. Any K runs: the
    kernel splits the queries into groups whose tiles of minima fit in
    shared memory. Raises when a slot tile of ``sb`` is too wide for even
    one query's tile beside one staged edge."""
    P, K, bp = dist.shape
    if K and build.call(lib, "send_smem_bytes", dist.device, K, sb) < 0:
        raise ValueError(f"{name}: a tile of {sb} slots does not fit in "
                         f"shared memory for even one query; use narrower "
                         f"slot tiles")
    scratch = (torch.empty(P * bp * K + K, device=dist.device) if K > 1
               else None)
    return scratch, (torch.empty_like(last), torch.empty_like(last),
                     torch.zeros(last.shape[:2], dtype=torch.int32,
                                 device=last.device))


def send_pack_tiled(dist, last, valid, src_t, w_t, segrel_t, pruned_t, *,
                    sb: int):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (the rows query-interleaved,
    then one CTA per (shard, slot tile) over (edge, query) pairs; kernel
    4's template)."""
    if not dist.is_cuda:
        return send_pack_tiled_plain(dist, last, valid, src_t, w_t, segrel_t,
                                     pruned_t, sb=sb)
    dev = same_card("send", dist, last, valid, src_t, w_t, segrel_t, pruned_t)
    P, K, bp = dist.shape
    _, n_stiles, n_chunks, eb = src_t.shape
    sp = n_stiles * sb
    if last.shape != (P, K, sp) or valid.shape != (P, sp):
        raise ValueError(f"send: slot rows {tuple(last.shape)} / "
                         f"{tuple(valid.shape)} do not match {n_stiles} "
                         f"tiles of {sb}")
    check_cuda("send", torch.float32, dist, last, w_t)
    check_cuda("send", torch.int32, valid, src_t, segrel_t, pruned_t)
    lib = build.load("send", _SIGNATURES)
    scratch, outs = _outputs("send", lib, dist, last, sb)
    build.call(lib, "send_pack_tiled", dev,
               *map(build.ptr_or_null, (dist, scratch, last, valid, src_t,
                                        w_t, segrel_t, pruned_t, *outs)),
               P, K, bp, sp, n_stiles, n_chunks, eb, sb, launch="send")
    build.count_launch("send")
    return outs


def send_pack_ragged(dist, last, valid, ctile, src_r, w_r, segrel_r,
                     pruned_r, *, sb: int, bounds=None):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (the rows query-interleaved,
    then one CTA per (shard, slot tile) over the (edge, query) pairs of
    the tile's chunk range). ``bounds`` [P, n_stiles + 1] are
    the tile -> chunk ranges of ``ctile`` (``chunk_bounds``); callers that
    launch often pass them precomputed."""
    if not dist.is_cuda:
        return send_pack_ragged_plain(dist, last, valid, ctile, src_r, w_r,
                                      segrel_r, pruned_r, sb=sb)
    dev = same_card("send_ragged", dist, last, valid, ctile, src_r, w_r,
                    segrel_r, pruned_r, bounds)
    P, K, bp = dist.shape
    _, total_chunks, eb = src_r.shape
    sp = last.shape[-1]
    n_stiles = sp // sb
    if bounds is None:
        bounds = chunk_bounds(ctile, n_stiles)
    if (last.shape != (P, K, sp) or sp % sb or valid.shape != (P, sp)
            or ctile.shape != (P, total_chunks)
            or bounds.shape != (P, n_stiles + 1)):
        raise ValueError(f"send_ragged: slot rows {tuple(last.shape)} / "
                         f"{tuple(valid.shape)}, ctile {tuple(ctile.shape)} "
                         f"or bounds {tuple(bounds.shape)} do not match "
                         f"tiles of {sb} and {total_chunks} chunks")
    check_cuda("send_ragged", torch.float32, dist, last, w_r)
    check_cuda("send_ragged", torch.int32, valid, bounds, src_r, segrel_r,
               pruned_r)
    lib = build.load("send", _SIGNATURES)
    scratch, outs = _outputs("send_ragged", lib, dist, last, sb)
    build.call(lib, "send_pack_ragged", dev,
               *map(build.ptr_or_null, (dist, scratch, last, valid, bounds,
                                        src_r, w_r, segrel_r, pruned_r,
                                        *outs)),
               P, K, bp, sp, n_stiles, total_chunks, eb, sb,
               launch="send_ragged")
    build.count_launch("send_ragged")
    return outs
