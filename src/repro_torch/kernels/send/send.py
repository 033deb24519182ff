"""Send-phase segment-min pack over the slot-tiled cut-edge layout.

Port of the reference's ``kernels/send/send.py: send_pack_tiled``.
``send_pack_tiled`` runs the CUDA kernel (``csrc/send.cu``) on CUDA tensors
and the plain PyTorch version on CPU tensors; ``send_pack_tiled_plain`` is
the plain version, callable on either device.

Shapes carry the ``sim`` backend's leading shard axis: dist ``[P, K, bp]``,
last_sent ``[P, K, S_pad]``, valid ``[P, S_pad]``, layout
``[P, n_stiles, n_chunks, EB]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import INF, check_cuda
from repro_torch.kernels.tile_reduce import tile_min_batch


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
            src = src_t[:, i, j].long()[:, None, :].expand(P, K, eb)
            w = torch.where(pruned_t[:, i, j] > 0, INF, w_t[:, i, j])
            cand = torch.gather(dist, -1, src) + w[:, None, :]
            acc = torch.minimum(acc, tile_min_batch(
                cand, segrel_t[:, i, j][:, None, :], width=sb))
        # tile i complete: improvement mask, last_sent update, counts
        before = last[..., tile]
        improved = (valid[:, None, tile] > 0) & (acc < before)
        val[..., tile] = torch.where(improved, acc, INF)
        new_last[..., tile] = torch.where(improved, acc, before)
        sends += improved.sum(-1, dtype=torch.int32)
    return val, new_last, sends


_SIGNATURES = {"send_pack_tiled": build.signature(10, 8)}


def send_pack_tiled(dist, last, valid, src_t, w_t, segrel_t, pruned_t, *,
                    sb: int):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one CTA per (shard, tile))."""
    if not dist.is_cuda:
        return send_pack_tiled_plain(dist, last, valid, src_t, w_t, segrel_t,
                                     pruned_t, sb=sb)
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
    val = torch.empty_like(last)
    new_last = torch.empty_like(last)
    sends = torch.zeros((P, K), dtype=torch.int32, device=dist.device)
    stream = torch.cuda.current_stream(dist.device).cuda_stream
    code = lib.send_pack_tiled(
        *map(build.ptr, (dist, last, valid, src_t, w_t, segrel_t, pruned_t,
                         val, new_last, sends)),
        P, K, bp, sp, n_stiles, n_chunks, eb, sb, stream)
    build.check(lib, "send", code)
    build.count_launch("send")
    return val, new_last, sends
