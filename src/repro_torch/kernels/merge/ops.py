"""Host-side msg-tiled layout builders (dense and ragged) and the
solver-facing merge wrapper (the reference's ``kernels/merge/ops.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import INF, pad_last
from repro_torch.kernels.merge.merge import (merge_scatter_ragged,
                                            merge_scatter_tiled)


def _by_vertex_tile(recv_idx, block: int, vb: int):
    """The flat positions that carry a message, stably sorted by their
    destination. Returns (ridx, pos, n_vtiles, block_pad, counts, starts)."""
    ridx = np.asarray(recv_idx, np.int64).reshape(-1)
    pos = np.arange(ridx.shape[0], dtype=np.int64)
    keep = ridx < block
    ridx, pos = ridx[keep], pos[keep]
    n_vtiles = max(-(-block // vb), 1)
    order = np.argsort(ridx, kind="stable")
    ridx, pos = ridx[order], pos[order]
    counts = np.bincount(ridx // vb, minlength=n_vtiles)
    starts = np.zeros(n_vtiles + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    return ridx, pos, n_vtiles, n_vtiles * vb, counts, starts


def _i32(a):
    return torch.from_numpy(a.astype(np.int32))


def build_msg_tiled_layout(recv_idx, block: int, *, vb: int = 128,
                           eb: int = 512):
    """One-time host preprocessing: the static receive table ``recv_idx``
    [P, C] (local vertex addressed by (sender, bucket position); sentinel
    >= block = no message) -> flat message positions grouped by
    destination vertex tile.

    Returns (pos_t, dstrel_t, valid_t, block_pad), each layout array
    [n_vtiles, n_chunks, EB] int32: ``pos_t`` indexes the flattened [P*C]
    incoming row, ``dstrel_t`` is the destination within its tile,
    ``valid_t`` masks padding."""
    ridx, pos, n_vtiles, block_pad, counts, starts = _by_vertex_tile(
        recv_idx, block, vb)
    n_chunks = max(int(-(-counts.max() // eb)) if counts.size else 1, 1)

    pos_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    dstrel_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    valid_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    for t in range(n_vtiles):
        lo, hi = starts[t], starts[t + 1]
        k = hi - lo
        pos_t[t, :k] = pos[lo:hi]
        dstrel_t[t, :k] = ridx[lo:hi] - t * vb
        valid_t[t, :k] = 1

    shape3 = (n_vtiles, n_chunks, eb)
    return (_i32(pos_t.reshape(shape3)), _i32(dstrel_t.reshape(shape3)),
            _i32(valid_t.reshape(shape3)), block_pad)


def build_msg_ragged_layout(recv_idx, block: int, *, vb: int = 128,
                            eb: int = 512):
    """Ragged (CSR-chunked) msg routing layout: the static receive table ->
    flat [total_chunks, EB] position rows plus the [total_chunks]
    chunk->tile map (sentinel ``n_vtiles`` on an all-padding chunk, whose
    valid plane is 0). The same stable sort and per-tile EB split as the
    dense builder.

    Returns (pos_r, dstrel_r, valid_r, ctile, block_pad)."""
    ridx, pos, n_vtiles, block_pad, counts, starts = _by_vertex_tile(
        recv_idx, block, vb)
    total_chunks = max(int((-(-counts // eb)).sum()), 1)

    pos_r = np.zeros((total_chunks, eb), np.int64)
    dstrel_r = np.zeros((total_chunks, eb), np.int64)
    valid_r = np.zeros((total_chunks, eb), np.int64)
    ctile = np.full(total_chunks, n_vtiles, np.int64)
    row = 0
    for t in range(n_vtiles):
        lo, hi = starts[t], starts[t + 1]
        for off in range(lo, hi, eb):
            k = min(eb, hi - off)
            pos_r[row, :k] = pos[off:off + k]
            dstrel_r[row, :k] = ridx[off:off + k] - t * vb
            valid_r[row, :k] = 1
            ctile[row] = t
            row += 1
    return (_i32(pos_r), _i32(dstrel_r), _i32(valid_r), _i32(ctile),
            block_pad)


def merge_scatter(dist, incoming_flat, pos_t, dstrel_t, valid_t, *,
                  vb: int = 128, ctile=None, bounds=None):
    """Solver-facing wrapper: pads to the kernel's tile shapes, slices back.
    dist [P, K, block]; incoming_flat [P, K, M]; the layout is dense
    [P, n_vtiles, n_chunks, EB] or, with ``ctile`` [P, total_chunks] given,
    ragged [P, total_chunks, EB] (``bounds``: its precomputed tile -> chunk
    ranges). Returns (new_dist [P, K, block], new_active [P, K, block]
    bool, recvs [P, K])."""
    block = dist.shape[-1]
    n_vtiles = pos_t.shape[1] if ctile is None else -(-block // vb)
    d = pad_last(dist, n_vtiles * vb, INF)
    incoming_flat = incoming_flat.contiguous()
    if ctile is None:
        new, front, recvs = merge_scatter_tiled(
            d, incoming_flat, pos_t, dstrel_t, valid_t, vb=vb)
    else:
        new, front, recvs = merge_scatter_ragged(
            d, incoming_flat, ctile, pos_t, dstrel_t, valid_t, vb=vb,
            bounds=bounds)
    return new[..., :block], front[..., :block] > 0, recvs


def merge_scatter_pallas(dist, incoming_flat, pos_t, dstrel_t, valid_t,
                         ctile=None, *, vb: int = 128, eb: int = 512,
                         interpret: bool = True):
    """The reference's per-shard wrapper: dist [K, block]; incoming_flat
    [K, M] flattened bucketed messages; one shard's msg-tiled layout
    [n_vtiles, n_chunks, EB] or, with ``ctile`` given, its flat ragged
    rows. Returns (new_dist [K, block], new_active [K, block] bool,
    recvs [K]). One shard as a one-shard stack of ``merge_scatter``:
    kernel 5 or 6 on CUDA tensors, the plain versions on CPU tensors.
    ``interpret`` is accepted and ignored."""
    if pos_t.shape[-1] != eb:
        raise ValueError(f"layout chunks hold {pos_t.shape[-1]} messages, "
                         f"eb={eb}")
    new, front, recvs = merge_scatter(
        dist[None], incoming_flat[None], pos_t[None], dstrel_t[None],
        valid_t[None], vb=vb, ctile=None if ctile is None else ctile[None])
    return new[0], front[0], recvs[0]
