"""Host-side msg-tiled layout builder and the solver-facing merge wrapper
(the reference's ``kernels/merge/ops.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import INF, pad_last
from repro_torch.kernels.merge.merge import merge_scatter_tiled


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
    ridx = np.asarray(recv_idx, np.int64).reshape(-1)
    pos = np.arange(ridx.shape[0], dtype=np.int64)
    keep = ridx < block
    ridx, pos = ridx[keep], pos[keep]

    n_vtiles = max(-(-block // vb), 1)
    block_pad = n_vtiles * vb
    order = np.argsort(ridx, kind="stable")
    ridx, pos = ridx[order], pos[order]
    counts = np.bincount(ridx // vb, minlength=n_vtiles)
    n_chunks = max(int(-(-counts.max() // eb)) if counts.size else 1, 1)

    pos_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    dstrel_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    valid_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    starts = np.zeros(n_vtiles + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    for t in range(n_vtiles):
        lo, hi = starts[t], starts[t + 1]
        k = hi - lo
        pos_t[t, :k] = pos[lo:hi]
        dstrel_t[t, :k] = ridx[lo:hi] - t * vb
        valid_t[t, :k] = 1

    shape3 = (n_vtiles, n_chunks, eb)

    def i32(a):
        return torch.from_numpy(a.reshape(shape3).astype(np.int32))

    return i32(pos_t), i32(dstrel_t), i32(valid_t), block_pad


def merge_scatter(dist, incoming_flat, pos_t, dstrel_t, valid_t, *,
                  vb: int = 128):
    """Solver-facing wrapper: pads to the kernel's tile shapes, slices back.
    dist [P, K, block]; incoming_flat [P, K, M]. Returns (new_dist
    [P, K, block], new_active [P, K, block] bool, recvs [P, K])."""
    block = dist.shape[-1]
    new, front, recvs = merge_scatter_tiled(
        pad_last(dist, pos_t.shape[1] * vb, INF), incoming_flat.contiguous(),
        pos_t, dstrel_t, valid_t, vb=vb)
    return new[..., :block], front[..., :block] > 0, recvs
