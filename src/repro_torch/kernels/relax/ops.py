"""Host-side dst-tiled layout builder and the operand padding of the relax
kernel (the reference's ``kernels/relax/ops.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import pad_last, take_fill


def build_dst_tiled_layout(src, dst, w, n_vertices: int, *, vb: int = 128,
                           eb: int = 512):
    """One-time host preprocessing: edges -> [n_vtiles, n_chunks, EB].

    Padding entries use src = block_pad - 1 (the gather stays in range; the
    padded distance slot is +inf) and w = +inf so they never win the min.
    eid_t is each tiled slot's position in the ORIGINAL edge list
    (sentinel = len(src) for padding), so runtime per-edge state (the
    Trishla mask) gathers into tiled order. Returns (src_t, w_t, dstrel_t,
    eid_t) as int32/float32 torch tensors, and ``block_pad``."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    n_edges = len(src)
    eid = np.arange(n_edges, dtype=np.int64)
    keep = np.isfinite(w)
    src, dst, w, eid = src[keep], dst[keep], w[keep], eid[keep]

    n_vtiles = max(-(-n_vertices // vb), 1)
    block_pad = n_vtiles * vb
    order = np.argsort(dst, kind="stable")
    src, dst, w, eid = src[order], dst[order], w[order], eid[order]
    counts = np.bincount(dst // vb, minlength=n_vtiles)
    n_chunks = max(int(-(-counts.max() // eb)) if counts.size else 1, 1)

    src_t = np.full((n_vtiles, n_chunks * eb), block_pad - 1, np.int64)
    w_t = np.full((n_vtiles, n_chunks * eb), np.inf, np.float32)
    dstrel_t = np.zeros((n_vtiles, n_chunks * eb), np.int64)
    eid_t = np.full((n_vtiles, n_chunks * eb), n_edges, np.int64)
    starts = np.zeros(n_vtiles + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    for t in range(n_vtiles):
        lo, hi = starts[t], starts[t + 1]
        k = hi - lo
        src_t[t, :k] = src[lo:hi]
        w_t[t, :k] = w[lo:hi]
        dstrel_t[t, :k] = dst[lo:hi] - t * vb
        eid_t[t, :k] = eid[lo:hi]

    shape3 = (n_vtiles, n_chunks, eb)

    def i32(a):
        return torch.from_numpy(a.reshape(shape3).astype(np.int32))

    return (i32(src_t), torch.from_numpy(w_t.reshape(shape3)), i32(dstrel_t),
            i32(eid_t), block_pad)


def fixpoint_operands(dist, active, pruned_loc, eid_t, block_pad: int):
    """Rows and mask in the kernel's form: dist/active [P, K, block] padded
    to ``block_pad`` (+inf / 0), and the runtime Trishla mask ``pruned_loc``
    [P, e_loc] gathered into tiled edge order through ``eid_t`` (padding
    sentinel -> 0 = not pruned, so padding stays inert)."""
    dist_pad = pad_last(dist, block_pad, float("inf"))
    front_pad = pad_last(active.float(), block_pad, 0.0)
    P = eid_t.shape[0]
    pruned_t = take_fill(pruned_loc.to(torch.int32), eid_t.reshape(P, -1),
                         0).reshape(eid_t.shape)
    return dist_pad, front_pad, pruned_t
