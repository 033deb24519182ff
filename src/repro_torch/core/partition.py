"""1-D block graph partitioning (paper §III.A).

``Pid(v) = v // block`` with ``block = ceil(N / P)``: each shard keeps the
out-edges of its own vertices. Host-side numpy, one-time cost.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structure import (Graph, PartitionedGraph,
                                        graph_to_numpy)


def partition_1d(g: Graph, n_parts: int,
                 e_max: int | None = None) -> PartitionedGraph:
    src, dst, w = graph_to_numpy(g)
    n = g.n_vertices
    block = -(-n // n_parts)  # ceil
    owner = (src // block).astype(np.int64)
    counts = np.bincount(owner, minlength=n_parts)
    if e_max is None:
        e_max = max(int(counts.max()) if len(counts) else 1, 1)
    if e_max < counts.max():
        raise ValueError(f"e_max={e_max} < largest shard {counts.max()}")

    P = n_parts
    src_local = np.full((P, e_max), block, np.int64)       # sentinel local id
    dst_global = np.full((P, e_max), n, np.int64)
    dst_owner = np.zeros((P, e_max), np.int64)
    dst_local = np.full((P, e_max), block, np.int64)
    weight = np.full((P, e_max), np.inf, np.float32)
    valid = np.zeros((P, e_max), bool)

    order = np.argsort(owner, kind="stable")
    s, d, ww, own = src[order], dst[order], w[order], owner[order]
    starts = np.zeros(P + 1, np.int64)
    np.add.at(starts, own + 1, 1)
    starts = np.cumsum(starts)
    for p in range(P):
        lo, hi = starts[p], starts[p + 1]
        k = hi - lo
        src_local[p, :k] = s[lo:hi] - p * block
        dst_global[p, :k] = d[lo:hi]
        dst_owner[p, :k] = d[lo:hi] // block
        dst_local[p, :k] = d[lo:hi] - dst_owner[p, :k] * block
        weight[p, :k] = ww[lo:hi]
        valid[p, :k] = True

    is_cut = valid & (dst_owner != np.arange(P)[:, None])

    def i32(a):
        return torch.from_numpy(a.astype(np.int32))

    return PartitionedGraph(
        src_local=i32(src_local), dst_global=i32(dst_global),
        dst_owner=i32(dst_owner), dst_local=i32(dst_local),
        weight=torch.from_numpy(weight), valid=torch.from_numpy(valid),
        is_cut=torch.from_numpy(is_cut), n_vertices=n, n_edges=g.n_edges,
        n_parts=P, block=int(block))


def inter_edge_counts(pg: PartitionedGraph) -> np.ndarray:
    """Per-partition count of cut (inter-partition) edges."""
    return (pg.valid & pg.is_cut).sum(dim=1).numpy()
