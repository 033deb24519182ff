"""Whole-graph container (padded COO sorted by src, CSR row offsets).

The PyTorch counterpart of the reference package's ``graph/structure.py``.
Arrays are host (CPU) torch tensors in the reference's dtypes: int32 ids,
float32 weights. Padding edges use ``src = dst = n_vertices`` and
``weight = +inf`` so they never win a min-plus relaxation.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class Graph:
    """A whole (unpartitioned) graph in padded COO, sorted by src."""

    src: torch.Tensor       # [e_pad] int32
    dst: torch.Tensor       # [e_pad] int32
    weight: torch.Tensor    # [e_pad] float32
    row_ptr: torch.Tensor   # [n+1] int32 (offsets into the sorted edge list)
    n_vertices: int
    n_edges: int

    @property
    def e_pad(self) -> int:
        return self.src.shape[0]

    @property
    def valid(self) -> torch.Tensor:
        return torch.arange(self.e_pad, dtype=torch.int32) < self.n_edges


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """1-D block partition of a Graph over P shards (paper §III.A): vertex
    v is owned by shard ``v // block``, ``block = ceil(n / P)``. Per-shard
    local COO sorted by local src, padded to the max edge count across
    shards so the stacked [P, e_max] arrays are rectangular."""

    src_local: torch.Tensor    # [P, e_max] int32 src id within the shard
    dst_global: torch.Tensor   # [P, e_max] int32
    dst_owner: torch.Tensor    # [P, e_max] int32 shard owning dst
    dst_local: torch.Tensor    # [P, e_max] int32 dst id within its owner
    weight: torch.Tensor       # [P, e_max] float32
    valid: torch.Tensor        # [P, e_max] bool
    is_cut: torch.Tensor       # [P, e_max] bool (dst owned by another shard)
    n_vertices: int
    n_edges: int
    n_parts: int
    block: int

    @property
    def e_max(self) -> int:
        return self.src_local.shape[1]

    @property
    def n_cut_edges(self) -> int:
        return int((self.valid & self.is_cut).sum())


def graph_from_arrays(src, dst, weight, row_ptr, n_vertices: int,
                      n_edges: int) -> Graph:
    """Wrap host arrays (e.g. another package's ``Graph`` read out as numpy)
    without re-sorting, so both sides hold the identical edge order."""
    return Graph(
        src=torch.from_numpy(np.asarray(src, np.int32).copy()),
        dst=torch.from_numpy(np.asarray(dst, np.int32).copy()),
        weight=torch.from_numpy(np.asarray(weight, np.float32).copy()),
        row_ptr=torch.from_numpy(np.asarray(row_ptr, np.int32).copy()),
        n_vertices=int(n_vertices), n_edges=int(n_edges))


def csr_from_coo(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
                 n_vertices: int, e_pad: int | None = None,
                 dedup: bool = True) -> Graph:
    """Sort COO by (src, dst), optionally dedup keeping min weight, pad."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    weight = np.asarray(weight, np.float32)
    order = np.lexsort((dst, src))
    src, dst, weight = src[order], dst[order], weight[order]
    if dedup and len(src):
        # keep min weight among duplicate (src, dst): sort by (key, weight)
        key = src * n_vertices + dst
        o2 = np.lexsort((weight, key))
        key, src, dst, weight = key[o2], src[o2], dst[o2], weight[o2]
        keep = np.ones(len(key), bool)
        keep[1:] = key[1:] != key[:-1]
        src, dst, weight = src[keep], dst[keep], weight[keep]
    n_edges = len(src)
    if e_pad is None:
        e_pad = max(n_edges, 1)
    if e_pad < n_edges:
        raise ValueError(f"e_pad={e_pad} < n_edges={n_edges}")
    pad = e_pad - n_edges
    src_p = np.concatenate([src, np.full(pad, n_vertices, np.int64)])
    dst_p = np.concatenate([dst, np.full(pad, n_vertices, np.int64)])
    w_p = np.concatenate([weight, np.full(pad, np.inf, np.float32)])
    row_ptr = np.zeros(n_vertices + 1, np.int64)
    np.add.at(row_ptr, src + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    return graph_from_arrays(src_p, dst_p, w_p, row_ptr, n_vertices, n_edges)


def graph_to_numpy(g: Graph):
    """Valid (src, dst, weight) as numpy."""
    e = g.n_edges
    return (g.src[:e].numpy(), g.dst[:e].numpy(), g.weight[:e].numpy())
