"""Layer-wise uniform neighbor sampler (GraphSAGE-style) for minibatch GNN
training (the reference's ``graph/sampler.py``), the sampler the
``minibatch_lg`` shape (fanout 15-10) stands for.

Host-side numpy over a CSR adjacency built from a ``Graph``'s host
tensors; it makes the reference's draws in the reference's order, so a
seed gives the reference's arrays exactly. It emits padded, fixed-shape
subgraph batches (sentinel ``max_nodes`` on padding edges, the models'
convention), which the caller moves to the device.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: tuple[int, ...], seed: int = 0):
        src = g.src[: g.n_edges].cpu().numpy().astype(np.int64)
        dst = g.dst[: g.n_edges].cpu().numpy().astype(np.int64)
        self.n = g.n_vertices
        order = np.argsort(src, kind="stable")
        self.dst_sorted = dst[order]
        self.row_ptr = np.zeros(self.n + 1, np.int64)
        np.add.at(self.row_ptr, src + 1, 1)
        self.row_ptr = np.cumsum(self.row_ptr)
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def max_nodes(self, batch_nodes: int) -> int:
        m = batch_nodes
        total = batch_nodes
        for f in self.fanouts:
            m *= f
            total += m
        return total

    def max_edges(self, batch_nodes: int) -> int:
        m, total = batch_nodes, 0
        for f in self.fanouts:
            total += m * f
            m *= f
        return total

    def sample(self, seeds: np.ndarray):
        """Returns (nodes [max_nodes], src [max_e], dst [max_e], n_real_nodes),
        int64 numpy arrays.

        src/dst are *local* indices into ``nodes``; padding uses max_nodes
        (the sentinel convention shared with the models); padding nodes
        read ``n_vertices``."""
        B = len(seeds)
        max_n, max_e = self.max_nodes(B), self.max_edges(B)
        nodes = list(seeds)
        local_of = {int(v): i for i, v in enumerate(seeds)}
        srcs, dsts = [], []
        frontier = list(seeds)
        for f in self.fanouts:
            nxt = []
            for u in frontier:
                lo, hi = self.row_ptr[u], self.row_ptr[u + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = self.rng.integers(lo, hi, size=min(f, deg))
                for e in take:
                    v = int(self.dst_sorted[e])
                    if v not in local_of:
                        local_of[v] = len(nodes)
                        nodes.append(v)
                        nxt.append(v)
                    # message flows neighbor -> seed direction (v -> u)
                    srcs.append(local_of[v])
                    dsts.append(local_of[u])
            frontier = nxt
        n_real = len(nodes)
        nodes_pad = np.full(max_n, self.n, np.int64)
        nodes_pad[:n_real] = nodes
        src_pad = np.full(max_e, max_n, np.int64)
        dst_pad = np.full(max_e, max_n, np.int64)
        src_pad[: len(srcs)] = srcs
        dst_pad[: len(dsts)] = dsts
        return nodes_pad, src_pad, dst_pad, n_real
