"""Reference SSSP oracles (pure numpy, host-side): ground truth for tests and
for ``chip_smoke.py``."""
from __future__ import annotations

import heapq

import numpy as np

from repro_torch.graph.structure import Graph, graph_to_numpy


def dijkstra_reference(g: Graph, source: int) -> np.ndarray:
    """Binary-heap Dijkstra. O((V+E) log V)."""
    src, dst, w = graph_to_numpy(g)
    n = g.n_vertices
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    row_ptr = np.zeros(n + 1, np.int64)
    np.add.at(row_ptr, src + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    dist = np.full(n, np.inf, np.float64)
    dist[source] = 0.0
    done = np.zeros(n, bool)
    heap = [(0.0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for e in range(row_ptr[u], row_ptr[u + 1]):
            v = dst[e]
            nd = d + w[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist.astype(np.float32)


def bellman_ford_reference(g: Graph, source: int,
                           max_iters: int | None = None) -> np.ndarray:
    """Vectorized Bellman-Ford (numpy)."""
    src, dst, w = graph_to_numpy(g)
    n = g.n_vertices
    dist = np.full(n, np.inf, np.float64)
    dist[source] = 0.0
    iters = max_iters if max_iters is not None else n
    for _ in range(iters):
        cand = dist[src] + w
        new = dist.copy()
        np.minimum.at(new, dst, cand)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist.astype(np.float32)
