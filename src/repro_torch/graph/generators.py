"""Graph generators (host-side numpy).

The same numpy RNG calls as the reference package's ``graph/generators.py``,
so equal seeds give equal CSR arrays:
  - ``rmat_graph``: R-MAT (the generator behind ParMat), scale-free graphs.
  - ``road_grid_graph``: 2-D grid with diagonal shortcuts, road-network-like.
  - ``random_graph``: uniform random edges with an optional spanning chain.
  - ``assign_weights``: U[1, 20) weights, the paper's setup.
  - ``rmat_edge_stream`` / ``preset_edge_stream``: R-MAT as a stream of
    edge chunks for ``build_shards_stream``; ``edge_chunks_of`` streams a
    materialized graph.
  - ``ogbn_products_graph``: ogbn-products from a local edge-index file.
  - ``PAPER_GRAPHS``: the paper's four graphs, their sizes only.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph, csr_from_coo, graph_to_numpy


def assign_weights(n_edges: int, rng: np.random.Generator,
                   low: float = 1.0, high: float = 20.0) -> np.ndarray:
    """Paper §IV.A: pseudo-random weights uniform in [1, 20)."""
    return rng.uniform(low, high, size=n_edges).astype(np.float32)


def rmat_graph(scale: int, edge_factor: int = 16, seed: int = 0,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               undirected: bool = True, e_pad: int | None = None) -> Graph:
    """R-MAT generator (Graph500 parameters by default). n = 2**scale."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for level in range(scale):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= (go_down.astype(np.int64) << (scale - 1 - level))
        dst |= (go_right.astype(np.int64) << (scale - 1 - level))
    # permute vertex ids to break degree locality
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    keep = src != dst  # drop self loops
    src, dst = src[keep], dst[keep]
    w = assign_weights(len(src), rng)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return csr_from_coo(src, dst, w, n, e_pad=e_pad)


def road_grid_graph(side: int, seed: int = 0, diag_prob: float = 0.1,
                    e_pad: int | None = None) -> Graph:
    """side×side grid, bidirectional edges, a few diagonals. Road-like."""
    rng = np.random.default_rng(seed)
    n = side * side
    vid = np.arange(n).reshape(side, side)
    right = vid[:, :-1].ravel()
    down = vid[:-1, :].ravel()
    diag = vid[:-1, :-1].ravel()
    mask = rng.random(diag.shape[0]) < diag_prob
    src = np.concatenate([right, down, diag[mask]])
    dst = np.concatenate([right + 1, down + side, diag[mask] + side + 1])
    w = assign_weights(len(src), rng)
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.concatenate([w, w])
    return csr_from_coo(src, dst, w, n, e_pad=e_pad)


def random_graph(n: int, m: int, seed: int = 0, undirected: bool = True,
                 e_pad: int | None = None,
                 ensure_connected_from: int | None = 0) -> Graph:
    """Uniform random directed multigraph (deduped), optional spanning chain
    starting at ``ensure_connected_from`` so every vertex is reachable."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if ensure_connected_from is not None:
        order = rng.permutation(n)
        pos = int(np.where(order == ensure_connected_from)[0][0])
        order = np.roll(order, -pos)  # chain starts at the source vertex
        src = np.concatenate([src, order[:-1]])
        dst = np.concatenate([dst, order[1:]])
    w = assign_weights(len(src), rng)
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return csr_from_coo(src, dst, w, n, e_pad=e_pad)


# ---- generator registry + Graph500-style scale presets --------------------

GENERATORS: dict[str, object] = {}


def register_generator(name: str):
    """Decorator: register ``fn(**kwargs) -> Graph`` under ``name``."""
    def deco(fn):
        GENERATORS[name] = fn
        return fn
    return deco


def get_generator(name: str):
    if name not in GENERATORS:
        raise KeyError(f"unknown generator {name!r}: have "
                       f"{sorted(GENERATORS)}")
    return GENERATORS[name]


register_generator("rmat")(rmat_graph)
register_generator("road_grid")(road_grid_graph)
register_generator("random")(random_graph)

# (generator, kwargs) pairs sized by DIRECTED edge count after undirected
# doubling (~1e5 / 1e6 / 1e7); the same presets as the reference package.
SCALE_PRESETS = {
    "scale-1e5": ("rmat", dict(scale=13, edge_factor=8, seed=500)),
    "scale-1e6": ("rmat", dict(scale=16, edge_factor=8, seed=600)),
    "scale-1e7": ("rmat", dict(scale=19, edge_factor=10, seed=700)),
}


def preset_graph(name: str, **overrides) -> Graph:
    """Materialize a ``SCALE_PRESETS`` workload (for 1e7 edges, prefer
    ``preset_edge_stream`` + ``build_shards_stream``)."""
    gen, kw = SCALE_PRESETS[name]
    return get_generator(gen)(**{**kw, **overrides})


def rmat_edge_stream(scale: int, edge_factor: int = 16, seed: int = 0,
                     a: float = 0.57, b: float = 0.19, c: float = 0.19,
                     undirected: bool = True, chunk_edges: int = 1 << 18):
    """R-MAT as an iterator of ``(src, dst, w)`` numpy chunks, for graphs
    too large to materialize as one COO block.

    Each chunk draws from its own counter-keyed stream
    ``default_rng((seed, 1 + i))``, so the edge set depends only on
    (seed, chunk_edges), never on how far the consumer iterated. The vertex
    permutation comes first, from ``default_rng((seed, 0))``. The streams
    differ from ``rmat_graph``'s one sequential draw: the same seed gives
    another graph."""
    n = 1 << scale
    m = n * edge_factor
    perm = np.random.default_rng((seed, 0)).permutation(n)
    for start in range(0, m, chunk_edges):
        cm = min(chunk_edges, m - start)
        rng = np.random.default_rng((seed, 1 + start // chunk_edges))
        src = np.zeros(cm, np.int64)
        dst = np.zeros(cm, np.int64)
        for level in range(scale):
            r = rng.random(cm)
            go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
            go_down = r >= a + b
            src |= (go_down.astype(np.int64) << (scale - 1 - level))
            dst |= (go_right.astype(np.int64) << (scale - 1 - level))
        src, dst = perm[src], perm[dst]
        keep = src != dst
        src, dst = src[keep], dst[keep]
        w = assign_weights(len(src), rng)
        if undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            w = np.concatenate([w, w])
        if len(src):
            yield src, dst, w


def preset_edge_stream(name: str, chunk_edges: int = 1 << 18):
    """Streaming form of a ``SCALE_PRESETS`` workload. Returns
    ``(n_vertices, iterator_of_chunks)``."""
    gen, kw = SCALE_PRESETS[name]
    if gen != "rmat":
        raise ValueError(f"preset {name!r} uses generator {gen!r}, which has "
                         "no streaming form")
    return 1 << kw["scale"], rmat_edge_stream(chunk_edges=chunk_edges, **kw)


def edge_chunks_of(g: Graph, chunk_edges: int = 1 << 18):
    """Chunk iterator over a materialized Graph's valid edges, so the
    streaming shard build can be fed (and tested against) batch inputs."""
    src, dst, w = graph_to_numpy(g)
    for i in range(0, len(src), chunk_edges):
        yield (src[i:i + chunk_edges], dst[i:i + chunk_edges],
               w[i:i + chunk_edges])


def ogbn_products_graph(root: str = "data/ogbn_products",
                        e_pad: int | None = None) -> Graph:
    """Load ogbn-products (2.4M vertices, 123M edges) from a local extract:
    ``<root>/edge.npy`` (or ``edge_index.npy``) holding an int ``[2, E]``
    (or ``[E, 2]``) edge index, as exported from the OGB dataset's graph
    dict. Nothing is fetched: a missing file raises, saying how to make it.
    Edges get U[1, 20) weights from seed 0 (the dataset is unweighted; the
    paper's weight model, ``assign_weights``) and are symmetrized, with
    ``csr_from_coo``'s dedup."""
    import os
    cand = [os.path.join(root, "edge.npy"),
            os.path.join(root, "edge_index.npy")]
    path = next((p for p in cand if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(
            f"ogbn-products edge index not found (looked for {cand}). "
            "On a machine with network access run:\n"
            "  python -c \"from ogb.nodeproppred import NodePropPredDataset; "
            "import numpy as np; d = NodePropPredDataset('ogbn-products'); "
            "np.save('edge.npy', d[0][0]['edge_index'])\"\n"
            f"and place edge.npy under {root}/")
    ei = np.load(path, mmap_mode="r")
    if ei.shape[0] != 2:
        ei = ei.T
    src = np.asarray(ei[0], np.int64)
    dst = np.asarray(ei[1], np.int64)
    n = int(max(src.max(), dst.max())) + 1
    w = assign_weights(len(src), np.random.default_rng(0))
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.concatenate([w, w])
    return csr_from_coo(src, dst, w, n, e_pad=e_pad)


register_generator("ogbn-products")(ogbn_products_graph)


# ---- paper graph descriptors (full scale; numbers only, no data) ----------

PAPER_GRAPHS = {
    # name: (n_vertices, n_edges, comment)
    "graph1": (391_529, 873_775, "small synthetic (ParMat)"),
    "graph2": (23_947_347, 58_333_344, "USA road network"),
    "graph3": (3_072_441, 117_185_083, "Orkut-like social network"),
    "graph4": (41_700_000, 1_470_000_000, "Twitter-like (41.7M v, 1.47B e)"),
}
