"""Ragged solves of the PyTorch port, end to end.

The port's engine on ragged shards (the JAX package's, carried across by
``shards_from_arrays``) against the JAX engine on the same shards, under
one config dict: distances bit-identical, every counter and ``status``
equal, for the all-kernel staged config and the default config (whose
``xla`` backends read only the edge lists, so they must solve ragged
shards unchanged), K in {1, 3}, P in {1, 4, 8}. And inside the port, the
ragged solve against the dense solve of the same graph: the ragged kernels
walk the dense chunk order minus its all-padding chunks, so distances and
every counter are equal. The tolerance is zero.
"""
import dataclasses

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas", round="staged", exchange="bucket",
                   toka="toka0")
CONFIGS = {"all-kernel": ALL_KERNELS, "default": {}}
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "n_dispatches", "bytes_moved", "stale_merges", "resends")
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
GRAPH = dict(scale=7, edge_factor=8, seed=3)


def _live_sources(g, k, seed):
    rng = np.random.default_rng(seed)
    deg = np.diff(np.asarray(g.row_ptr))
    return [int(s) for s in rng.choice(np.nonzero(deg)[0], k, replace=False)]


@pytest.fixture(scope="module")
def jax_graph():
    return jg.rmat_graph(**GRAPH)


@pytest.fixture(scope="module")
def jax_ragged(jax_graph):
    cache = {}

    def get(P):
        if P not in cache:
            cache[P] = jc.build_shards(jax_graph, P, layout="ragged", **TILE)
        return cache[P]
    return get


def _port_shards(sj):
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return tc.shards_from_arrays(fields, **static)


def assert_results_equal(a, b):
    np.testing.assert_array_equal(a.dist, np.asarray(b.dist))
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a.stats, f)),
                                      np.asarray(getattr(b.stats, f)),
                                      err_msg=f)
    assert a.status == b.status
    assert a.bucket_k == b.bucket_k


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_ragged_engine_matches_reference(jax_graph, jax_ragged, config, P,
                                         nq):
    sj = jax_ragged(P)
    srcs = _live_sources(jax_graph, nq, seed=P + nq)
    cfg = dict(CONFIGS[config], pallas_sweeps=4)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    st = _port_shards(sj)
    assert st.layout == "ragged"
    rt = tc.SsspEngine.build(st, tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert rj.status == "converged"
    assert_results_equal(rt, rj)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_ragged_solve_equals_dense_solve(P):
    """Stream-built ragged shards and batch-built dense shards of one
    graph solve alike in the port, counter for counter, with Trishla on
    (triangles enumerated on both sides); CPU tensors launch no kernel."""
    g = tg.rmat_graph(**GRAPH)
    srcs = _live_sources(g, 3, seed=P)
    dense = tc.build_shards(g, P, **TILE)
    ragged = tc.build_shards_stream(tg.edge_chunks_of(g, 500), g.n_vertices,
                                    P, enumerate_triangles=True, **TILE)
    assert torch.equal(ragged.tri_uj, dense.tri_uj)
    before = dict(build.LAUNCHES)
    cfg = tc.SsspConfig(**ALL_KERNELS, pallas_sweeps=2, tri_chunk=16)
    rd = tc.SsspEngine.build(dense, cfg, device="cpu").solve(srcs)
    rr = tc.SsspEngine.build(ragged, cfg, device="cpu").solve(srcs)
    assert build.LAUNCHES == before
    assert rr.status == "converged"
    assert_results_equal(rr, rd)
    for i, s in enumerate(srcs):
        np.testing.assert_allclose(rr.dist[i], tg.dijkstra_reference(g, s),
                                   rtol=1e-5, atol=1e-4)
