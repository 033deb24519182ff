"""The asynchronous mode of the port against the JAX package's, beyond
the fixture matrix of test_torch_async.py and test_torch_toka.py.

- The fault-free part of the reference's acceptance matrix
  (tests/test_async_exchange.py: its three graphs at P=8, its sources and
  configs): ``async`` with toka3 staged and fused, and ``async_ppermute``,
  each equal to the JAX engine in distances and every counter and to the
  synchronous baseline in distances. ``overlap_rounds`` is held to JAX's
  value, case by case (on the road grid it is 0 in both).
- The kernel backends (all-kernel staged: the send, merge and relax
  kernels' plain versions against the Pallas kernels in interpret mode)
  under a dense and the deferred exchanges, on dense and ragged layouts;
  the fused round under a dense exchange on ragged layouts (kernel 8's
  dense mode).
- A ``max_rounds`` exit with payload in flight: the exit-time flush.
- The faulted half of the acceptance matrix: its "drop" and "delay" plans
  under ``async`` with toka3, staged and fused, equal to the JAX engine in
  distances and every counter (``stale_merges`` and ``resends``
  included) and to the synchronous baseline in distances.

Tolerance zero throughout.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import _torch_async_ref as ref  # noqa: E402

ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas")
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
# tests/test_async_exchange.py: _ACCEPT_PROG
ACCEPT_GRAPHS = {
    "graph1-like": ("rmat_graph", dict(scale=10, edge_factor=2, seed=1)),
    "graph2-like": ("road_grid_graph", dict(side=32, seed=2)),
    "graph3-like": ("rmat_graph", dict(scale=8, edge_factor=16, seed=3)),
}


# tests/test_async_exchange.py: _ACCEPT_PROG's fault plans
ACCEPT_PLANS = {"drop": dict(drop=0.2, seed=11, resend_period=4),
                "delay": dict(delay=0.3, seed=12)}


@pytest.fixture(scope="module")
def fixture_shards():
    return ref.fixture_shards()


def _accept_case(name):
    """The matrix's graph ``name`` and its sources (the draws of
    ``default_rng(5)`` in graph order)."""
    rng = np.random.default_rng(5)
    for gname, (fn, kw) in ACCEPT_GRAPHS.items():
        g = getattr(jg, fn)(**kw)
        srcs = sorted(int(s) for s in
                      rng.choice(g.n_vertices, size=3, replace=False))
        if gname == name:
            return g, srcs


@pytest.mark.parametrize("name", sorted(ACCEPT_GRAPHS))
def test_acceptance_matrix_clean_matches_reference(name):
    """The reference's acceptance matrix without faults: its sources, P=8,
    no triangles, no online pruning."""
    g, srcs = _accept_case(name)
    sj = jc.build_shards(g, 8, enumerate_triangles=False)
    st = ref.port_shards(sj)
    base = tc.SsspEngine.build(st, tc.SsspConfig(prune_online=False),
                               device="cpu").solve(srcs)
    refs = np.stack([jg.dijkstra_reference(g, s) for s in srcs])
    np.testing.assert_allclose(base.dist, refs, rtol=1e-5, atol=1e-4)
    for rnd in ("staged", "fused"):
        rt, _ = ref.solve_both(sj, st, srcs, round=rnd, exchange="async",
                               toka="toka3", prune_online=False)
        np.testing.assert_array_equal(rt.dist, base.dist)
    rt, rj = ref.solve_both(sj, st, srcs, exchange="async_ppermute",
                            prune_online=False)
    np.testing.assert_array_equal(rt.dist, base.dist)
    assert int(rt.stats.overlap_rounds) == int(rj.stats.overlap_rounds)
    if name == "graph2-like":
        # the reference's matrix asserts > 0 here; JAX reads 0, and so
        # does the port (ROADMAP Queue 3's caveat)
        assert int(rt.stats.overlap_rounds) == 0


@pytest.mark.parametrize("plan", sorted(ACCEPT_PLANS))
@pytest.mark.parametrize("name", sorted(ACCEPT_GRAPHS))
def test_acceptance_matrix_faulted_matches_reference(name, plan):
    """The faulted half of the matrix: ``async`` with toka3 under its drop
    plan (with resend) and its delay plan, staged and fused, each == the
    JAX engine in every counter and == the bucket baseline in
    distances."""
    g, srcs = _accept_case(name)
    sj = jc.build_shards(g, 8, enumerate_triangles=False)
    st = ref.port_shards(sj)
    base = tc.SsspEngine.build(st, tc.SsspConfig(prune_online=False),
                               device="cpu").solve(srcs)
    for rnd in ("staged", "fused"):
        rt, _ = ref.solve_faulted(sj, st, srcs, ACCEPT_PLANS[plan],
                                  round=rnd, exchange="async", toka="toka3",
                                  prune_online=False)
        np.testing.assert_array_equal(rt.dist, base.dist)
        assert rt.status == "converged"


@pytest.mark.parametrize("exchange", ["a2a_dense", "async",
                                      "async_ppermute"])
def test_kernel_backends_match_reference(fixture_shards, exchange):
    """All-kernel staged: the relax, send and merge kernels' plain versions
    (JAX: the Pallas kernels in interpret mode) under a dense and the
    deferred exchanges."""
    sj, st, _ = fixture_shards
    ref.solve_both(sj, st, ref.SOURCES, exchange=exchange, pallas_sweeps=2,
                   **ALL_KERNELS)


@pytest.mark.parametrize("cfg", [
    dict(ALL_KERNELS, exchange="async_ppermute"),
    dict(round="fused", exchange="pmin", pallas_sweeps=2),
    dict(round="fused", exchange="async", toka="toka2")],
    ids=["staged-async_ppermute", "fused-pmin", "fused-async-toka2"])
def test_ragged_layout_matches_reference(cfg):
    """Ragged layouts (kernels 2, 4, 6; kernel 8 with bucketed and dense
    incoming rows) under the new exchanges."""
    g = jg.rmat_graph(scale=7, edge_factor=8, seed=3)
    sj = jc.build_shards(g, 3, layout="ragged", **TILE)
    ref.solve_both(sj, ref.port_shards(sj), [1, 9, 40], **cfg)


@pytest.mark.parametrize("exchange,rnd", [("async", "staged"),
                                          ("async_ppermute", "fused")])
def test_max_rounds_exit_flushes_in_flight(fixture_shards, exchange, rnd):
    """A ``max_rounds`` exit with payload still in flight: the finalize
    merges every buffered batch (and the fused round's undelivered
    incoming), as the reference's does."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_both(sj, st, [0, 7], exchange=exchange, round=rnd,
                           max_rounds=3)
    assert rt.status == "max_rounds"
