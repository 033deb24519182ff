"""The port's multi-process backend (``backend="shmap"``, 4 gloo ranks on
the CPU) against its sim backend, tolerance zero, beyond the exchange x
round x detector matrix of test_torch_dist_solve.py: the local solvers,
the hand-kernel backends on dense and ragged shards, fault injection with
anti-entropy resend, the landmark warm start, ``certify=False``, a
``max_rounds`` exit, ``submit``/``drain`` with the result LRU, and the
legacy wrappers. One start of the ranks runs every scenario; each case
is one comparison of every rank's result with the sim engine's.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as ref  # noqa: E402

AK = ref.ALL_KERNELS
DROP = dict(drop=0.2, seed=0, resend_period=4)
SCENARIOS = {
    "delta": dict(cfg=dict(local_solver="delta")),
    "pallas-solver": dict(cfg=dict(local_solver="pallas", pallas_sweeps=2)),
    "all-kernels-bucket": dict(cfg=dict(AK, pallas_sweeps=2)),
    "all-kernels-pmin-toka2": dict(cfg=dict(AK, exchange="pmin",
                                            toka="toka2")),
    "all-kernels-async-toka3": dict(cfg=dict(AK, exchange="async",
                                             toka="toka3")),
    "fused-sweeps2": dict(cfg=dict(round="fused", pallas_sweeps=2)),
    "ragged-all-kernels": dict(shards="ragged", cfg=dict(AK),
                               sources=[1, 9, 40]),
    "ragged-fused-ppermute": dict(shards="ragged", sources=[1, 9, 40],
                                  cfg=dict(round="fused",
                                           exchange="async_ppermute",
                                           pallas_sweeps=2)),
    "ragged-a2a-toka1": dict(shards="ragged", sources=[1, 9, 40],
                             cfg=dict(AK, exchange="a2a_dense",
                                      toka="toka1")),
    "faults-bucket-toka3": dict(shards="faults",
                                cfg=dict(faults=DROP, toka="toka3")),
    "faults-async-toka3": dict(shards="faults",
                               cfg=dict(faults=DROP, exchange="async",
                                        toka="toka3")),
    "faults-fused-toka3": dict(shards="faults",
                               cfg=dict(faults=DROP, round="fused",
                                        toka="toka3")),
    "faults-delay-dup": dict(shards="faults",
                             cfg=dict(faults=dict(delay=0.2, duplicate=0.1,
                                                  reorder=0.1, seed=1))),
    "faults-degraded": dict(shards="faults",
                            cfg=dict(faults=dict(drop=0.6, seed=2))),
    "warm-staged": dict(op="warm", landmarks=[3, 60, 120],
                        cfg=dict(warm_start="landmark")),
    "warm-fused": dict(op="warm", landmarks=[3, 60, 120],
                       cfg=dict(warm_start="landmark", round="fused")),
    "no-certify": dict(cfg=dict(exchange="async", toka="toka1"),
                       engine=dict(certify=False)),
    "max-rounds-2": dict(cfg=dict(max_rounds=2, exchange="async")),
    "drain-lru": dict(op="drain", sources=[5, [8, 13], 5, 20, [21, 22, 23]],
                      repeat=[5, 8, 30], cfg=dict(),
                      engine=dict(max_bucket=4, result_cache=8)),
}


WRAP_CFG = dict(exchange="async", toka="toka2")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return ref.run_ranks(
        ref.rank_scenarios_and_wrappers,
        tmp_path_factory.mktemp("dist_engine"), list(SCENARIOS.values()),
        WRAP_CFG, ref.SOURCES, world=4,
        meanwhile=lambda: [ref.sim_scenario(sc) for sc in SCENARIOS.values()])


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_shmap_matches_sim(ranks, name):
    per_ranks, sims = ranks
    i = list(SCENARIOS).index(name)
    want = sims[i]
    for per_rank, _ in per_ranks:
        ref.assert_same_scenario(per_rank[i], want)
    if name == "max-rounds-2":
        assert want["results"][0]["status"] == "max_rounds"
    if name == "faults-degraded":
        assert want["results"][0]["status"] == "degraded"
    if name.startswith("warm"):
        assert all(r["warm_started"] for r in want["results"])
    if name == "drain-lru":
        assert want["results"][-1]["cache_hits"] == 2


def test_legacy_wrappers_match_sim(ranks):
    """``solve_shmap`` and ``solve_shmap_batch`` equal ``solve_sim`` and
    ``solve_sim_batch``; a ``build_shmap_solver`` handle gives each rank
    its own shard's rows of the unpadded sim solve and the same counters;
    all three ride one cached engine (``engine_for``)."""
    import repro_torch.core as tc
    per_ranks, _ = ranks
    sh, cfg = ref.shards("fixture"), ref.make_config(WRAP_CFG)
    one = tc.solve_sim(sh, ref.SOURCES[0], cfg, device="cpu")
    batch = tc.solve_sim_batch(sh, ref.SOURCES, cfg, device="cpu")
    exact = tc.SsspEngine.build(sh, cfg, device="cpu").solve(ref.SOURCES,
                                                            bucket=False)
    for _, got in per_ranks:
        ref.assert_same_result(got["one"], one)
        ref.assert_same_result(got["batch"], batch)
        dist_loc, stats = got["handle"]
        lo = got["rank"] * sh.block
        hi = min(lo + sh.block, sh.n_vertices)
        np.testing.assert_array_equal(dist_loc[0][:, :hi - lo],
                                      exact.dist[:, lo:hi])
        ref.assert_same_result((exact.dist, stats), (exact.dist, exact.stats))
        assert got["reused"] and got["same_engine"]
