"""The PyTorch port's engine against the JAX package's, end to end.

Both packages solve identical shards (the JAX shards read out through
``shards_from_arrays``) under one config dict; distances must be
bit-identical and every counter and ``status`` equal, on the all-kernel
staged config and the default config, for K in {1, 3} (3 rides a padded
bucket of 4) and P in {1, 4, 8}. The tolerance is zero: both sides do the
same single fp32 adds and exact mins in the same order.

At many queries: K = 300 sources ride the bucket of 512, which the card's
kernels 3-6 split into query groups (their tiles of minima for 512
queries do not fit in shared memory a block). On the CPU the kernels'
plain versions run, so this holds the engine's batch of 512 rows against
the JAX engine's: the all-kernel staged config and the fused round on the
R-MAT graph (scale 8, 193 vertices with an out-edge, so the 300 sources
repeat some), P = 4. The card's group split itself is held against the
plain versions by ``test_torch_gpu.py``.
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

ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas", round="staged", exchange="bucket",
                   toka="toka0")
CONFIGS = {"all-kernel": ALL_KERNELS, "default": {}}
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "n_dispatches", "bytes_moved", "stale_merges", "resends")
GRAPHS = {"rmat": ("rmat_graph", dict(scale=8, edge_factor=4, seed=1)),
          "road": ("road_grid_graph", dict(side=10, seed=2))}


def _live_sources(g, k, seed):
    rng = np.random.default_rng(seed)
    deg = np.diff(np.asarray(g.row_ptr))
    return [int(s) for s in rng.choice(np.nonzero(deg)[0], k, replace=False)]


@pytest.fixture(scope="module")
def jax_graphs():
    return {name: getattr(jg, fn)(**kw) for name, (fn, kw) in GRAPHS.items()}


@pytest.fixture(scope="module")
def jax_shards(jax_graphs):
    cache = {}

    def get(name, P):
        if (name, P) not in cache:
            cache[name, P] = jc.build_shards(jax_graphs[name], P)
        return cache[name, P]
    return get


def _port_shards(sj):
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return tc.shards_from_arrays(fields, **static)


def assert_results_equal(rt, rj):
    np.testing.assert_array_equal(rt.dist, np.asarray(rj.dist))
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(rt.stats, f)),
                                      np.asarray(getattr(rj.stats, f)),
                                      err_msg=f)
    assert rt.status == rj.status
    assert rt.bucket_k == rj.bucket_k


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_matches_reference(jax_graphs, jax_shards, config, P, nq):
    sj = jax_shards("rmat", P)
    srcs = _live_sources(jax_graphs["rmat"], nq, seed=P)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**CONFIGS[config])).solve(srcs)
    rt = tc.SsspEngine.build(_port_shards(sj),
                             tc.SsspConfig(**CONFIGS[config]),
                             device="cpu").solve(srcs)
    assert rj.status == "converged"
    assert_results_equal(rt, rj)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_engine_matches_reference_on_road_grid(jax_graphs, jax_shards,
                                               config):
    sj = jax_shards("road", 4)
    srcs = _live_sources(jax_graphs["road"], 3, seed=9)
    cfg = dict(CONFIGS[config], pallas_sweeps=2, tri_chunk=16)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(_port_shards(sj), tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert_results_equal(rt, rj)


@pytest.mark.parametrize("config", ["all-kernel", "fused"])
def test_engine_matches_reference_at_300_queries(jax_graphs, jax_shards,
                                                 config):
    sj = jax_shards("rmat", 4)
    deg = np.diff(np.asarray(jax_graphs["rmat"].row_ptr))
    srcs = [int(s) for s in np.random.default_rng(0).choice(
        np.nonzero(deg)[0], 300)]
    cfg = {"all-kernel": ALL_KERNELS, "fused": dict(round="fused")}[config]
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(_port_shards(sj), tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert rj.status == "converged" and rj.bucket_k == rt.bucket_k == 512
    assert_results_equal(rt, rj)


def test_own_build_solves_like_dijkstra():
    g = tg.rmat_graph(scale=9, edge_factor=4, seed=5)
    srcs = _live_sources(g, 3, seed=1)
    eng = tc.SsspEngine.build(g, tc.SsspConfig(**ALL_KERNELS), n_parts=4,
                              device="cpu")
    res = eng.solve(srcs)
    assert res.status == "converged" and res.q_converged.all()
    for i, s in enumerate(srcs):
        np.testing.assert_allclose(res.dist[i], tg.dijkstra_reference(g, s),
                                   rtol=1e-5, atol=1e-4)
    # a padded bucket gives the bit-identical answer of the exact batch
    exact = eng.solve(srcs, bucket=False)
    assert (res.bucket_k, exact.bucket_k) == (4, 3)
    np.testing.assert_array_equal(res.dist, exact.dist)
    np.testing.assert_array_equal(res.q_relaxations, exact.q_relaxations)


def test_solve_totals_wrap_in_int32():
    """The solve's totals are int32 sums that wrap past 2**31 - 1, as the
    reference's ``np.sum(..., dtype=np.int32)``, and never raise. The carry
    is made by hand: after each real round its per-(shard, query) counters
    are set to 2**29 + i, so each total passes 2**31 on 4 shards."""
    g = tg.road_grid_graph(10, seed=2)
    eng = tc.SsspEngine.build(g, tc.SsspConfig(), n_parts=4, device="cpu")
    real = eng.round_fn
    big = torch.tensor([[2**29], [2**29 + 1], [2**29 + 2], [2**29 + 3]],
                       dtype=torch.int32)

    def round_fn(carry):
        carry = real(carry)
        return carry._replace(relaxations=big.clone(), msgs_sent=big + 5,
                              msgs_recv=big + 7)

    eng.round_fn = round_fn
    res = eng.solve([0], bucket=False)
    for field, add in (("relaxations", 0), ("msgs_sent", 5),
                       ("msgs_recv", 7)):
        want = np.sum((big + add).numpy(), dtype=np.int32)
        assert want < 0                     # 4 * 2**29 + ... wrapped
        got = getattr(res.stats, field)
        assert got == want and got.dtype == np.int32, field
    np.testing.assert_array_equal(res.q_relaxations,
                                  np.sum(big.numpy(), 0, dtype=np.int32))


def test_max_rounds_status():
    g = tg.road_grid_graph(10, seed=2)
    eng = tc.SsspEngine.build(g, tc.SsspConfig(max_rounds=2), n_parts=4,
                              device="cpu")
    res = eng.solve([0])
    assert res.status == "max_rounds" and int(res.stats.rounds) == 2


def test_offline_pruning_matches_reference(jax_graphs, jax_shards):
    sj = jax_shards("rmat", 4)
    srcs = _live_sources(jax_graphs["rmat"], 2, seed=3)
    cfg = dict(ALL_KERNELS, prune_offline_passes=2, prune_online=False)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(_port_shards(sj), tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert_results_equal(rt, rj)


@pytest.mark.parametrize("field,value", [
    ("exchange", "a2a_dense"), ("exchange", "pmin"), ("exchange", "async"),
    ("toka", "toka2"), ("toka", "toka3"), ("exchange", "async_bucket"),
    ("exchange", "async_ppermute"), ("faults", object())])
def test_config_values_not_ported_raise(jax_graphs, jax_shards, field,
                                        value):
    """The exchanges and detectors that once raised here are ported: each
    builds and solves like the JAX package (all-kernel staged, R-MAT, P=4,
    K=3). Fault injection is ported too: a ``faults`` value that is not a
    ``FaultPlan`` raises ``TypeError``, as in the reference."""
    if field == "faults":
        with pytest.raises(TypeError, match="FaultPlan"):
            tc.SsspConfig(faults=value)
        with pytest.raises(TypeError, match="FaultPlan"):
            jc.SsspConfig(faults=value)
        return
    cfg = dict(ALL_KERNELS, **{field: value})
    sj = jax_shards("rmat", 4)
    srcs = _live_sources(jax_graphs["rmat"], 3, seed=11)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(_port_shards(sj), tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert rj.status == "converged"
    assert_results_equal(rt, rj)
    assert rt.stats.overlap_rounds == rj.stats.overlap_rounds


@pytest.mark.parametrize("field", ["round", "exchange", "toka",
                                   "local_solver", "send_backend",
                                   "merge_backend", "warm_start"])
def test_config_rejects_unknown_names(field):
    with pytest.raises(ValueError, match="valid"):
        tc.SsspConfig(**{field: "nope"})


def test_config_accepts_interpret_flag():
    assert tc.SsspConfig(pallas_interpret=False, **ALL_KERNELS)


def test_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = tg.road_grid_graph(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.SsspEngine.build(g, n_parts=2)


def test_engine_rejects_bad_requests():
    g = tg.road_grid_graph(4)
    # the shmap backend is ported; without its mesh it is a bad request
    with pytest.raises(ValueError, match="requires mesh and axis_names"):
        tc.SsspEngine.build(g, backend="shmap", n_parts=2, device="cpu")
    eng = tc.SsspEngine.build(g, n_parts=2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        eng.solve([16])
    assert tc.bucket_k(3) == 4 and tc.bucket_k(4) == 4
    with pytest.raises(ValueError):
        tc.bucket_k(0)
