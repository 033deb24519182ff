"""The port's warm start (landmark seeds, the result LRU, epoch
invalidation) against the JAX package's.

Both packages run on the same shards (the JAX shards read out through
``shards_from_arrays``), the default and the all-kernel staged configs, P
in {1, 4}, on R-MAT and road-grid graphs. Tolerance zero: the seed is one
float32 add, one float32 multiply by ``WARM_EPS`` where the landmark leg
is nonzero, and exact mins, on both sides; warm solves equal JAX's warm
solves in distances and every counter (``warm_started`` included), and
the cold solves bit for bit.
"""
import dataclasses

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro.core.warmstart import landmark_seed_stacked as jax_seed  # noqa: E402
from repro_torch.core.warmstart import WARM_EPS, landmark_seed_stacked  # noqa: E402

ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas")
CONFIGS = {"all-kernel": ALL_KERNELS, "default": {}}
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "n_dispatches", "bytes_moved", "stale_merges", "resends")
GRAPHS = {"rmat": ("rmat_graph", dict(scale=8, edge_factor=4, seed=1)),
          "road": ("road_grid_graph", dict(side=10, seed=2))}
LANDMARKS = [0, 37, 90]


def _port_shards(sj):
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return tc.shards_from_arrays(fields, **static)


def _live_sources(g, k, seed):
    rng = np.random.default_rng(seed)
    deg = np.diff(np.asarray(g.row_ptr))
    return [int(s) for s in rng.choice(np.nonzero(deg)[0], k, replace=False)]


def assert_results_equal(rt, rj):
    np.testing.assert_array_equal(rt.dist, np.asarray(rj.dist))
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(rt.stats, f)),
                                      np.asarray(getattr(rj.stats, f)),
                                      err_msg=f)
    for f in ("status", "bucket_k", "warm_started", "cache_hits"):
        assert getattr(rt, f) == getattr(rj, f), f


@pytest.fixture(scope="module")
def graphs():
    return {name: getattr(jg, fn)(**kw) for name, (fn, kw) in GRAPHS.items()}


@pytest.fixture(scope="module")
def pair(graphs):
    """(JAX shards, port shards) by (graph, P), built once."""
    cache = {}

    def get(name, P):
        if (name, P) not in cache:
            sj = jc.build_shards(graphs[name], P)
            cache[name, P] = (sj, _port_shards(sj))
        return cache[name, P]
    return get


def _engines(pair, name, P, cfg, **kw):
    """JAX and port engines over the same shards, both landmark-warm."""
    sj, st = pair(name, P)
    cfg = dict(cfg, warm_start="landmark")
    ej = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg), **kw)
    et = tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu", **kw)
    return ej, et


# ------------------------------------------------- registry and layout ----

def test_warm_start_validated_eagerly():
    assert tc.phases.backends("warm_init") == ("landmark", "none")
    assert (tc.phases.backends("warm_init")
            == jc.phases.backends("warm_init"))
    with pytest.raises(ValueError, match="warm_init"):
        tc.SsspConfig(warm_start="bogus")
    assert tc.SsspConfig().warm_start == "none"
    assert tc.SsspConfig(warm_start="landmark").warm_start == "landmark"


def test_shard_distance_rows_matches_reference():
    rows = np.arange(6, dtype=np.float32).reshape(2, 3)   # L=2, n=3
    land = tc.shard_distance_rows(rows, n_parts=2, block=2)
    assert land.shape == (2, 2, 2) and land.dtype == torch.float32
    assert land[0, 0].tolist() == [0.0, 1.0]
    assert land[1, 0, 0] == 2.0 and torch.isinf(land[1, 0, 1])  # padding
    assert land[1, 1, 0] == 5.0
    rng = np.random.default_rng(3)
    rows = np.where(rng.random((5, 37)) < 0.2, np.inf,
                    rng.uniform(0, 50, (5, 37))).astype(np.float32)
    for P, block in ((1, 37), (4, 10), (8, 5)):
        want = np.asarray(jc.shard_distance_rows(rows, P, block))
        got = tc.shard_distance_rows(rows, P, block, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- the seed ----

def test_warm_eps_is_the_float32_of_the_reference():
    assert WARM_EPS.dtype == torch.float32
    assert WARM_EPS.item() == float(np.float32(1.0 + 1e-4))


@pytest.mark.parametrize("case", ["eps-applied", "eps-skipped"])
@pytest.mark.parametrize("P", [1, 4])
def test_landmark_seed_matches_reference(case, P):
    """The seed bit for bit, on random rows with +inf entries: with every
    landmark leg nonzero (``WARM_EPS`` applied everywhere) and with
    sources that are landmarks (a zero leg, the multiply skipped)."""
    rng = np.random.default_rng(P)
    L, block, K = 5, 23, 6
    land = np.where(rng.random((P, L, block)) < 0.15, np.inf,
                    rng.uniform(0.5, 40, (P, L, block))).astype(np.float32)
    flat = land.transpose(1, 0, 2).reshape(L, -1)
    if case == "eps-skipped":
        # source k is landmark k % L: a zero at its own vertex
        srcs = rng.choice(P * block, K, replace=False)
        for k, s in enumerate(srcs):
            flat[k % L, s] = 0.0
        land = flat.reshape(L, P, block).transpose(1, 0, 2).copy()
    else:
        srcs = rng.choice(P * block, K, replace=False)
        assert (flat[:, srcs] != 0).all()
    srcs = srcs.astype(np.int32)
    q_valid = np.array([1, 1, 1, 1, 0, 1], bool)
    want = np.asarray(jax_seed(jnp.asarray(land), jnp.asarray(srcs),
                               jnp.asarray(q_valid)))
    got = landmark_seed_stacked(torch.from_numpy(land),
                                torch.from_numpy(srcs),
                                torch.from_numpy(q_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isinf(want[:, 4]).all()            # the padded query
    if case == "eps-skipped":
        # a zero leg keeps the pivot's row exactly
        k0, l0 = 0, 0
        exact = land[:, l0]
        assert (want[:, k0] <= exact).all()


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("graph", ["rmat", "road"])
def test_landmark_cache_matches_reference(pair, graph, P):
    ej, et = _engines(pair, graph, P, {})
    lj, lt = ej.precompute_landmarks(LANDMARKS), et.precompute_landmarks(
        LANDMARKS)
    assert isinstance(lt, tc.LandmarkCache)
    np.testing.assert_array_equal(lt.dist.numpy(), np.asarray(lj.dist))
    assert (lt.sources, lt.epoch, lt.n_landmarks, lt.nbytes_per_shard) == (
        lj.sources, lj.epoch, lj.n_landmarks, lj.nbytes_per_shard)
    assert lt.nbytes_per_shard == 4 * len(LANDMARKS) * et.shards.block
    # the seeds the solves take, with the landmarks among the sources
    srcs = np.array([LANDMARKS[1], 3, 17, LANDMARKS[0]], np.int32)
    q_valid = np.ones(4, bool)
    np.testing.assert_array_equal(
        landmark_seed_stacked(lt.dist, torch.from_numpy(srcs),
                              torch.from_numpy(q_valid)).numpy(),
        np.asarray(jax_seed(lj.dist, jnp.asarray(srcs),
                            jnp.asarray(q_valid))))
    with pytest.raises(ValueError, match="at least one landmark"):
        et.precompute_landmarks([])


# ------------------------------------------------------- warm solves ----

@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("graph", ["rmat", "road"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_warm_matches_reference_and_cold(graphs, pair, config, graph, P):
    """Warm solves equal JAX's warm solves (distances and every counter,
    ``warm_started`` included) for K in {1, 3}, and the cold solves'
    distances bit for bit."""
    ej, et = _engines(pair, graph, P, CONFIGS[config])
    ej.precompute_landmarks(LANDMARKS)
    et.precompute_landmarks(LANDMARKS)
    cold = tc.SsspEngine.build(pair(graph, P)[1],
                               tc.SsspConfig(**CONFIGS[config]),
                               device="cpu")
    for k, seed in ((1, P), (3, P + 10)):
        srcs = _live_sources(graphs[graph], k, seed)
        rt, rj = et.solve(srcs), ej.solve(srcs)
        assert rt.warm_started and rt.status == "converged"
        assert_results_equal(rt, rj)
        rc = cold.solve(srcs)
        assert not rc.warm_started
        np.testing.assert_array_equal(rt.dist, rc.dist)


@pytest.mark.parametrize("graph", ["rmat", "road"])
def test_fused_warm_matches_reference(graphs, pair, graph):
    """The fused round from the warm start (``front_any`` from the seeded
    frontier) equals JAX's fused warm solve and the staged cold one."""
    ej, et = _engines(pair, graph, 4, dict(round="fused", pallas_sweeps=2))
    ej.precompute_landmarks(LANDMARKS)
    et.precompute_landmarks(LANDMARKS)
    srcs = _live_sources(graphs[graph], 3, 5)
    rt = et.solve(srcs)
    assert_results_equal(rt, ej.solve(srcs))
    cold = tc.SsspEngine.build(pair(graph, 4)[1], tc.SsspConfig(),
                               device="cpu").solve(srcs)
    np.testing.assert_array_equal(rt.dist, cold.dist)


def test_repeated_source_converges_in_fewer_rounds():
    """A repeated pivot's seed IS its solved row: the warm solve confirms
    it in at most 2 rounds (reference ``test_warmstart.py:117-131``), the
    same rounds as JAX's."""
    g = jg.road_grid_graph(side=24, seed=2)
    sj = jc.build_shards(g, 8, enumerate_triangles=False)
    st = _port_shards(sj)
    cfg = dict(prune_online=False)
    rc = tc.SsspEngine.build(st, tc.SsspConfig(**cfg),
                             device="cpu").solve([287])
    warm = tc.SsspEngine.build(st, tc.SsspConfig(warm_start="landmark",
                                                 **cfg), device="cpu")
    warm.precompute_landmarks([0, 287])
    rw = warm.solve([287])
    np.testing.assert_array_equal(rc.dist, rw.dist)
    assert int(rw.q_rounds[0]) < int(rc.q_rounds[0])
    assert int(rw.q_rounds[0]) <= 2
    jw = jc.SsspEngine.build(sj, jc.SsspConfig(warm_start="landmark", **cfg))
    jw.precompute_landmarks([0, 287])
    assert_results_equal(rw, jw.solve([287]))


def test_warm_without_landmarks_stays_cold(pair):
    ej, et = _engines(pair, "rmat", 4, {})
    rt = et.solve([3])
    assert not rt.warm_started
    assert_results_equal(rt, ej.solve([3]))


# ------------------------------------------------------ result cache ----

def test_result_cache_lru_semantics():
    lru = tc.ResultCache(2)
    row = tc.CachedRow(np.zeros(3, np.float32))
    assert lru.get(1, 0) is None and lru.misses == 1
    lru.put(1, 0, row)
    lru.put(2, 0, row)
    assert lru.get(1, 0) is row and lru.hits == 1
    lru.put(3, 0, row)               # evicts 2 (LRU), keeps refreshed 1
    assert lru.get(2, 0) is None
    assert lru.get(1, 0) is row and lru.get(3, 0) is row
    assert len(lru) == 2
    assert lru.get(1, 1) is None     # the epoch is part of the key
    off = tc.ResultCache(0)
    off.put(1, 0, row)
    assert off.get(1, 0) is None and len(off) == 0
    # the same sequence on the reference's LRU
    ref = jc.ResultCache(2)
    for op in (("put", 1), ("put", 2), ("get", 1), ("put", 3), ("get", 2)):
        getattr(ref, op[0])(*((op[1], 0, row) if op[0] == "put"
                              else (op[1], 0)))
    assert (ref.hits, ref.misses, len(ref)) == (1, 1, 2)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_cache_hits_and_stripping_match_reference(graphs, pair, config):
    """Exact repeats: zero rounds, ``bucket_k == 0``, the stored rows. A
    mixed batch strips cached sources (and duplicates) before padding and
    rides the remainder's bucket. Every result equals JAX's."""
    sj, st = pair("rmat", 4)
    cfg = dict(CONFIGS[config], prune_online=False)
    ej = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg), result_cache=8)
    et = tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu",
                             result_cache=8)
    src = _live_sources(graphs["rmat"], 7, 7)
    batches = (src[:3], src[:3], [src[0], src[3], src[1], src[2], src[4]],
               [src[3], src[3], src[3]])
    for i, b in enumerate(batches):
        rt, rj = et.solve(b), ej.solve(b)
        assert_results_equal(rt, rj)
        assert rt.compiled == rj.compiled, i
    assert (et.batches_served, et.queries_served) == (
        ej.batches_served, ej.queries_served)
    hit = et.solve(src[:3])
    assert hit.cache_hits == 3 and hit.bucket_k == 0
    assert int(hit.stats.rounds) == 0 and (hit.q_rounds == 0).all()
    assert not hit.compiled and hit.compile_s == 0.0
    mixed = et.solve([src[0], src[5], src[1], src[2], src[6]])
    assert mixed.cache_hits == 3 and mixed.bucket_k == 2
    assert mixed.q_rounds[0] == 0 and mixed.q_rounds[1] > 0
    dup = tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu",
                              result_cache=8).solve([5, 5, 5])
    assert dup.bucket_k == 1
    np.testing.assert_array_equal(dup.dist[0], dup.dist[2])


def test_cache_off_is_the_uncached_path(pair):
    _, st = pair("rmat", 4)
    eng = tc.SsspEngine.build(st, tc.SsspConfig(prune_online=False),
                              device="cpu")
    a, b = eng.solve([3]), eng.solve([3])
    assert b.cache_hits == 0 and int(b.stats.rounds) > 0
    np.testing.assert_array_equal(a.dist, b.dist)
    assert len(eng.result_cache) == 0


def test_only_certified_rows_are_cached(pair):
    """A ``max_rounds`` row is an upper bound: it must not enter the LRU
    (the next call re-solves it), as in the reference."""
    sj, st = pair("road", 4)
    cfg = dict(max_rounds=2)
    et = tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu",
                             result_cache=4)
    ej = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg), result_cache=4)
    for _ in range(2):
        rt, rj = et.solve([0]), ej.solve([0])
        assert rt.status == "max_rounds" and rt.cache_hits == 0
        assert_results_equal(rt, rj)
    assert len(et.result_cache) == 0


# -------------------------------------------------------- invalidation ----

def test_epoch_invalidation_orphans_both_caches(pair):
    ej, et = _engines(pair, "rmat", 4, {}, result_cache=8)
    for e in (ej, et):
        e.precompute_landmarks(LANDMARKS)
    seq = []
    for e in (et, ej):
        e.solve([3])
        hit = e.solve([3])
        epoch = e.invalidate_caches()
        miss = e.solve([3])
        e.precompute_landmarks(LANDMARKS)
        again = e.solve([9])
        seq.append((hit, epoch, miss, again, e.landmarks.epoch))
    (ht, et_, mt, at, lt), (hj, ej_, mj, aj, lj) = seq
    assert ht.cache_hits == 1 and et_ == ej_ == 1 and lt == lj == 1
    assert mt.cache_hits == 0 and not mt.warm_started and at.warm_started
    for a, b in ((ht, hj), (mt, mj), (at, aj)):
        assert_results_equal(a, b)


def test_precompute_rejects_asymmetric_distances():
    g = jg.random_graph(n=120, m=600, seed=3, undirected=False)
    sj = jc.build_shards(g, 4, enumerate_triangles=False)
    et = tc.SsspEngine.build(_port_shards(sj),
                             tc.SsspConfig(warm_start="landmark"),
                             device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        et.precompute_landmarks([0, 5, 9])
    assert et.landmarks is None


def test_precompute_rejects_unconverged_pivots(pair):
    _, st = pair("road", 4)
    et = tc.SsspEngine.build(st, tc.SsspConfig(warm_start="landmark",
                                               max_rounds=2), device="cpu")
    with pytest.raises(ValueError, match="did not converge"):
        et.precompute_landmarks([0, 37])
