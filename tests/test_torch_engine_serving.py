"""The port's serving surface against the JAX package's engine: bucket
reuse ("traces"), ``warmup``, ``submit``/``drain``, ``engine_for`` and the
legacy wrappers, ``certify=False``, and the ``delta`` local solver and
``toka1`` termination.

Both packages run on the same shards (the JAX shards read out through
``shards_from_arrays``). Tolerance zero: distances and every counter,
``status`` and ``q_converged`` equal JAX's; the bucket accounting
(``trace_counts``, ``compiled``, ``bucket_k``, batches and queries served)
follows the same sequence as the reference's, mirroring
``tests/test_engine.py``.
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
from repro_torch.core import engine as engine_mod  # noqa: E402

COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "n_dispatches", "bytes_moved", "stale_merges", "resends")
ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas")


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
    for f in ("status", "bucket_k", "sources", "cache_hits",
              "warm_started", "compiled"):
        assert getattr(rt, f) == getattr(rj, f), f


@pytest.fixture(scope="module")
def shards():
    """The reference's engine-test graph (random, 180 vertices, 700
    edges, P=5): (graph, JAX shards, port shards)."""
    g = jg.random_graph(n=180, m=700, seed=21)
    sj = jc.build_shards(g, 5)
    return g, sj, _port_shards(sj)


def _pair(shards, cfg=None, **kw):
    _, sj, st = shards
    cfg = cfg or {}
    return (jc.SsspEngine.build(sj, jc.SsspConfig(**cfg), **kw),
            tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu",
                                **kw))


# ------------------------------------------------------- bucket reuse ----

def test_trace_reuse_same_bucket_matches_reference(shards):
    """Two source sets in one bucket run it once; a new bucket once more
    (reference ``test_engine.py:67-82``)."""
    ej, et = _pair(shards)
    for srcs, want in (([3, 17, 99], {4: 1}), ([120, 5, 66, 8], {4: 1}),
                       ([12], {4: 1, 1: 1})):
        rt, rj = et.solve(srcs), ej.solve(srcs)
        assert_results_equal(rt, rj)
        assert et.trace_counts == ej.trace_counts == want
        assert (rt.compile_s > 0) == rt.compiled
    assert et.trace_count == 2 and et.cert_traces == ej.cert_traces == 2
    assert rt.overlap_fraction == 0.0 == rj.overlap_fraction
    assert et.batches_served == ej.batches_served == 3
    assert et.queries_served == ej.queries_served == 8


def test_padded_bucket_bitmatches_unpadded(shards):
    _, sj, st = shards
    cfg = dict(prune_online=False)
    ej, et = _pair(shards, cfg)
    padded, exact = et.solve([3, 17, 99]), et.solve([3, 17, 99],
                                                    bucket=False)
    assert (padded.bucket_k, exact.bucket_k) == (4, 3)
    for f in ("dist", "q_rounds", "q_relaxations"):
        np.testing.assert_array_equal(getattr(padded, f), getattr(exact, f))
    assert_results_equal(exact, ej.solve([3, 17, 99], bucket=False))
    d, st_ = tc.solve_sim_batch(st, [3, 17, 99], tc.SsspConfig(**cfg),
                                device="cpu")
    np.testing.assert_array_equal(d, padded.dist)
    np.testing.assert_array_equal(np.asarray(st_.q_rounds), padded.q_rounds)


def test_query_result_structure(shards):
    g, _, st = shards
    eng = tc.SsspEngine.build(st, device="cpu")
    res = eng.solve([7, 11])
    assert isinstance(res, tc.QueryResult)
    assert res.sources == (7, 11) and res.backend == "sim"
    assert res.device == "cpu" and res.dist.shape == (2, g.n_vertices)
    assert res.q_rounds.shape == (2,) and res.q_relaxations.shape == (2,)
    assert res.wall_s > 0 and res.compiled and res.compile_s > 0
    assert res.cache_hits == 0 and not res.warm_started
    warm = eng.solve([1, 2])
    assert warm.compile_s == 0.0 and not warm.compiled
    with pytest.raises(ValueError, match="out of range"):
        eng.solve([g.n_vertices])
    with pytest.raises(ValueError, match="at least one source"):
        eng.solve([])


def test_warmup_precompiles(shards):
    ej, et = _pair(shards)
    cold_s = et.warmup(3)
    ej.warmup(3)
    assert cold_s > 0 and et.trace_counts == ej.trace_counts == {4: 1}
    assert_results_equal(et.solve([9, 10, 11]), ej.solve([9, 10, 11]))
    served = et.batches_served
    assert et.warmup(4) == 0.0 and et.batches_served == served


def test_warmup_bypasses_result_cache(shards):
    ej, et = _pair(shards, dict(prune_online=False), result_cache=8)
    assert et.warmup(4) > 0
    ej.warmup(4)
    assert et.trace_counts == ej.trace_counts == {4: 1}
    assert_results_equal(et.solve([7, 8, 9]), ej.solve([7, 8, 9]))


def test_warmup_covers_the_seed(shards):
    """The warm seed is its own first run: a cold run of the bucket (the
    landmark precompute) leaves warmup() work to do, and then none
    (reference ``test_warmstart.py: test_warmup_covers_sim_seed_program``)."""
    ej, et = _pair(shards, dict(prune_online=False, warm_start="landmark"))
    for e in (ej, et):
        e.precompute_landmarks([0, 60])
    assert et.trace_counts == ej.trace_counts == {2: 1}
    assert et.warmup(2) > 0
    ej.warmup(2)
    assert et.trace_counts == ej.trace_counts == {2: 2}
    rt, rj = et.solve([7, 8]), ej.solve([7, 8])
    assert rt.warm_started and not rt.compiled
    assert_results_equal(rt, rj)
    assert et.warmup(2) == 0.0 == ej.warmup(2)
    # a new epoch drops the warm coverage but not the first runs
    et.invalidate_caches()
    ej.invalidate_caches()
    for e in (ej, et):
        e.precompute_landmarks([0, 60])
    assert et.warmup(2) == 0.0 and ej.warmup(2) == 0.0
    assert et.trace_counts == ej.trace_counts == {2: 2}


# ------------------------------------------------ legacy delegation ----

def test_wrappers_share_one_engine(shards):
    """solve_sim / solve_sim_batch ride one cached engine per (shards,
    cfg, device): new sources add no first run (reference
    ``test_engine.py:133-146``)."""
    _, sj, st = shards
    cfg = dict(tri_chunk=64)
    for pkg, sh, kw in ((jc, sj, {}), (tc, st, dict(device="cpu"))):
        c = pkg.SsspConfig(**cfg)
        d0, _ = pkg.solve_sim_batch(sh, [0, 1], c, **kw)
        eng = pkg.engine_for(sh, c, **kw)
        assert eng.trace_counts == {2: 1}
        pkg.solve_sim_batch(sh, [40, 41], c, **kw)
        d1, s1 = pkg.solve_sim(sh, 7, c, **kw)
        assert eng.trace_counts == {2: 1, 1: 1}
        pkg.solve_sim(sh, 8, c, **kw)
        assert eng.trace_counts == {2: 1, 1: 1}
        if pkg is jc:
            want = (np.asarray(d0), np.asarray(d1), s1)
    np.testing.assert_array_equal(d0, want[0])
    np.testing.assert_array_equal(d1, want[1])
    assert d1.shape == (st.n_vertices,)
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(s1, f)),
                                      np.asarray(getattr(want[2], f)))


def test_engine_for_reuses_across_calls(shards):
    """The engine holds ``shards.to(device)``, a new object, so the cache
    is keyed by the caller's shards: the same shards, config and device
    give the same engine, and its bucket accounting survives the calls."""
    _, _, st = shards
    cfg = tc.SsspConfig(tri_chunk=32)
    a = tc.engine_for(st, cfg, device="cpu")
    assert a.shards is not st
    assert tc.engine_for(st, cfg, device="cpu") is a
    assert tc.engine_for(st, tc.SsspConfig(tri_chunk=32), device="cpu") is a
    a.solve([3])
    assert tc.engine_for(st, cfg, device="cpu").trace_counts == {1: 1}
    copy = dataclasses.replace(st)
    assert tc.engine_for(copy, cfg, device="cpu") is not a
    assert tc.engine_for(st, tc.SsspConfig(tri_chunk=16),
                         device="cpu") is not a
    hit = engine_mod._ENGINE_CACHE[(id(st), cfg, "sim", "cpu")]
    assert hit[0] is st and hit[1] is a
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.engine_for(st, cfg)


def test_engine_for_cache_is_bounded(shards):
    _, _, st = shards
    for i in range(engine_mod._ENGINE_CACHE_MAX + 3):
        tc.engine_for(st, tc.SsspConfig(tri_chunk=100 + i), device="cpu")
    assert len(engine_mod._ENGINE_CACHE) <= engine_mod._ENGINE_CACHE_MAX


# ---------------------------------------------------- submit / drain ----

def test_submit_drain_coalesces_as_the_reference(shards):
    ej, et = _pair(shards, max_bucket=4)
    hs = {}
    for name, e in (("jax", ej), ("port", et)):
        hs[name] = [e.submit(3), e.submit([17, 99]), e.submit(120),
                    e.submit(5)]
        assert e.pending == 4 and not hs[name][0].done
    rt, rj = et.drain(), ej.drain()
    assert et.pending == 0 and len(rt) == 4
    # max_bucket=4: [1+2+1] then [1], never split
    assert [r.bucket_k for r in rt] == [r.bucket_k for r in rj] == [4, 4, 4,
                                                                    1]
    for h_t, h_j in zip(hs["port"], hs["jax"]):
        assert h_t.done and h_t.result().q_rounds.shape == (
            len(h_t.sources),)
        assert_results_equal(h_t.result(), h_j.result())
    assert (et.batches_served, et.queries_served) == (2, 5)


def test_handle_result_drains_on_demand(shards):
    g, _, st = shards
    eng = tc.SsspEngine.build(st, device="cpu")
    h = eng.submit([33, 44])
    assert repr(h).endswith("pending)")
    res = h.result()
    assert eng.pending == 0 and h.done
    np.testing.assert_array_equal(res.dist, eng.solve([33, 44]).dist)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(g.n_vertices + 1)
    with pytest.raises(ValueError, match="at least one source"):
        eng.submit([])
    assert eng.pending == 0


def test_drain_requeues_on_failure(shards, monkeypatch):
    """A failing batch and every handle after it go back on the queue."""
    _, sj, st = shards
    eng = tc.SsspEngine.build(st, device="cpu", max_bucket=2)
    h1, h2, h3 = eng.submit(1), eng.submit(2), eng.submit(3)
    monkeypatch.setattr(eng, "solve", lambda *a, **kw: (_ for _ in ()).throw(
        RuntimeError("backend down")))
    with pytest.raises(RuntimeError, match="backend down"):
        eng.drain()
    assert eng.pending == 3 and not h1.done
    monkeypatch.undo()
    eng.drain()
    ref = jc.SsspEngine.build(sj).solve([1, 2, 3], bucket=False)
    for i, h in enumerate((h1, h2, h3)):
        assert h.done
        np.testing.assert_array_equal(h.result().dist[0],
                                      np.asarray(ref.dist)[i])


def test_drain_requeues_after_a_partial_drain(shards, monkeypatch):
    """A failure in the second batch keeps the first batch's results and
    re-queues the rest, ahead of anything submitted since."""
    _, _, st = shards
    eng = tc.SsspEngine.build(st, device="cpu", max_bucket=2)
    hs = [eng.submit(s) for s in (1, 2, 3, 4)]
    real, calls = eng.solve, []

    def flaky(srcs, **kw):
        calls.append(tuple(srcs))
        if len(calls) == 2:
            raise RuntimeError("lost")
        return real(srcs, **kw)
    monkeypatch.setattr(eng, "solve", flaky)
    with pytest.raises(RuntimeError, match="lost"):
        eng.drain()
    assert hs[0].done and hs[1].done and not hs[2].done
    assert eng.pending == 2
    late = eng.submit(5)
    eng.drain()
    assert all(h.done for h in hs) and late.done
    assert calls == [(1, 2), (3, 4), (3, 4), (5,)]


def test_oversized_submission_rides_own_bucket(shards):
    ej, et = _pair(shards, max_bucket=2)
    h = et.submit([1, 2, 3])
    ej.submit([1, 2, 3])
    (res,), (rj,) = et.drain(), ej.drain()
    assert res.bucket_k == 4 and res.sources == (1, 2, 3)
    assert h.result() is res
    assert_results_equal(res, rj)


def test_drain_rides_result_cache(shards):
    ej, et = _pair(shards, dict(prune_online=False), result_cache=8,
                   max_bucket=4)
    out = []
    for e in (et, ej):
        e.solve([3, 17])
        h1, h2 = e.submit(3), e.submit([17, 40])
        e.drain()
        out.append((h1.result(), h2.result()))
    (t1, t2), (j1, j2) = out
    assert int(t1.q_rounds[0]) == 0
    assert int(t2.q_rounds[0]) == 0 and int(t2.q_rounds[1]) > 0
    assert_results_equal(t1, j1)
    assert_results_equal(t2, j2)


# ------------------------------------------------------ build options ----

def test_build_takes_the_engine_keywords(shards):
    _, _, st = shards
    g = tg.random_graph(n=180, m=700, seed=21)
    eng = tc.SsspEngine.build(st, device="cpu", max_bucket=3,
                              result_cache=5, certify=False)
    assert (eng.max_bucket, eng.result_cache.maxsize, eng.certify) == (
        3, 5, False)
    eng_g = tc.SsspEngine.build(g, n_parts=3, enumerate_triangles=False,
                                device="cpu", certify=False)
    assert eng_g.n_parts == 3 and not eng_g.certify
    with pytest.raises(ValueError, match="shard build options"):
        tc.SsspEngine.build(st, n_parts=3, enumerate_triangles=False,
                            device="cpu")


@pytest.mark.parametrize("cfg", [{}, dict(max_rounds=2), dict(toka="toka1")],
                         ids=["converged", "max_rounds", "toka1"])
def test_certify_false_reports_the_detector(shards, cfg):
    """Without the certificate, ``q_converged`` is the detector's done
    bits, and the status follows from them, as in the reference."""
    ej, et = _pair(shards, cfg, certify=False)
    rt, rj = et.solve([3, 17, 99]), ej.solve([3, 17, 99])
    assert_results_equal(rt, rj)
    assert et.cert_traces == 0
    if "max_rounds" in cfg:
        assert rt.status == "max_rounds" and not rt.q_converged.any()


# ------------------------------------------------------- delta, toka1 ----

GRAPHS = {"rmat": ("rmat_graph", dict(scale=8, edge_factor=4, seed=1)),
          "road": ("road_grid_graph", dict(side=10, seed=2))}
SOLVERS = {"delta": dict(local_solver="delta"),
           "delta-small": dict(local_solver="delta", delta=0.5,
                               local_iters=3),
           "toka1": dict(ALL_KERNELS, toka="toka1"),
           "toka1-fused": dict(round="fused", toka="toka1")}
CASES = [(s, g, P) for s in ("delta", "toka1") for g in sorted(GRAPHS)
         for P in (1, 4)] + [(s, g, 4) for s in ("delta-small", "toka1-fused")
                             for g in sorted(GRAPHS)]


@pytest.mark.parametrize("solver,graph,P", CASES)
def test_delta_and_toka1_match_reference(solver, graph, P):
    """The delta solver (each row's near bucket, its own step budget; the
    default config, and a narrow bucket with 3 steps a round) and toka1
    (the message-count vote; the all-kernel staged and the fused round)
    against JAX's, K in {1, 3}: distances and every counter."""
    fn, kw = GRAPHS[graph]
    g = getattr(jg, fn)(**kw)
    sj = jc.build_shards(g, P)
    ej = jc.SsspEngine.build(sj, jc.SsspConfig(**SOLVERS[solver]))
    et = tc.SsspEngine.build(_port_shards(sj), tc.SsspConfig(**SOLVERS[solver]),
                             device="cpu")
    rng = np.random.default_rng(P)
    deg = np.diff(np.asarray(g.row_ptr))
    for k in (1, 3):
        srcs = [int(s) for s in rng.choice(np.nonzero(deg)[0], k,
                                           replace=False)]
        assert_results_equal(et.solve(srcs), ej.solve(srcs))


def test_toka1_vote_matches_reference():
    from repro.core.toka import toka1_vote as jax_vote
    from repro_torch.core.toka import toka1_vote
    rng = np.random.default_rng(0)
    msgs = rng.integers(0, 50, (4, 6)).astype(np.int32)
    inter = np.array([0, 3, 7, 12], np.int32)
    want = np.asarray(jax_vote(msgs, inter[:, None], 4))
    got = toka1_vote(torch.from_numpy(msgs), torch.from_numpy(inter)[:, None],
                     4)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].tolist() == (msgs[0] >= 4).tolist()   # clamped to 1


def test_phase_backends_match_reference_where_ported():
    for phase in ("local_solver", "warm_init", "send", "merge", "round",
                  "toka", "exchange"):
        assert tc.phases.backends(phase) == jc.phases.backends(phase), phase
    assert tc.phases.backends("nope") == ()
    pipe = tc.build_pipeline(tc.SsspShards.__new__(tc.SsspShards),
                             tc.SsspConfig(local_solver="delta",
                                           toka="toka1"))
    assert isinstance(pipe, tc.RoundPipeline)
    assert pipe.toka is tc.phases.resolve("toka", "toka1")
    assert pipe.send is tc.phases.resolve("send", "xla")
