"""Fault injection of the port (``repro_torch.core.faults`` and the fault
branches of both rounds) against the JAX package's, tolerance zero.

- ``FaultPlan``: the reference's validation cases, its properties and its
  printed form (the runner prints it).
- The injector: ``inject`` and ``wrap_exchange(...).deliver`` against
  JAX's, vmapped over the shards, on seeded states: each regime and a
  combined plan, dense and bucketed payloads (the sentinel targets
  included), a queue that is not empty, ``resend_period`` 0 and 4; every
  output compared (delivered, queue, unhealed, stale, pending). The draws
  are ``jax.random``'s, bit for bit, so every counter must match.
- Solves against JAX's engine in distances, every counter (``stale_merges``
  and ``resends`` included) and status: the reference's fault matrix (4
  regimes x ``bucket``/``pmin``/``a2a_dense``), the degraded solve and the
  result and landmark caches' refusal of its rows. Seeds 0-2 of the matrix
  are held to the port's own fault-free solve.

The deferred exchanges and the detectors under faults are in
test_torch_faults_async.py; the fused round, the combined plan at K 1 and
3 and a ragged layout in test_torch_faults_fused.py. JAX compiles once per
plan, so each case holds one seed against JAX.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.core.faults as jf  # noqa: E402
import repro.core.phases as jphases  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.faults as tf  # noqa: E402
import repro_torch.core.phases as tphases  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
import _torch_async_ref as ref  # noqa: E402

EXCHANGES = ("bucket", "pmin", "a2a_dense")
SOURCES = [0, 5, 9]             # tests/test_faults.py's sources
# tests/test_faults.py: a plan per regime (drops need the resend)
PLANS = {"drop": dict(drop=0.3, resend_period=4), "delay": dict(delay=0.4),
         "duplicate": dict(duplicate=0.4), "reorder": dict(reorder=0.4)}
INJECT_PLANS = dict(PLANS, combined=dict(drop=0.2, delay=0.25,
                                         duplicate=0.2, reorder=0.15))


@pytest.fixture(scope="module")
def fault_shards():
    return ref.fault_fixture_shards()


@pytest.fixture(scope="module")
def baselines(fault_shards):
    """The port's fault-free solve per exchange."""
    _, st, _ = fault_shards
    return {ex: tc.SsspEngine.build(st, tc.SsspConfig(
        exchange=ex, prune_online=False), device="cpu").solve(SOURCES)
        for ex in EXCHANGES}


# ------------------------------------------------------------ FaultPlan --

def test_fault_plan_validation():
    """tests/test_faults.py's cases, and the port's config takes only the
    port's plan."""
    for bad in (dict(drop=-0.1), dict(delay=1.5),
                dict(drop=0.6, duplicate=0.6),
                dict(max_delay=0), dict(resend_period=-1)):
        with pytest.raises(ValueError):
            tc.FaultPlan(**bad)
    assert not tc.FaultPlan().active
    assert tc.FaultPlan(drop=0.1).active
    with pytest.raises(TypeError):
        tc.SsspConfig(faults={"drop": 0.1})
    with pytest.raises(TypeError, match="FaultPlan"):
        tc.SsspConfig(faults=jc.FaultPlan(drop=0.1))
    with pytest.raises(ValueError):
        tc.SsspConfig(toka3_safety=0.0)
    assert tc.SsspConfig(faults=tc.FaultPlan()).fault_plan is None
    plan = tc.FaultPlan(delay=0.2)
    assert tc.SsspConfig(faults=plan).fault_plan is plan


@pytest.mark.parametrize("plan", [
    {}, dict(drop=0.3, resend_period=4), dict(delay=0.25, seed=11),
    dict(drop=0.2, delay=0.1, duplicate=0.05, seed=3, max_delay=5,
         resend_period=2), dict(reorder=1.0)])
def test_fault_plan_matches_reference(plan):
    """Fields, ``active``, ``fault_slack``, the printed form (the runner
    prints it) and hashing (a plan rides in the config's cache keys)."""
    pt, pj = tc.FaultPlan(**plan), jc.FaultPlan(**plan)
    assert repr(pt) == repr(pj)
    assert (pt.active, pt.fault_slack) == (pj.active, pj.fault_slack)
    assert hash(pt) == hash(tc.FaultPlan(**plan))
    assert tc.SsspConfig(faults=pt) == tc.SsspConfig(faults=tc.FaultPlan(
        **plan))


# ------------------------------------------------------------ the injector --

def _state(rng, P, K, M, D):
    """Seeded inputs of one injection: incoming (40% +inf), targets (20%
    +inf), a queue 30% full and random latches."""
    def vals(shape, p_inf):
        v = rng.uniform(0, 30, shape).astype(np.float32)
        return np.where(rng.random(shape) < p_inf, np.inf, v).astype(
            np.float32)
    return (vals((P, K, M), 0.4), vals((P, K, M), 0.2),
            vals((P, D, K, M), 0.7), rng.random((P, K)) < 0.3)


def _jax_keys(seed, rnd, P):
    rkey = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
    return jax.vmap(lambda r: jax.random.fold_in(rkey, r))(jnp.arange(P))


def _assert_inject_equal(got, want):
    delivered, st, stale, pending = got
    np.testing.assert_array_equal(delivered.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(st.queue.numpy(), np.asarray(want[1].queue))
    np.testing.assert_array_equal(st.unhealed.numpy(),
                                  np.asarray(want[1].unhealed))
    np.testing.assert_array_equal(stale.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(pending.numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("resend", [0, 4])
@pytest.mark.parametrize("regime", sorted(INJECT_PLANS))
def test_inject_matches_reference(regime, resend):
    """``inject`` on the stacked shards == JAX's vmapped over them, for
    three successive rounds of keys carrying the state forward."""
    kw = dict(INJECT_PLANS[regime], seed=5, resend_period=resend)
    pt, pj = tc.FaultPlan(**kw), jc.FaultPlan(**kw)
    P, K, M = 4, 3, 50
    rng = np.random.default_rng(3)
    inc, d_t, queue, unhealed = _state(rng, P, K, M, pt.max_delay)
    st_t = tf.FaultState(torch.from_numpy(queue), torch.from_numpy(unhealed))
    st_j = jf.FaultState(jnp.asarray(queue), jnp.asarray(unhealed))
    for rnd in range(3):
        want = jax.vmap(lambda i, d, s, k: jf.inject(pj, i, d, s, k))(
            jnp.asarray(inc), jnp.asarray(d_t), st_j,
            _jax_keys(kw["seed"], rnd, P))
        got = tf.inject(pt, torch.from_numpy(inc), torch.from_numpy(d_t),
                        st_t, tf.round_keys(pt, rnd, P, "cpu"))
        _assert_inject_equal(got, want)
        st_t, st_j = got[1], want[1]
        inc = np.array(want[0])       # a fresh batch: the last delivery


@pytest.mark.parametrize("regime", ["drop", "delay", "combined"])
@pytest.mark.parametrize("exchange", ["bucket", "a2a_dense"])
def test_deliver_matches_reference(fault_shards, exchange, regime):
    """``wrap_exchange(stage, plan).deliver`` on the shards == JAX's:
    bucketed messages gather their targets through ``recv_idx`` (the
    sentinel fills +inf), dense rows are their own targets. Three rounds,
    so the later ones release a queue that is not empty (a drop-only plan
    queues nothing)."""
    sj, st, _ = fault_shards
    kw = dict(INJECT_PLANS[regime], seed=2, resend_period=4)
    pt, pj = tc.FaultPlan(**kw), jc.FaultPlan(**kw)
    ex_t = tf.wrap_exchange(tphases.resolve("exchange", exchange), pt)
    ex_j = jf.wrap_exchange(jphases.resolve("exchange", exchange), pj)
    assert (ex_t.name, ex_t.dense) == (ex_j.name, ex_j.dense)
    P, K, block, C = st.n_parts, 3, st.block, st.bucket_cap
    if exchange == "bucket":
        assert (np.asarray(sj.recv_idx) == block).any()   # sentinels
    M = block if ex_t.dense else P * C
    rng = np.random.default_rng(11)
    state_t = tf.init_state(pt, K, M, P, "cpu")
    state_j = jf.init_state(pj, K, M, P)
    for rnd in range(3):
        dist, _, _, _ = _state(rng, P, K, block, 1)
        shape = (P, K, block) if ex_t.dense else (P, K, P, C)
        inc = np.where(rng.random(shape) < 0.5, np.inf,
                       rng.uniform(0, 30, shape)).astype(np.float32)
        want = jax.vmap(ex_j.deliver)(sj, jnp.asarray(dist),
                                      jnp.asarray(inc), state_j,
                                      _jax_keys(kw["seed"], rnd, P))
        got = ex_t.deliver(st, torch.from_numpy(dist), torch.from_numpy(inc),
                           state_t, tf.round_keys(pt, rnd, P, "cpu"))
        _assert_inject_equal(got, want)
        state_t, state_j = got[1], want[1]
    if regime != "drop":
        assert bool(torch.isfinite(state_t.queue).any())


def test_carry_holds_the_fault_state(fault_shards):
    """``init_carry`` under an active plan: an empty queue of one slot per
    flat payload position (``block`` dense, ``P * C`` bucketed), cleared
    latches, zero resends; none under an inactive plan."""
    _, st, _ = fault_shards
    P, D = st.n_parts, 3
    for ex, M in (("bucket", P * st.bucket_cap), ("a2a_dense", st.block)):
        c = tc.init_carry(st, [0, 5], tc.SsspConfig(
            exchange=ex, faults=tc.FaultPlan(delay=0.1)))
        assert tuple(c.faults.queue.shape) == (P, D, 2, M)
        assert not bool(torch.isfinite(c.faults.queue).any())
        assert not bool(c.faults.unhealed.any())
        assert int(c.resent.sum()) == 0
    c = tc.init_carry(st, [0], tc.SsspConfig(faults=tc.FaultPlan()))
    assert c.faults is None
    assert tc.build_pipeline(st, tc.SsspConfig(
        faults=tc.FaultPlan(drop=0.1))).exchange.name == "bucket+faults"


# -------------------------------------------------------------- solves ----

@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("mode", sorted(PLANS))
def test_fault_matrix_matches_reference(fault_shards, baselines, mode,
                                        exchange):
    """tests/test_faults.py's matrix: seed 0 == JAX's engine in every
    counter; seeds 0-2 bit-identical to the fault-free solve, certified
    converged."""
    sj, st, _ = fault_shards
    rt, _ = ref.solve_faulted(sj, st, SOURCES, dict(PLANS[mode], seed=0),
                          exchange=exchange, prune_online=False)
    for seed in (0, 1, 2):
        res = rt if seed == 0 else tc.SsspEngine.build(st, tc.SsspConfig(
            exchange=exchange, prune_online=False,
            faults=tc.FaultPlan(**PLANS[mode], seed=seed)),
            device="cpu").solve(SOURCES)
        np.testing.assert_array_equal(res.dist, baselines[exchange].dist)
        assert res.status == "converged" and res.q_converged.all()
    if mode == "drop":
        assert int(rt.stats.resends) > 0
    if mode in ("delay", "reorder"):
        assert int(rt.stats.stale_merges) > 0


def test_degraded_solve_matches_reference(fault_shards, baselines):
    """Heavy drops, no resend: the detectors fire, the certificate finds
    the unrelaxed edges: ``degraded``, no query converged, distances above
    the fixpoint and different from it; == JAX's engine."""
    sj, st, _ = fault_shards
    rt, _ = ref.solve_faulted(sj, st, SOURCES, dict(drop=0.6, seed=2),
                          prune_online=False)
    assert rt.status == "degraded" and not rt.q_converged.any()
    base = baselines["bucket"].dist
    assert not np.array_equal(rt.dist, base)
    assert np.all(rt.dist >= base)


def test_degraded_rows_never_cached(fault_shards):
    """A degraded row is an upper bound: the result LRU does not admit it
    and ``precompute_landmarks`` refuses it, as in the reference."""
    _, st, _ = fault_shards
    cfg = tc.SsspConfig(prune_online=False,
                        faults=tc.FaultPlan(drop=0.6, seed=2))
    eng = tc.SsspEngine.build(st, cfg, result_cache=16, device="cpu")
    assert eng.solve([0, 5]).status == "degraded"
    again = eng.solve([0, 5])
    assert again.cache_hits == 0 and int(again.stats.rounds) > 0
    eng = tc.SsspEngine.build(st, cfg, device="cpu")
    with pytest.raises(ValueError, match="did not converge"):
        eng.precompute_landmarks([0, 5])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_faulted_solve_matches_dijkstra(seed):
    """tests/test_faults.py's end-to-end check on the port alone: a random
    graph, a combined plan with resend, distances equal to Dijkstra's."""
    g = tg.random_graph(n=64, m=220, seed=seed)
    sh = tc.build_shards(g, 3, enumerate_triangles=False)
    plan = tc.FaultPlan(drop=0.2, delay=0.2, duplicate=0.1, seed=seed,
                        resend_period=3)
    dist, _ = tc.solve_sim(sh, 0, tc.SsspConfig(prune_online=False,
                                                faults=plan), device="cpu")
    np.testing.assert_allclose(dist, tg.dijkstra_reference(g, 0),
                               rtol=1e-5, atol=1e-4)
