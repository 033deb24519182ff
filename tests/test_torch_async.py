"""The port's exchanges (dense and deferred) against the JAX package's.

Piece level, on seeded random payloads: ``SimComm``'s dense exchange, ring
routing table and ring hop, the deferred stages' recv/push/flush, the
dense payload assembly, the in-flight bits and the stale-merge count,
against the reference's functions on the same stacked arrays. Engine
level, the staged round: every exchange (``pmin``, ``a2a_dense``,
``async``, ``async_bucket``, ``async_ppermute``) x toka0-3, and
``bucket`` x toka2 and toka3, on the reference's fixture
(``random_graph(n=180, m=720, seed=3)``, P=4, sources [0, 7, 11]), and
``async_lag`` 2 and 3:
distances, every counter (``stale_merges``, ``overlap_rounds`` and
``bytes_moved`` included) and ``status`` equal to the JAX engine's,
tolerance zero. The same matrix on the fused round is in
test_torch_async_fused.py (toka0, toka1) and test_torch_toka.py (toka2,
toka3); the reference's acceptance matrix, the kernel backends, the
ragged layout and a ``max_rounds`` exit in test_torch_async_accept.py.
The config checks of ``async_lag`` close the file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.core.sssp as jsssp  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.sssp as tsssp  # noqa: E402
import _torch_async_ref as ref  # noqa: E402

@pytest.fixture(scope="module")
def fixture_shards():
    return ref.fixture_shards()


def _rows(rng, shape, p_inf):
    a = rng.uniform(0, 40, shape).astype(np.float32)
    a[rng.random(shape) < p_inf] = np.inf
    return a


def t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- pieces --

@pytest.mark.parametrize("P", [1, 2, 4, 5])
def test_sim_comm_matches_reference(P):
    rng = np.random.default_rng(P)
    K, blk = 3, 7
    tcomm, jcomm = tc.SimComm(P), jsssp.SimComm(P)
    dense = _rows(rng, (P, K, P, blk), 0.6)
    np.testing.assert_array_equal(tcomm.exchange_pmin(t(dense)).numpy(),
                                  np.asarray(jcomm.exchange_pmin(dense)))
    np.testing.assert_array_equal(tcomm.exchange_a2a_dense(t(dense)).numpy(),
                                  np.asarray(jcomm.exchange_a2a_dense(dense)))
    np.testing.assert_array_equal(tcomm.dest_dirs().numpy(),
                                  np.asarray(jcomm.dest_dirs()))
    fwd, bwd = _rows(rng, dense.shape, 0.5), _rows(rng, dense.shape, 0.5)
    fwd_c, bwd_c = t(fwd), t(bwd)
    got = tcomm.async_hop(fwd_c, bwd_c)
    want = jcomm.async_hop(fwd, bwd)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))
    # the carried buffers are not written
    np.testing.assert_array_equal(fwd_c.numpy(), fwd)
    np.testing.assert_array_equal(bwd_c.numpy(), bwd)
    ints = rng.integers(0, 9, (P, K)).astype(np.int32)
    np.testing.assert_array_equal(tcomm.total(t(ints)).numpy(),
                                  np.asarray(jcomm.total(ints)))
    flags = rng.random((P, K)) < 0.3
    np.testing.assert_array_equal(tcomm.all_any(t(flags)).numpy(),
                                  np.asarray(jcomm.all_any(flags)))


@pytest.mark.parametrize("name", ["async", "async_ppermute"])
def test_deferred_stages_match_reference(fixture_shards, name):
    """recv / push / flush of the deferred stages over a few rounds of
    random sends, and the in-flight bits of each state."""
    sj, st, _ = fixture_shards
    rng = np.random.default_rng(7)
    K, P = 2, st.n_parts
    ex_t = tc.phases.resolve("exchange", name)
    ex_j = jc.phases.resolve("exchange", name)
    cfg_t, cfg_j = tc.SsspConfig(exchange=name), jc.SsspConfig(exchange=name)
    comm_t, comm_j = tc.SimComm(P), jsssp.SimComm(P)
    inf_t = ex_t.init_inflight(st, K, cfg_t)
    inf_j = ex_j.init_inflight(sj, K, cfg_j, True)
    width = st.block if ex_t.dense else st.bucket_cap
    for _ in range(P + 1):
        inc_t, mid_t = ex_t.recv(comm_t, inf_t)
        inc_j, mid_j = ex_j.recv(comm_j, inf_j)
        np.testing.assert_array_equal(inc_t.numpy(), np.asarray(inc_j))
        payload = _rows(rng, (P, K, P, width), 0.7)
        inf_t = ex_t.push(comm_t, mid_t, t(payload))
        inf_j = ex_j.push(comm_j, mid_j, jnp.asarray(payload))
        np.testing.assert_array_equal(
            tsssp._pending_inflight(inf_t).numpy(),
            np.asarray(jsssp._pending_inflight(inf_j, True)))
    for a, b in zip(ex_t.flush(comm_t, inf_t), ex_j.flush(comm_j, inf_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dense_payload_pieces_match_reference(fixture_shards):
    """``_scatter_dense``, ``_merge_dense``, ``_count_improving`` (dense and
    bucketed) and ``_mask_payload`` of dense rows on random state."""
    sj, st, _ = fixture_shards
    rng = np.random.default_rng(3)
    K, P, blk = 3, st.n_parts, st.block
    send_val = _rows(rng, (P, K, st.n_slots), 0.5)
    send_val[~np.broadcast_to(st.slot_valid.numpy()[:, None],
                              send_val.shape)] = np.inf
    got = tsssp._scatter_dense(st, t(send_val), blk)
    want = jax_vmap_scatter(sj, send_val, blk)
    np.testing.assert_array_equal(got.numpy(), want)
    dist = _rows(rng, (P, K, blk), 0.3)
    inc = _rows(rng, (P, K, blk), 0.6)
    for a, b in zip(tsssp._merge_dense(t(dist), t(inc)),
                    jsssp._merge_dense(dist, inc)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bucket = _rows(rng, (P, K, P, st.bucket_cap), 0.5)
    for dense, incoming in ((True, inc), (False, bucket)):
        got = tsssp._count_improving(st, t(dist), t(incoming), dense)
        want = [np.asarray(jsssp._count_improving(
            jax_shard(sj, p), dist[p], incoming[p], dense)) for p in range(P)]
        np.testing.assert_array_equal(got.numpy(), np.stack(want))
    payload = _rows(rng, (P, K, P, blk), 0.97)
    masked, nbytes = tsssp._mask_payload(t(payload))
    jm, jb = jsssp._mask_payload(payload)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(jm))
    assert int(nbytes) == int(jb)


def jax_shard(sj, p):
    return jax.tree_util.tree_map(lambda x: x[p], sj)


def jax_vmap_scatter(sj, send_val, blk):
    return np.asarray(jax.vmap(lambda sh, v: jsssp._scatter_dense(
        sh, v, blk))(sj, jnp.asarray(send_val)))


# ---------------------------------------------------------------- engine --

@pytest.mark.parametrize("exchange,toka", [
    (ex, toka) for ex in ref.EXCHANGES
    for toka in ("toka0", "toka1", "toka2", "toka3")
    # bucket with toka0 and toka1: tests/test_torch_engine*.py
    if ex != "bucket" or toka in ("toka2", "toka3")])
def test_exchanges_match_reference(fixture_shards, exchange, toka):
    """Each exchange, staged, under each detector equals the JAX engine in
    distances and every counter, and the synchronous ``bucket`` solve in
    distances; a deferred solve takes more rounds than the synchronous one
    and reports its stale merges."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_both(sj, st, ref.SOURCES, exchange=exchange,
                           toka=toka)
    assert rt.status == "converged"
    base = tc.SsspEngine.build(st, tc.SsspConfig(toka=toka),
                               device="cpu").solve(ref.SOURCES)
    np.testing.assert_array_equal(rt.dist, base.dist)
    if exchange.startswith("async"):
        assert int(rt.stats.rounds) > int(base.stats.rounds)
        assert int(rt.stats.stale_merges) > 0
        assert rt.overlap_fraction == (int(rt.stats.overlap_rounds)
                                       / int(rt.stats.rounds))
    else:
        assert int(rt.stats.stale_merges) == int(rt.stats.overlap_rounds) == 0


@pytest.mark.parametrize("exchange,lag", [("async", 2), ("async", 3),
                                          ("async_bucket", 2)])
def test_async_lag_matches_reference(fixture_shards, exchange, lag):
    """``async_lag`` buffers: equal to JAX, the same distances as lag 1 in
    more rounds (the fused round: test_torch_async_fused.py)."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_both(sj, st, ref.SOURCES, exchange=exchange,
                           async_lag=lag)
    lag1 = tc.SsspEngine.build(st, tc.SsspConfig(exchange=exchange),
                               device="cpu").solve(ref.SOURCES)
    np.testing.assert_array_equal(rt.dist, lag1.dist)
    assert int(rt.stats.rounds) > int(lag1.stats.rounds)


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("kw,match", [
    (dict(async_lag=0), "async_lag must be >= 1"),
    (dict(async_lag=-3, exchange="async"), "async_lag must be >= 1"),
    (dict(async_lag=2), "only applies to the buffered"),
    (dict(async_lag=2, exchange="async_ppermute"), "ring distance"),
    (dict(async_lag=3, exchange="pmin"), "only applies to the buffered")])
def test_async_lag_checks_match_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        tc.SsspConfig(**kw)
    with pytest.raises(ValueError, match=match):
        jc.SsspConfig(**kw)


def test_async_lag_accepted_by_buffered_exchanges():
    for ex in ("async", "async_bucket"):
        assert tc.SsspConfig(exchange=ex, async_lag=3).async_lag == 3
