"""The port's termination detectors against the JAX package's.

Function level: toka2's account, forward and absorb on seeded random
[P, K] states (the JAX functions vmapped over shards and queries), and
toka3's bound and host timeout over a sweep of inter-edge counts,
partition counts, safety factors and slacks: equal, tolerance zero.
Engine level: toka2 and toka3 under every exchange on the fused round, on
the reference's fixture (``random_graph(n=180, m=720, seed=3)``, P=4,
sources [0, 7, 11]; the staged round is in test_torch_async.py), and
toka2 at P in {1, 2, 3, 5, 8}: distances and every counter equal to the
JAX engine's.
"""
from functools import partial

import jax
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.core.toka as jt  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.toka as tt  # noqa: E402
import _torch_async_ref as ref  # noqa: E402

@pytest.fixture(scope="module")
def fixture_shards():
    return ref.fixture_shards()


# ------------------------------------------------------------ functions --

def _random_state(rng, P, K):
    """A Toka2State of [P, K] int32/bool fields, numpy."""
    return dict(color=rng.integers(0, 2, (P, K)),
                count=rng.integers(-2, 3, (P, K)),
                has_token=rng.random((P, K)) < 0.5,
                tok_state=rng.integers(0, 3, (P, K)),
                tok_count=rng.integers(-2, 3, (P, K)),
                tok_hops=rng.integers(0, P + 2, (P, K)),
                seen_red=rng.random((P, K)) < 0.2)


def _pair(fields, cls_t, cls_j):
    def cast(v):
        return v if v.dtype == bool else v.astype(np.int32)
    return (cls_t(**{k: torch.from_numpy(cast(v)) for k, v in
                     fields.items()}),
            cls_j(**{k: jax.numpy.asarray(cast(v)) for k, v in
                     fields.items()}))


def _assert_tuple_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _vv(fn, in_axes=0):
    """``fn`` vmapped over queries, then over shards (the reference's
    ``_vcall`` on the stacked sim arrays)."""
    return jax.vmap(jax.vmap(fn, in_axes=in_axes))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("P", [1, 3, 8])
def test_toka2_functions_match_reference(P, seed):
    rng = np.random.default_rng(100 * P + seed)
    K = 5
    st_t, st_j = _pair(_random_state(rng, P, K), tt.Toka2State, jt.Toka2State)
    sends = rng.integers(0, 3, (P, K)).astype(np.int32)
    recvs = rng.integers(0, 3, (P, K)).astype(np.int32)
    acc_t = tt.toka2_account(st_t, torch.from_numpy(sends),
                             torch.from_numpy(recvs))
    acc_j = _vv(jt.toka2_account)(st_j, sends, recvs)
    _assert_tuple_equal(acc_t, acc_j)

    idle = rng.random((P, K)) < 0.7
    rank = np.arange(P, dtype=np.int32)
    fwd_t, out_t = tt.toka2_forward(acc_t, torch.from_numpy(rank)[:, None],
                                    torch.from_numpy(idle), n_parts=P)
    fwd_j, out_j = _vv(partial(jt.toka2_forward, n_parts=P),
                       in_axes=(0, None, 0))(acc_j, rank, idle)
    _assert_tuple_equal(fwd_t, fwd_j)
    _assert_tuple_equal(out_t, out_j)

    tok = dict(present=rng.random((P, K)) < 0.5,
               state=rng.integers(0, 3, (P, K)),
               count=rng.integers(-2, 3, (P, K)),
               hops=rng.integers(0, P + 2, (P, K)))
    tok_t, tok_j = _pair(tok, tt.Token, jt.Token)
    _assert_tuple_equal(tt.toka2_absorb(fwd_t, tok_t),
                        _vv(jt.toka2_absorb)(fwd_j, tok_j))


def test_toka2_init_and_ring():
    """Shard 0 holds all K tokens at start; the ring moves every token
    field one shard forward."""
    P, K = 4, 3
    st = tt.toka2_init(torch.arange(P, dtype=torch.int32)[:, None], K)
    want = jax.vmap(lambda r: jc.sssp._toka2_init_batch(r, K))(
        np.arange(P, dtype=np.int32))
    _assert_tuple_equal(st, want)
    comm = tc.SimComm(P)
    tok = tt.Token(*(torch.arange(P * K, dtype=torch.int32).reshape(P, K) + i
                     for i in range(4)))
    tok_j = jt.Token(*(np.asarray(x) for x in tok))
    _assert_tuple_equal(comm.ring(tok), jc.sssp.SimComm(P).ring(tok_j))


@pytest.mark.parametrize("slack", [0, 3])
@pytest.mark.parametrize("safety", [0.5, 1.0, 2.0, 2.5, 3.7])
def test_toka3_bound_matches_reference(safety, slack):
    rng = np.random.default_rng(int(safety * 10) + slack)
    ie = np.concatenate([np.arange(0, 70), [127, 255, 1023, 4095, 65535],
                         rng.integers(0, 10_000_000, 200)]).astype(np.int32)
    for P in (1, 2, 3, 5, 7, 8, 16, 64):
        got = tt.toka3_bound(torch.from_numpy(ie), P, safety, slack)
        want = np.asarray(jt.toka3_bound(ie, P, safety, slack))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(P))
        for v in ie[::17]:
            assert (tt.toka3_timeout(int(v), P, safety, slack)
                    == jt.toka3_timeout(int(v), P, safety, slack))


def test_toka3_rounds_bound_a_solve(fixture_shards):
    """rounds(toka3) <= rounds(toka0) + the timeout of the global
    inter-edge count, as the reference's test_toka3_terminates_within_bound
    holds it."""
    sj, st, _ = fixture_shards
    eng = tc.SsspEngine.build(st, tc.SsspConfig(toka="toka3"), device="cpu")
    r3 = int(eng.solve([0, 7, 11]).stats.rounds)
    r0 = int(tc.SsspEngine.build(st, tc.SsspConfig(), device="cpu")
             .solve([0, 7, 11]).stats.rounds)
    bound = tt.toka3_timeout(st.inter_edges_total, st.n_parts)
    assert st.inter_edges_total == int(np.asarray(sj.inter_edges).sum())
    assert r0 < r3 <= r0 + bound


def test_toka3_safety_checked():
    with pytest.raises(ValueError, match="toka3_safety"):
        tc.SsspConfig(toka3_safety=0.0)


# --------------------------------------------------------------- engine --

@pytest.mark.parametrize("exchange", ref.EXCHANGES)
@pytest.mark.parametrize("toka", ["toka2", "toka3"])
def test_fused_detectors_match_reference(fixture_shards, toka, exchange):
    """toka2 (Safra's counters under the bucketed exchanges, the color-only
    ring under the dense ones) and toka3 (its bound widened by the
    deferred exchanges' lag) on every exchange, on the fused round (the
    staged round: test_torch_async.py)."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_both(sj, st, ref.SOURCES, exchange=exchange,
                           round="fused", toka=toka)
    assert rt.status == "converged"


@pytest.mark.parametrize("P", [1, 2, 3, 5, 8])
def test_toka2_at_every_partition_count(P):
    """The reference's partition sweep (tests/test_toka.py): the token ring
    at P in {1, 2, 3, 5, 8}, equal to JAX's and to Dijkstra."""
    g = jg.random_graph(n=90, m=350, seed=2)
    sj = jc.build_shards(g, P)
    rt, _ = ref.solve_both(sj, ref.port_shards(sj), [0, 4], toka="toka2")
    np.testing.assert_allclose(rt.dist[0], jg.dijkstra_reference(g, 0),
                               rtol=1e-5, atol=1e-4)
    r0 = tc.SsspEngine.build(ref.port_shards(sj), tc.SsspConfig(),
                             device="cpu").solve([0, 4])
    assert int(rt.stats.rounds) >= int(r0.stats.rounds) + P
