"""The fused round of the port under the dense and deferred exchanges,
against the JAX package's.

Every exchange (``pmin``, ``a2a_dense``, ``async``, ``async_bucket``,
``async_ppermute``) x toka0 and toka1, and ``async_lag`` 2 and 3, with
``round="fused"`` on the reference's fixture (``random_graph(n=180,
m=720, seed=3)``, P=4, sources [0, 7, 11]): distances, every counter and
``status`` equal to the JAX engine's, tolerance zero. The fused round
under a dense exchange runs kernels 7 and 8 in their dense merge mode
(here their plain versions; JAX's kernel in interpret mode); its overlap
bit is ``delivering & ~idle``, not the staged round's. toka2 and toka3 on
the fused round are in test_torch_toka.py.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import _torch_async_ref as ref  # noqa: E402


@pytest.fixture(scope="module")
def fixture_shards():
    return ref.fixture_shards()


@pytest.mark.parametrize("toka", ["toka0", "toka1"])
@pytest.mark.parametrize("exchange", ref.EXCHANGES[1:])
def test_fused_exchanges_match_reference(fixture_shards, exchange, toka):
    """Equal to JAX's fused solve and, in distances, to the synchronous
    fused solve; every counter but ``n_dispatches`` (and the overlap,
    defined otherwise) equal to the port's staged solve."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_both(sj, st, ref.SOURCES, exchange=exchange,
                           round="fused", toka=toka)
    assert rt.status == "converged"
    assert int(rt.stats.n_dispatches) == 2 * int(rt.stats.rounds)
    base = tc.SsspEngine.build(st, tc.SsspConfig(round="fused", toka=toka),
                               device="cpu").solve(ref.SOURCES)
    np.testing.assert_array_equal(rt.dist, base.dist)
    staged = tc.SsspEngine.build(st, tc.SsspConfig(exchange=exchange,
                                                   toka=toka),
                                 device="cpu").solve(ref.SOURCES)
    for f in ("rounds", "relaxations", "msgs_sent", "msgs_recv",
              "q_rounds", "stale_merges", "bytes_moved"):
        np.testing.assert_array_equal(np.asarray(getattr(rt.stats, f)),
                                      np.asarray(getattr(staged.stats, f)),
                                      err_msg=f)


@pytest.mark.parametrize("exchange,lag", [("async", 2), ("async", 3),
                                          ("async_bucket", 2)])
def test_fused_async_lag_matches_reference(fixture_shards, exchange, lag):
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_both(sj, st, ref.SOURCES, exchange=exchange,
                           round="fused", async_lag=lag)
    lag1 = tc.SsspEngine.build(st, tc.SsspConfig(exchange=exchange,
                                                 round="fused"),
                               device="cpu").solve(ref.SOURCES)
    np.testing.assert_array_equal(rt.dist, lag1.dist)
    assert int(rt.stats.rounds) > int(lag1.stats.rounds)
