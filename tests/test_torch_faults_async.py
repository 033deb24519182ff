"""Fault injection under the port's deferred exchanges and its
detectors, against the JAX package's engine (tolerance zero in distances,
every counter incl. ``stale_merges`` and ``resends``, and status):

- ``async`` and ``async_ppermute`` under tests/test_faults.py's combined
  plan, staged and fused (the injector applies when a batch leaves the
  in-flight buffer; the stale merges are the improving entries of the
  injected batch);
- the four detectors under the same plan (toka2's color-only ring and
  toka3's widened bound).

Each case holds one seed against JAX (JAX compiles once per plan).
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import _torch_async_ref as ref  # noqa: E402

# tests/test_faults.py: test_toka3_matches_under_faults
COMBINED = dict(drop=0.2, delay=0.1, duplicate=0.1, seed=3, resend_period=4)


@pytest.fixture(scope="module")
def fixture_shards():
    return ref.fixture_shards()


@pytest.mark.parametrize("rnd", ["staged", "fused"])
@pytest.mark.parametrize("exchange", ["async", "async_ppermute"])
def test_deferred_exchange_faults_match_reference(fixture_shards, exchange,
                                                  rnd):
    """The combined plan under the deferred exchanges: == JAX's engine
    (stale merges are the improving entries of the injected batch), and
    the distances of the fault-free synchronous solve."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_faulted(sj, st, ref.SOURCES, COMBINED, exchange=exchange,
                          round=rnd, toka="toka3")
    base = tc.SsspEngine.build(st, tc.SsspConfig(), device="cpu").solve(
        ref.SOURCES)
    np.testing.assert_array_equal(rt.dist, base.dist)
    assert rt.status == "converged"
    assert int(rt.stats.resends) > 0 and int(rt.stats.stale_merges) > 0


@pytest.mark.parametrize("toka", ["toka0", "toka1", "toka2", "toka3"])
def test_detectors_under_faults_match_reference(fixture_shards, toka):
    """tests/test_faults.py's combined plan under each detector (toka2
    runs its color-only ring, toka3 widens its bound by the plan's
    slack): == JAX's engine, converged, the fault-free distances."""
    sj, st, _ = fixture_shards
    rt, _ = ref.solve_faulted(sj, st, ref.SOURCES, COMBINED, toka=toka,
                          prune_online=False)
    base = tc.SsspEngine.build(st, tc.SsspConfig(), device="cpu").solve(
        ref.SOURCES)
    np.testing.assert_array_equal(rt.dist, base.dist)
    assert rt.status == "converged"
