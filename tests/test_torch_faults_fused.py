"""Fault injection in the port's fused round, at K 1 and 3, and on a
ragged layout, against the JAX package's engine (tolerance zero in
distances, every counter incl. ``stale_merges`` and ``resends``, and
status):

- the fused round under tests/test_fused_round.py's plan (staged with the
  pallas local solver beside it, fused == staged in its counters);
- tests/test_faults.py's delay + duplicate + reorder plan at K 1 and 3
  under every synchronous exchange;
- a ragged layout (kernels 2, 4, 6 and 8's plain versions), staged and
  fused.

Each case holds one seed against JAX (JAX compiles once per plan).
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
# tests/test_faults.py: test_toka3_matches_under_faults
COMBINED = dict(drop=0.2, delay=0.1, duplicate=0.1, seed=3, resend_period=4)
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
EXCHANGES = ("bucket", "pmin", "a2a_dense")


@pytest.mark.parametrize("exchange", ["bucket", "a2a_dense"])
def test_fused_round_faults_match_reference(exchange):
    """tests/test_fused_round.py's aggressive plan under toka3: the staged
    round with the pallas local solver and the fused round each == JAX's,
    both equal to Dijkstra, and fused == staged in rounds, q_rounds,
    q_relaxations, messages, stale merges and resends."""
    g = jg.random_graph(n=150, m=600, seed=9)
    sj = jc.build_shards(g, 4)
    st = ref.port_shards(sj)
    rng = np.random.default_rng(11)
    deg = np.diff(np.asarray(g.row_ptr))
    srcs = [int(s) for s in rng.choice(np.nonzero(deg)[0], 2, replace=False)]
    plan = dict(drop=0.2, delay=0.1, duplicate=0.05, seed=3, max_delay=3,
                resend_period=4)
    staged, _ = ref.solve_faulted(sj, st, srcs, plan, exchange=exchange,
                              toka="toka3", local_solver="pallas")
    fused, _ = ref.solve_faulted(sj, st, srcs, plan, exchange=exchange,
                             toka="toka3", round="fused")
    refs = np.stack([jg.dijkstra_reference(g, s) for s in srcs])
    np.testing.assert_allclose(fused.dist, refs, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(fused.dist, staged.dist)
    for f in ("rounds", "q_rounds", "q_relaxations", "msgs_sent",
              "msgs_recv", "stale_merges", "resends"):
        np.testing.assert_array_equal(getattr(fused.stats, f),
                                      getattr(staged.stats, f), err_msg=f)
    assert int(fused.stats.resends) > 0


@pytest.mark.parametrize("k", [1, 3])
def test_combined_plan_matches_reference(k):
    """Delay + duplicate + reorder, no drops and no resend, at K 1 and 3
    (tests/test_faults.py's sources [0, 5, 9]): == JAX's engine, and the
    exact fault-free fixpoint."""
    sj, st, _ = ref.fault_fixture_shards()
    srcs = [0, 5, 9][:k]
    plan = dict(delay=0.25, duplicate=0.2, reorder=0.15, seed=11)
    for ex in EXCHANGES:
        rt, _ = ref.solve_faulted(sj, st, srcs, plan, exchange=ex,
                                  prune_online=False)
        base = tc.SsspEngine.build(st, tc.SsspConfig(
            exchange=ex, prune_online=False), device="cpu").solve(srcs)
        np.testing.assert_array_equal(rt.dist, base.dist)
        assert rt.status == "converged"


@pytest.mark.parametrize("cfg", [dict(ALL_KERNELS, exchange="bucket"),
                                 dict(round="fused", exchange="a2a_dense",
                                      pallas_sweeps=2)],
                         ids=["staged-bucket", "fused-a2a_dense"])
def test_ragged_layout_faults_match_reference(cfg):
    """A ragged layout under the combined plan: all-kernel staged (kernels
    2, 4, 6 with resend rounds and faulted batches) and fused under a
    dense exchange (kernel 8's dense merge mode)."""
    g = jg.rmat_graph(scale=7, edge_factor=8, seed=3)
    sj = jc.build_shards(g, 3, layout="ragged", **TILE)
    st = ref.port_shards(sj)
    rt, _ = ref.solve_faulted(sj, st, [1, 9, 40], COMBINED, **cfg)
    base = tc.SsspEngine.build(st, tc.SsspConfig(), device="cpu").solve(
        [1, 9, 40])
    np.testing.assert_array_equal(rt.dist, base.dist)
    assert rt.status == "converged" and int(rt.stats.resends) > 0
