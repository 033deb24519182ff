"""The fused round of the PyTorch port against the JAX package's, engine
level: ``round="fused"`` solves of the port and of the JAX package on the
same shards (dense and ragged layouts, P in {1, 4, 8}, K in {1, 3}, 1 and
4 sweeps), the port's fused solve against its staged all-kernel solve, and
a ``max_rounds`` exit with a delivery outstanding. The kernel level is in
``tests/test_torch_round.py``, whose shards and helpers these tests share.
The tolerance is zero.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from test_torch_round import (TILE, _port_shards,  # noqa: E402
                              shards)  # noqa: F401 (a fixture)

ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas", round="staged", exchange="bucket",
                   toka="toka0")
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged",
            "n_dispatches", "bytes_moved", "stale_merges", "resends")


def _live_sources(g, k, seed):
    rng = np.random.default_rng(seed)
    deg = np.diff(np.asarray(g.row_ptr))
    return [int(s) for s in rng.choice(np.nonzero(deg)[0], k, replace=False)]


def assert_results_equal(a, b, skip=()):
    np.testing.assert_array_equal(a.dist, np.asarray(b.dist))
    for f in COUNTERS:
        if f not in skip:
            np.testing.assert_array_equal(np.asarray(getattr(a.stats, f)),
                                          np.asarray(getattr(b.stats, f)),
                                          err_msg=f)
    assert a.status == b.status
    assert a.bucket_k == b.bucket_k


@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_fused_engine_matches_reference(layout, P, nq, sweeps):
    g = jg.rmat_graph(scale=7, edge_factor=8, seed=3)
    sj = jc.build_shards(g, P, layout=layout, **TILE)
    srcs = _live_sources(g, nq, seed=P + nq)
    cfg = dict(round="fused", pallas_sweeps=sweeps, tri_chunk=16)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(_port_shards(sj), tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert rj.status == "converged"
    assert int(rt.stats.n_dispatches) == 2 * int(rt.stats.rounds)
    assert_results_equal(rt, rj)


@pytest.mark.parametrize("sweeps", [1, 8])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_fused_solve_equals_staged_solve(shards, layout, sweeps):
    """Inside the port, fused == staged all-kernel in distances and every
    counter but n_dispatches (2 vs 4 a round), with Trishla pruning on;
    CPU tensors launch no kernel."""
    _, st, g = shards("rmat7", layout)
    srcs = _live_sources(g, 3, seed=4)
    before = dict(build.LAUNCHES)
    kw = dict(pallas_sweeps=sweeps, tri_chunk=16)
    fused = tc.SsspEngine.build(st, tc.SsspConfig(round="fused", **kw),
                                device="cpu").solve(srcs)
    staged = tc.SsspEngine.build(st, tc.SsspConfig(**ALL_KERNELS, **kw),
                                 device="cpu").solve(srcs)
    assert build.LAUNCHES == before
    assert fused.status == "converged"
    assert int(fused.stats.pruned_edges) > 0
    assert_results_equal(fused, staged, skip=("n_dispatches",))
    assert int(fused.stats.n_dispatches) == 2 * int(fused.stats.rounds)
    assert int(staged.stats.n_dispatches) == 4 * int(staged.stats.rounds)


def test_fused_max_rounds_exit_matches_reference(shards):
    """A solve cut at two rounds exits with a delivered batch outstanding;
    the exit-time merge (make_finalize) takes it in, as in the JAX
    package."""
    sj, st, g = shards("rmat7", "ragged")
    srcs = _live_sources(g, 3, seed=1)
    cfg = dict(round="fused", max_rounds=2)
    rj = jc.SsspEngine.build(sj, jc.SsspConfig(**cfg)).solve(srcs)
    rt = tc.SsspEngine.build(st, tc.SsspConfig(**cfg),
                             device="cpu").solve(srcs)
    assert rt.status == "max_rounds" and int(rt.stats.rounds) == 2
    assert_results_equal(rt, rj)
    # the finalize is visible: the raw carry lacks the last delivery
    eng = tc.SsspEngine.build(st, tc.SsspConfig(**cfg), device="cpu")
    carry = eng.round_fn(eng.round_fn(eng.start(srcs)))
    merged = eng._finalize(carry)
    assert bool((merged < carry.dist).any())
