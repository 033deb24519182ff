"""Engine solves on shards built without tile layouts, the PyTorch port
against the JAX package.

Each package builds its own shards from the same seeded graph with
``relax_layout=False`` and/or ``comm_layout=False``; both engines solve
them under one config dict. The kernel backends the config names fall
back as the reference's do (``local_solver.pallas.no_layout``,
``send.pallas.no_layout``, ``merge.pallas.no_layout``,
``round.fused.no_layout``), and the results are equal: distances bit for
bit, all 13 ``SsspStats`` counters, ``status``, ``q_converged`` and
``q_relaxations``. One case runs the port's ``shmap`` backend on two gloo
ranks against the same JAX solve.
"""
import warnings

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as dref  # noqa: E402
import repro.core as jc  # noqa: E402
import repro.core.phases as jphases  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.phases as tphases  # noqa: E402
import repro_torch.graph as tg  # noqa: E402

ALL = dict(local_solver="pallas", send_backend="pallas",
           merge_backend="pallas")
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
NONE = dict(relax_layout=False, comm_layout=False)
KEYS = ("local_solver.pallas.no_layout", "send.pallas.no_layout",
        "merge.pallas.no_layout", "round.fused.no_layout")
GRAPH = ("rmat_graph", dict(scale=7, edge_factor=6, seed=4))
SOURCES = [0, 9, 40]
# (P, layout, build options, config, faults)
CASES = {
    "P4-dense-all": (4, "dense", NONE, ALL, None),
    "P4-ragged-fused": (4, "ragged", NONE, dict(ALL, round="fused"), None),
    "P1-dense-pallas-solver": (1, "dense", NONE,
                               dict(local_solver="pallas"), None),
    "P1-ragged-fused": (1, "ragged", NONE, dict(ALL, round="fused"), None),
    "P4-dense-no-comm-fused": (4, "dense", dict(comm_layout=False),
                               dict(ALL, round="fused"), None),
    "P4-ragged-no-relax": (4, "ragged", dict(relax_layout=False), ALL, None),
    "P4-dense-async-toka3": (4, "dense", NONE,
                             dict(ALL, exchange="async_bucket", toka="toka3"),
                             None),
    "P4-ragged-drop": (4, "ragged", NONE, dict(ALL, toka="toka3"),
                       dict(drop=0.3, seed=0, resend_period=4)),
}


def _solve(pkg, P, layout, opts, cfg, faults, sources=SOURCES):
    mod, gmod = (jc, jg) if pkg == "jax" else (tc, tg)
    fn, kw = GRAPH
    sh = mod.build_shards(getattr(gmod, fn)(**kw), P, layout=layout,
                          enumerate_triangles=(layout == "dense"), **opts,
                          **TILE)
    c = dict(cfg)
    if faults:
        c["faults"] = mod.FaultPlan(**faults)
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return mod.SsspEngine.build(sh, mod.SsspConfig(**c), **extra).solve(
        sources)


def assert_same(rt, rj):
    np.testing.assert_array_equal(rt.dist, np.asarray(rj.dist))
    for f in dref.COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(rt.stats, f)),
                                      np.asarray(getattr(rj.stats, f)),
                                      err_msg=f)
    assert rt.status == rj.status
    np.testing.assert_array_equal(np.asarray(rt.q_converged),
                                  np.asarray(rj.q_converged))
    np.testing.assert_array_equal(np.asarray(rt.q_relaxations),
                                  np.asarray(rj.q_relaxations))


def _fallbacks(solve):
    """(result, the fallback warnings ``solve()`` raised), with the four
    keys cleared first in both packages."""
    for ph in (tphases, jphases):
        ph._WARNED.difference_update(KEYS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = solve()
    return res, sorted(str(w.message) for w in caught
                       if "falling back" in str(w.message))


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_layout_solve_matches_reference(case):
    """Equal results, and the same fallback warnings with the reference's
    words, each once: a second solve of the port warns no more. The
    all-kernel fused config on shards without any layout takes all
    four."""
    P, layout, opts, cfg, faults = CASES[case]
    rj, warned_j = _fallbacks(lambda: _solve("jax", P, layout, opts, cfg,
                                             faults))
    rt, warned_t = _fallbacks(lambda: _solve("torch", P, layout, opts, cfg,
                                             faults))
    assert rt.status == "converged"
    assert_same(rt, rj)
    assert warned_t == warned_j and warned_t
    if opts == NONE and cfg.get("round") == "fused":
        assert len(warned_t) == 4
    with warnings.catch_warnings(record=True) as again:
        warnings.simplefilter("always")
        assert_same(_solve("torch", P, layout, opts, cfg, faults), rj)
    assert not [w for w in again if "falling back" in str(w.message)]


def test_dispatches_follow_the_resolved_round():
    """``round="fused"`` on shards without the layouts runs staged: four
    dispatches a round, as the reference counts them."""
    fn, kw = GRAPH
    cfg = tc.SsspConfig(round="fused")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for opts, want in ((NONE, 4), (dict(relax_layout=False), 4),
                           ({}, 2)):
            sh = tc.build_shards(getattr(tg, fn)(**kw), 4, **opts, **TILE)
            shj = jc.build_shards(getattr(jg, fn)(**kw), 4, **opts, **TILE)
            assert tc.sssp.dispatches_per_round(sh, cfg) == want
            assert jc.sssp.dispatches_per_round(
                shj, jc.SsspConfig(round="fused")) == want


def _nolayout_scenario():
    return dict(shards="nolayout", sources=SOURCES,
                cfg=dict(ALL, round="fused", toka="toka2"))


def test_shmap_on_no_layout_shards_matches_reference(tmp_path):
    """Two gloo ranks, one no-layout shard each (the all-kernel fused
    config falls back to the staged plain pipeline): equal to the sim
    engine and to the JAX engine on the JAX package's no-layout shards."""
    sc = _nolayout_scenario()
    per_rank, sim = dref.run_ranks(dref.rank_scenarios, tmp_path, [sc],
                                   world=2, meanwhile=lambda: [
                                       dref.sim_scenario(sc)])
    for res in per_rank:
        dref.assert_same_scenario(res[0], sim[0])
    g = jg.random_graph(**dref.NOLAYOUT_GRAPH)
    shj = jc.build_shards(g, 2, relax_layout=False, comm_layout=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        rj = jc.SsspEngine.build(shj, jc.SsspConfig(**sc["cfg"])).solve(
            SOURCES)
    got = per_rank[0][0]["results"][0]
    np.testing.assert_array_equal(got["dist"], np.asarray(rj.dist))
    for f in dref.COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(got["stats"], f)),
                                      np.asarray(getattr(rj.stats, f)),
                                      err_msg=f)
    assert got["status"] == rj.status
