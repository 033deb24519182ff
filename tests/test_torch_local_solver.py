"""The local solvers' public entry points of the PyTorch port against the
JAX package's, in the reference's argument lists.

One shard of a small R-MAT and of a road grid (dense and ragged layouts,
built by each package from the same seeded graph), a seeded frontier of
finite distances and a seeded Trishla mask go through the six entry
points of both packages: ``local_fixpoint_bellman``, ``_delta``,
``_pallas``, ``_pallas_batch``, ``local_fixpoint_batch`` (each solver)
and ``local_fixpoint``. ``dist``, ``changed`` and ``relaxations`` are
equal, tolerance zero. The reference's Pallas kernels run in interpret
mode (``interpret=True``, its default), the port's relax kernels as their
plain versions on CPU tensors.
"""
import warnings

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax.numpy as jnp

import repro.core as jc  # noqa: E402
import repro.core.local_solver as jls  # noqa: E402
import repro.core.phases as jphases  # noqa: E402
import repro.graph as jg  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import repro_torch.core.local_solver as tls  # noqa: E402
import repro_torch.core.phases as tphases  # noqa: E402
import repro_torch.graph as tg  # noqa: E402

GRAPHS = {"rmat": ("rmat_graph", dict(scale=8, edge_factor=6, seed=3)),
          "road": ("road_grid_graph", dict(side=14, seed=1))}
VB, EB = 32, 64
P = 3


def _shard(name, layout):
    """Shard 1 of both packages' shards: (jax arrays, torch tensors), each
    a dict of loc_src, loc_dst, loc_w and the per-shard relax layout."""
    fn, kw = GRAPHS[name]
    opts = dict(relax_vb=VB, relax_eb=EB, layout=layout,
                enumerate_triangles=False)
    sj = jc.build_shards(getattr(jg, fn)(**kw), P, **opts)
    st = tc.build_shards(getattr(tg, fn)(**kw), P, **opts)
    out = []
    for sh in (sj, st):
        d = {k: getattr(sh, k)[1] for k in ("loc_src", "loc_dst", "loc_w")}
        d["layout"] = tuple(a[1] for a in sh.relax_layout)
        out.append(d)
    return out[0], out[1], sj.block, sj.e_loc


def _state(block, e_loc, K, seed):
    rng = np.random.default_rng(seed)
    dist = np.full((K, block), np.inf, np.float32)
    active = np.zeros((K, block), bool)
    for k in range(K):
        v = rng.choice(block, size=3, replace=False)
        dist[k, v] = rng.uniform(0, 30, 3).astype(np.float32)
        active[k, v] = True
    pruned = rng.random(e_loc) < 0.05
    return dist, active, pruned


def _equal(rt, rj):
    np.testing.assert_array_equal(rt.dist.numpy(), np.asarray(rj.dist))
    np.testing.assert_array_equal(rt.changed.numpy(), np.asarray(rj.changed))
    np.testing.assert_array_equal(rt.relaxations.numpy(),
                                  np.asarray(rj.relaxations))
    assert rt.relaxations.dtype == torch.int32
    assert rt.changed.dtype == torch.bool


@pytest.mark.parametrize("layout", ["dense", "ragged"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_entry_points_match_reference(name, layout):
    """The single-query entry points on query 0 (K = 1), the batched ones
    on all three (K = 3)."""
    aj, at, block, e_loc = _shard(name, layout)
    dist, active, pruned = _state(block, e_loc, 3, seed=len(name))
    dj, actj, prj = jnp.asarray(dist), jnp.asarray(active), jnp.asarray(pruned)
    dt, actt, prt = (torch.from_numpy(dist), torch.from_numpy(active),
                     torch.from_numpy(pruned))
    ej = (aj["loc_src"], aj["loc_dst"], aj["loc_w"])
    et = (at["loc_src"], at["loc_dst"], at["loc_w"])
    # the single-query entry points, in the reference's positional form
    _equal(tls.local_fixpoint_bellman(dt[0], actt[0], *et, prt, 10_000),
           jls.local_fixpoint_bellman(dj[0], actj[0], *ej, prj, 10_000))
    _equal(tls.local_fixpoint_delta(dt[0], actt[0], *et, prt, 10_000, 2.5),
           jls.local_fixpoint_delta(dj[0], actj[0], *ej, prj, 10_000, 2.5))
    kw = dict(vb=VB, max_iters=10_000, sweeps=2)
    _equal(tls.local_fixpoint_pallas(dt[0], actt[0], prt, at["layout"], **kw),
           jls.local_fixpoint_pallas(dj[0], actj[0], prj, aj["layout"], **kw))
    _equal(tls.local_fixpoint_pallas_batch(dt, actt, prt, at["layout"], **kw),
           jls.local_fixpoint_pallas_batch(dj, actj, prj, aj["layout"], **kw))
    for solver in ("bellman", "delta", "pallas"):
        bkw = dict(solver=solver, delta=3.0, relax_vb=VB, pallas_sweeps=3)
        _equal(tls.local_fixpoint_batch(dt, actt, *et, prt,
                                        relax_layout=at["layout"], **bkw),
               jls.local_fixpoint_batch(dj, actj, *ej, prj,
                                        relax_layout=aj["layout"], **bkw))
    # local_fixpoint is a K=1 batch: one solver a case keeps the file quick
    bkw = dict(solver="pallas" if layout == "ragged" else "delta",
               delta=3.0, relax_vb=VB, pallas_sweeps=3)
    _equal(tls.local_fixpoint(dt[0], actt[0], *et, prt,
                              relax_layout=at["layout"], **bkw),
           jls.local_fixpoint(dj[0], actj[0], *ej, prj,
                              relax_layout=aj["layout"], **bkw))


@pytest.mark.parametrize("solver", ["bellman", "delta", "pallas"])
def test_step_budget_matches_reference(solver):
    """A budget of ``max_iters`` steps (sweeps, for pallas) that ends
    before the fixpoint: the same partial distances and counts."""
    aj, at, block, e_loc = _shard("road", "dense")
    dist, active, pruned = _state(block, e_loc, 3, seed=9)
    kw = dict(solver=solver, max_iters=3, delta=1.5, relax_vb=VB,
              pallas_sweeps=2)
    rt = tls.local_fixpoint_batch(
        torch.from_numpy(dist), torch.from_numpy(active), at["loc_src"],
        at["loc_dst"], at["loc_w"], torch.from_numpy(pruned),
        relax_layout=at["layout"], **kw)
    rj = jls.local_fixpoint_batch(
        jnp.asarray(dist), jnp.asarray(active), aj["loc_src"], aj["loc_dst"],
        aj["loc_w"], jnp.asarray(pruned), relax_layout=aj["layout"], **kw)
    _equal(rt, rj)
    full = tls.local_fixpoint_batch(
        torch.from_numpy(dist), torch.from_numpy(active), at["loc_src"],
        at["loc_dst"], at["loc_w"], torch.from_numpy(pruned),
        relax_layout=at["layout"], **dict(kw, max_iters=10_000))
    assert bool((full.dist <= rt.dist).all())
    assert not torch.equal(full.dist, rt.dist)


def test_pallas_without_layout_falls_back_to_bellman():
    """``solver="pallas"`` with ``relax_layout=None`` warns once, under the
    reference's key, and equals ``bellman``, as the reference's does."""
    aj, at, block, e_loc = _shard("rmat", "dense")
    dist, active, pruned = _state(block, e_loc, 3, seed=5)
    args_t = (torch.from_numpy(dist), torch.from_numpy(active),
              at["loc_src"], at["loc_dst"], at["loc_w"],
              torch.from_numpy(pruned))
    args_j = (jnp.asarray(dist), jnp.asarray(active), aj["loc_src"],
              aj["loc_dst"], aj["loc_w"], jnp.asarray(pruned))
    tphases._WARNED.discard("local_solver.pallas.no_layout")
    jphases._WARNED.discard("local_solver.pallas.no_layout")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [tls.local_fixpoint_batch(*args_t, solver="pallas")
               for _ in range(2)]
        want = jls.local_fixpoint_batch(*args_j, solver="pallas")
    keys = [str(w.message) for w in caught
            if "falling back to 'bellman'" in str(w.message)]
    assert len(keys) == 2            # once per package
    assert keys[0] == keys[1]        # the reference's words
    bellman = tls.local_fixpoint_batch(*args_t, solver="bellman")
    for g in got:
        _equal(g, want)
        _equal(g, jls.local_fixpoint_batch(*args_j, solver="bellman"))
        assert torch.equal(g.dist, bellman.dist)


def test_registry_keys_resolve_to_the_stacked_backends():
    """The engine resolves ``bellman``, ``delta`` and ``pallas`` to the
    stacked ``[P, K, block]`` backends, as before the public names took
    the reference's argument lists."""
    assert tphases.resolve("local_solver", "bellman") is tls._batch_bellman
    assert tphases.resolve("local_solver", "delta") is tls._batch_delta
    assert tphases.resolve("local_solver", "pallas") is tls._batch_pallas
    assert set(tphases.backends("local_solver")) == set(
        jphases.backends("local_solver"))
