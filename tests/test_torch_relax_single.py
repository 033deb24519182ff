"""The standalone kernel API of the single-query relax kernels in the
PyTorch port: the layout builders' ``with_eid`` tuples, ``relax_pallas``
(kernel 11), ``relax_masked_pallas`` (10), ``relax_fixpoint_pallas`` (9),
``relax_ref`` and ``relax_jnp``, each against the JAX package on the
reference tests' own cases.

On the CPU the wrappers run their plain PyTorch versions, held here against
the Pallas kernels in interpret mode with tolerance zero for every output
(distances, residual frontier, counts): the same fp32 adds and exact mins
in the same chunk order. ``relax_ref`` / ``relax_jnp`` are held to zero as
well: each candidate is one fp32 add and the scatter-min is exact, so no
order of evaluation can change a bit. The CUDA kernels are held against
their plain versions on the card by ``test_torch_gpu.py``.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro.kernels.relax as j_relax  # noqa: E402
from repro.core.local_solver import local_fixpoint_bellman  # noqa: E402
from repro.graph.structure import graph_to_numpy  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import take_fill  # noqa: E402
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_ragged_layout, build_dst_tiled_layout, relax_fixpoint_pallas,
    relax_jnp, relax_masked_pallas, relax_pallas, relax_ref)

INF = np.float32(np.inf)


def t(a):
    return torch.from_numpy(np.array(a))


def _edges(n, m, seed):
    return graph_to_numpy(jg.random_graph(n, m, seed=seed))


def _random_state(n, m, seed):
    """tests/test_pallas_solver.py's state: a random graph, dist U[0, 50)
    with 30% +inf, a 50% frontier and a 20% Trishla mask."""
    rng = np.random.default_rng(seed)
    src, dst, w = _edges(n, m, seed)
    dist = rng.uniform(0, 50, n).astype(np.float32)
    dist[rng.random(n) < 0.3] = INF
    frontier = rng.random(n) < 0.5
    pruned = rng.random(len(src)) < 0.2
    return src, dst, w, dist, frontier, pruned


def _both_tiled(src, dst, w, n, vb, eb, pruned):
    """The port's layout with the gathered Trishla mask, and the JAX
    package's, as tests/test_pallas_solver.py builds it."""
    src_t, w_t, dr_t, eid_t, bp = build_dst_tiled_layout(
        src, dst, w, n, vb=vb, eb=eb, with_eid=True)
    pr_t = take_fill(t(pruned).to(torch.int32), eid_t.reshape(-1),
                     0).reshape(eid_t.shape)
    j_src, j_w, j_dr, j_eid, _ = j_relax.build_dst_tiled_layout(
        src, dst, w, n, vb=vb, eb=eb, with_eid=True)
    j_pr = jnp.take(jnp.asarray(pruned, jnp.int32), j_eid, mode="fill",
                    fill_value=0)
    return (src_t, w_t, dr_t, pr_t), (j_src, j_w, j_dr, j_pr), bp


def _pad(x, bp, fill):
    return np.pad(np.asarray(x, np.float32), (0, bp - len(x)),
                  constant_values=fill)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -------------------------------------------------------- layout builders --

@pytest.mark.parametrize("with_eid", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("n,m,vb,eb", [(100, 400, 128, 128),
                                       (500, 3000, 128, 256),
                                       (300, 900, 32, 64)])
def test_layout_builders_match_reference(n, m, vb, eb, ragged, with_eid):
    """Called the reference's way (``with_eid`` default False, or True),
    the builders return the JAX builders' tuples, field for field."""
    src, dst, w = _edges(n, m, seed=n + m)
    w = w.copy()
    w[::7] = np.inf                         # dropped by both builders
    port = build_dst_ragged_layout if ragged else build_dst_tiled_layout
    ref = (j_relax.build_dst_ragged_layout if ragged
           else j_relax.build_dst_tiled_layout)
    kw = dict(vb=vb, eb=eb)
    if with_eid:
        kw["with_eid"] = True
    got, want = port(src, dst, w, n, **kw), ref(src, dst, w, n, **kw)
    assert len(got) == len(want) == 4 + ragged + with_eid
    assert got[-1] == want[-1]              # block_pad
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype))
        _equal(a, b)


# ------------------------------------------------ kernel 11: relax_pallas --

@pytest.mark.parametrize("n,m,vb,eb", [
    (100, 400, 128, 128), (500, 3000, 128, 256), (257, 900, 128, 512),
    (64, 80, 128, 128),
])
def test_relax_pallas_matches_reference(n, m, vb, eb):
    """tests/test_kernels.py's cases: one sweep equal to the Pallas
    kernel's and to ``relax_ref`` on the flat edges."""
    rng = np.random.default_rng(n)
    src, dst, w = _edges(n, m, seed=n + m)
    dist = rng.uniform(0, 50, n).astype(np.float32)
    dist[rng.random(n) < 0.3] = INF
    src_t, w_t, dr_t, bp = build_dst_tiled_layout(src, dst, w, n, vb=vb,
                                                  eb=eb)
    j_lay = j_relax.build_dst_tiled_layout(src, dst, w, n, vb=vb, eb=eb)
    d = _pad(dist, bp, np.inf)
    before = dict(build.LAUNCHES)
    out = relax_pallas(t(d), src_t, w_t, dr_t, vb=vb, eb=eb)
    assert build.LAUNCHES == before         # CPU tensors: the plain version
    _equal(out, j_relax.relax_pallas(jnp.asarray(d), *j_lay[:3], vb=vb,
                                     eb=eb, interpret=True))
    _equal(out[:n], relax_ref(t(dist), t(src), t(dst), t(w)))
    assert bool((out[:n] < t(dist)).any())


def test_relax_pallas_all_inf_noop():
    src, dst, w = _edges(80, 200, seed=9)
    src_t, w_t, dr_t, bp = build_dst_tiled_layout(src, dst, w, 80)
    out = relax_pallas(torch.full((bp,), INF), src_t, w_t, dr_t)
    assert bool(torch.isinf(out).all())
    j_lay = j_relax.build_dst_tiled_layout(src, dst, w, 80)
    _equal(out, j_relax.relax_pallas(jnp.full((bp,), jnp.inf), *j_lay[:3]))


def test_relax_pallas_on_shard_data():
    """tests/test_kernel_integration.py's case: the local edges of a
    one-shard build, the sweep equal to the JAX package's."""
    g = jg.random_graph(300, 1500, seed=21)
    sh = jc.build_shards(g, 1)
    loc_w = np.asarray(sh.loc_w[0])
    valid = np.isfinite(loc_w)
    edges = (np.asarray(sh.loc_src[0])[valid],
             np.asarray(sh.loc_dst[0])[valid], loc_w[valid])
    rng = np.random.default_rng(0)
    dist = rng.uniform(0, 30, sh.block).astype(np.float32)
    dist[rng.random(sh.block) < 0.4] = INF
    src_t, w_t, dr_t, bp = build_dst_tiled_layout(*edges, sh.block)
    j_lay = j_relax.build_dst_tiled_layout(*edges, sh.block)
    d = _pad(dist, bp, np.inf)
    out = relax_pallas(t(d), src_t, w_t, dr_t)
    _equal(out, j_relax.relax_pallas(jnp.asarray(d), *j_lay[:3]))


def test_relax_pallas_negative_values():
    """Negative distances and weights (outside the solver's contract, in
    the standalone API's): the plain version equals the Pallas kernel."""
    rng = np.random.default_rng(5)
    n, m = 200, 900
    src, dst, _ = _edges(n, m, seed=5)
    w = rng.uniform(-20, 20, len(src)).astype(np.float32)
    dist = rng.uniform(-50, 50, n).astype(np.float32)
    src_t, w_t, dr_t, bp = build_dst_tiled_layout(src, dst, w, n, vb=64,
                                                  eb=128)
    j_lay = j_relax.build_dst_tiled_layout(src, dst, w, n, vb=64, eb=128)
    d = _pad(dist, bp, np.inf)
    out = relax_pallas(t(d), src_t, w_t, dr_t, vb=64, eb=128)
    _equal(out, j_relax.relax_pallas(jnp.asarray(d), *j_lay[:3], vb=64,
                                     eb=128))
    assert bool((out < 0).any())


def test_relax_pallas_rejects_wrong_eb():
    src, dst, w = _edges(80, 200, seed=9)
    src_t, w_t, dr_t, bp = build_dst_tiled_layout(src, dst, w, 80, eb=128)
    with pytest.raises(ValueError, match="eb"):
        relax_pallas(torch.zeros(bp), src_t, w_t, dr_t, eb=512)


# ----------------------------------------- kernel 10: relax_masked_pallas --

@pytest.mark.parametrize("n,m,vb,eb,seed", [
    (100, 400, 128, 128, 0), (500, 3000, 128, 256, 1), (257, 900, 128, 512, 2),
])
def test_relax_masked_pallas_matches_reference(n, m, vb, eb, seed):
    """tests/test_pallas_solver.py's cases: the masked sweep's distances
    and relaxation count equal to the Pallas kernel's."""
    src, dst, w, dist, frontier, pruned = _random_state(n, m, seed)
    lay, j_lay, bp = _both_tiled(src, dst, w, n, vb, eb, pruned)
    d, f = _pad(dist, bp, np.inf), _pad(frontier, bp, 0.0)
    out, nrel = relax_masked_pallas(t(d), t(f), *lay, vb=vb, eb=eb)
    j_out, j_nrel = j_relax.relax_masked_pallas(
        jnp.asarray(d), jnp.asarray(f), *j_lay, vb=vb, eb=eb,
        interpret=True)
    _equal(out, j_out)
    assert nrel.dtype == torch.int32 and nrel.shape == ()
    assert int(nrel) == int(j_nrel) > 0


# ---------------------------------------- kernel 9: relax_fixpoint_pallas --

@pytest.mark.parametrize("n,m,sweeps,seed", [
    (120, 500, 1, 3), (120, 500, 4, 4), (300, 1800, 8, 5), (64, 90, 16, 6),
])
def test_relax_fixpoint_pallas_matches_reference(n, m, sweeps, seed):
    """tests/test_pallas_solver.py's cases: every call of the
    residual-frontier loop equal to the Pallas kernel's (distances,
    residual frontier, count), and the loop's end equal to the bellman
    fixpoint of the JAX package."""
    src, dst, w, dist, frontier, pruned = _random_state(n, m, seed)
    vb, eb = 128, 256
    lay, j_lay, bp = _both_tiled(src, dst, w, n, vb, eb, pruned)
    d, f = t(_pad(dist, bp, np.inf)), t(_pad(frontier, bp, 0.0))
    for _ in range(200):
        want = j_relax.relax_fixpoint_pallas(
            jnp.asarray(d.numpy()), jnp.asarray(f.numpy()), *j_lay, vb=vb,
            eb=eb, n_sweeps=sweeps, interpret=True)
        d, f, nrel = relax_fixpoint_pallas(d, f, *lay, vb=vb, eb=eb,
                                           n_sweeps=sweeps)
        for got, w_ in zip((d, f, nrel), want):
            _equal(got, w_)
        if not bool((f > 0).any()):
            break
    ref = local_fixpoint_bellman(
        jnp.asarray(dist), jnp.asarray(frontier), jnp.asarray(src, jnp.int32),
        jnp.asarray(dst, jnp.int32), jnp.asarray(w), jnp.asarray(pruned),
        max_iters=10_000)
    _equal(d[:n], ref.dist)


# ------------------------------------------------ relax_ref and relax_jnp --

@pytest.mark.parametrize("fn", ["relax_ref", "relax_jnp"])
def test_flat_relax_matches_reference(fn):
    """Sentinel sources (n) gather +inf and sentinel destinations (n) are
    dropped, as ``mode="fill"`` / ``mode="drop"`` do."""
    rng = np.random.default_rng(3)
    n, m = 150, 700
    src, dst, w = _edges(n, m, seed=3)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    src[::11] = n
    dst[::13] = n
    dist = rng.uniform(0, 50, n).astype(np.float32)
    dist[rng.random(n) < 0.3] = INF
    port = {"relax_ref": relax_ref, "relax_jnp": relax_jnp}[fn]
    ref = getattr(j_relax, fn)
    got = port(t(dist), t(src), t(dst), t(w))
    _equal(got, ref(jnp.asarray(dist), jnp.asarray(src), jnp.asarray(dst),
                    jnp.asarray(w)))
    assert got.shape == (n,) and got.dtype == torch.float32


@pytest.mark.parametrize("fn", ["relax_ref", "relax_jnp"])
def test_flat_relax_wraps_negative_indices(fn):
    """An index in [-n, 0) wraps NumPy-style, as ``jnp.take(mode="fill")``
    and ``.at[].min(mode="drop")`` read it; below -n a source gathers +inf
    and a destination is dropped. dist [0, 5, inf, inf], src [0, -3, 1, -9],
    dst [2, -1, -2, 3], w = 1 gives [0, 5, 1, 6] in both packages."""
    dist = np.array([0, 5, INF, INF], np.float32)
    src = np.array([0, -3, 1, -9], np.int32)
    dst = np.array([2, -1, -2, 3], np.int32)
    w = np.ones(4, np.float32)
    port = {"relax_ref": relax_ref, "relax_jnp": relax_jnp}[fn]
    got = port(t(dist), t(src), t(dst), t(w))
    assert got.tolist() == [0.0, 5.0, 1.0, 6.0]
    _equal(got, getattr(j_relax, fn)(jnp.asarray(dist), jnp.asarray(src),
                                     jnp.asarray(dst), jnp.asarray(w)))
