"""The reference's per-shard kernel wrappers, oracles and public names in
the PyTorch port, against the JAX package.

The four wrappers (``send_pack_pallas``, ``merge_scatter_pallas``,
``relax_fixpoint_batch_pallas``, ``relax_fixpoint_batch_ragged_pallas``)
take one shard's layout of a small R-MAT, dense and ragged, and seeded
rows; the JAX side runs its Pallas kernels in interpret mode. The oracles
``send_pack_ref`` and ``merge_scatter_ref`` take the same flat arrays.
Tolerance zero. Then every name ROADMAP item 5b lists, and the
``ogbn-products`` loader on a tiny edge index written to a temporary
directory.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax.numpy as jnp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro.kernels.merge as jmerge  # noqa: E402
import repro.kernels.relax as jrelax  # noqa: E402
import repro.kernels.send as jsend  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
import repro_torch.kernels.merge as tmerge  # noqa: E402
import repro_torch.kernels.relax as trelax  # noqa: E402
import repro_torch.kernels.send as tsend  # noqa: E402

TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
K = 3
SHARD = 2


def _shards(layout):
    kw = dict(scale=7, edge_factor=6, seed=4)
    opts = dict(layout=layout, enumerate_triangles=False, **TILE)
    return (jc.build_shards(jg.rmat_graph(**kw), 4, **opts),
            tc.build_shards(tg.rmat_graph(**kw), 4, **opts))


def _row(sh, name):
    return getattr(sh, name)[SHARD]


def _pair(a):
    """A numpy array as (jax, torch)."""
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _equal(got, want):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _dist(rng, n):
    d = rng.uniform(0, 40, (K, n)).astype(np.float32)
    d[rng.random((K, n)) < 0.3] = np.inf
    return d


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_send_pack_pallas_and_oracle_match_reference(layout):
    sj, st = _shards(layout)
    rng = np.random.default_rng(1)
    S = sj.n_slots
    dj, dt = _pair(_dist(rng, sj.block))
    last = rng.uniform(0, 60, (K, S)).astype(np.float32)
    last[rng.random((K, S)) < 0.5] = np.inf
    lj, lt = _pair(last)
    pruned = rng.random(sj.e_cut) < 0.1
    lay_j = tuple(a[SHARD] for a in sj.send_layout)
    lay_t = tuple(a[SHARD] for a in st.send_layout)
    pt_j = jnp.take(jnp.asarray(pruned, jnp.int32), lay_j[3], mode="fill",
                    fill_value=0)
    pt_t = torch.from_numpy(np.array(pt_j))
    ctile = 4 if layout == "ragged" else None
    want = jsend.send_pack_pallas(
        dj, lj, _row(sj, "slot_valid"), *lay_j[:3], pt_j,
        None if ctile is None else lay_j[ctile], sb=32, eb=64)
    got = tsend.send_pack_pallas(
        dt, lt, _row(st, "slot_valid"), *lay_t[:3], pt_t,
        None if ctile is None else lay_t[ctile], sb=32, eb=64)
    _equal(got, want)
    # the oracle on the flat cut edges (the pruned edges at +inf)
    w_cut = np.where(pruned, np.inf, np.asarray(_row(sj, "cut_w")))
    args_j = (dj, _row(sj, "cut_src"), jnp.asarray(w_cut),
              _row(sj, "cut_seg"), S, _row(sj, "slot_valid"), lj)
    args_t = (dt, _row(st, "cut_src"), torch.from_numpy(w_cut),
              _row(st, "cut_seg"), S, _row(st, "slot_valid"), lt)
    ref_t = tsend.send_pack_ref(*args_t)
    _equal(ref_t, jsend.send_pack_ref(*args_j))
    _equal(got, ref_t)


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_merge_scatter_pallas_and_oracle_match_reference(layout):
    sj, st = _shards(layout)
    rng = np.random.default_rng(2)
    dj, dt = _pair(_dist(rng, sj.block))
    M = sj.n_parts * sj.bucket_cap
    inc = rng.uniform(0, 40, (K, M)).astype(np.float32)
    inc[rng.random((K, M)) < 0.4] = np.inf
    ridx = np.asarray(_row(sj, "recv_idx")).reshape(-1)
    inc[:, ridx >= sj.block] = np.inf        # no sender owns those slots
    ij, it = _pair(inc)
    lay_j = tuple(a[SHARD] for a in sj.merge_layout)
    lay_t = tuple(a[SHARD] for a in st.merge_layout)
    want = jmerge.merge_scatter_pallas(dj, ij, *lay_j, vb=32, eb=64)
    got = tmerge.merge_scatter_pallas(dt, it, *lay_t, vb=32, eb=64)
    _equal(got, want)
    ref_t = tmerge.merge_scatter_ref(dt, it, torch.from_numpy(ridx.copy()))
    _equal(ref_t, jmerge.merge_scatter_ref(dj, ij, jnp.asarray(ridx)))
    _equal(got, ref_t)


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_relax_fixpoint_batch_wrappers_match_reference(layout):
    sj, st = _shards(layout)
    rng = np.random.default_rng(3)
    lay_j = tuple(a[SHARD] for a in sj.relax_layout)
    lay_t = tuple(a[SHARD] for a in st.relax_layout)
    bp = -(-sj.block // 32) * 32
    dist = np.full((K, bp), np.inf, np.float32)
    front = np.zeros((K, bp), np.float32)
    for k in range(K):
        v = rng.choice(sj.block, 4, replace=False)
        dist[k, v] = rng.uniform(0, 10, 4)
        front[k, v] = 1
    dj, dt = _pair(dist)
    fj, ft = _pair(front)
    pruned = rng.random(sj.e_loc) < 0.1
    pt_j = jnp.take(jnp.asarray(pruned, jnp.int32), lay_j[3], mode="fill",
                    fill_value=0)
    pt_t = torch.from_numpy(np.array(pt_j))
    kw = dict(vb=32, eb=64, n_sweeps=3)
    if layout == "dense":
        want = jrelax.relax_fixpoint_batch_pallas(dj, fj, *lay_j[:3], pt_j,
                                                  **kw)
        got = trelax.relax_fixpoint_batch_pallas(dt, ft, *lay_t[:3], pt_t,
                                                 **kw)
    else:
        want = jrelax.relax_fixpoint_batch_ragged_pallas(
            dj, fj, lay_j[4], *lay_j[:3], pt_j, **kw)
        got = trelax.relax_fixpoint_batch_ragged_pallas(
            dt, ft, lay_t[4], *lay_t[:3], pt_t, **kw)
    _equal(got, want)
    # row 0 of the P-stacked kernel, bit for bit
    stack = tuple(a[SHARD:SHARD + 1] for a in st.relax_layout)
    if layout == "dense":
        rows = trelax.relax_dst_tiled_fixpoint_batch(
            dt[None], ft[None], *stack[:3], pt_t[None], vb=32, n_sweeps=3)
    else:
        rows = trelax.relax_dst_ragged_fixpoint_batch(
            dt[None], ft[None], stack[4], *stack[:3], pt_t[None], vb=32,
            n_sweeps=3)
    _equal(got, tuple(np.asarray(r[0]) for r in rows))


NAMES = {
    "repro_torch.core.local_solver": [
        "LocalResult", "local_fixpoint", "local_fixpoint_batch",
        "local_fixpoint_bellman", "local_fixpoint_delta",
        "local_fixpoint_pallas", "local_fixpoint_pallas_batch"],
    "repro_torch.core": ["sim_phase_fns"],
    "repro_torch.core.sssp": ["sim_phase_fns"],
    "repro_torch.core.trishla": ["effective_weights"],
    "repro_torch.core.toka": ["empty_token"],
    "repro_torch.distributed.collectives": ["axis_sizes"],
    "repro_torch.graph.structure": ["INF", "PartitionedGraph"],
    "repro_torch.graph": ["PartitionedGraph", "ogbn_products_graph"],
    "repro_torch.graph.generators": ["PAPER_GRAPHS", "ogbn_products_graph"],
    "repro_torch.kernels.round.round": ["INF"],
    "repro_torch.kernels.send": ["send_pack_pallas", "send_pack_ref"],
    "repro_torch.kernels.merge": ["merge_scatter_pallas",
                                  "merge_scatter_ref"],
    "repro_torch.kernels.relax": ["relax_fixpoint_batch_pallas",
                                  "relax_fixpoint_batch_ragged_pallas"],
}


def test_item_5b_names_exist_and_agree():
    import importlib
    for mod, names in NAMES.items():
        m = importlib.import_module(mod)
        for name in names:
            assert hasattr(m, name), (mod, name)
            ref = importlib.import_module(mod.replace("repro_torch",
                                                      "repro"))
            assert hasattr(ref, name), (mod, name)
    from repro_torch.core.partition import PartitionedGraph as PG
    assert tg.PartitionedGraph is PG
    assert isinstance(tc.partition_1d(tg.random_graph(n=20, m=40), 2), PG)
    import repro.graph.generators as jgen
    import repro_torch.graph.generators as tgen
    assert tgen.PAPER_GRAPHS == jgen.PAPER_GRAPHS
    assert "ogbn-products" in tg.GENERATORS
    # the small pure functions against the reference's
    import repro.core.toka as jtoka
    import repro.core.trishla as jtri
    import repro_torch.core.toka as ttoka
    import repro_torch.core.trishla as ttri
    rng = np.random.default_rng(4)
    lw = rng.uniform(1, 5, 6).astype(np.float32)
    cw = rng.uniform(1, 5, 4).astype(np.float32)
    pr = rng.random(10) < 0.4
    np.testing.assert_array_equal(
        ttri.effective_weights(*(torch.from_numpy(a) for a in (lw, cw, pr))
                               ).numpy(),
        np.asarray(jtri.effective_weights(lw, cw, pr)))
    for a, b in zip(ttoka.empty_token(), jtoka.empty_token(), strict=True):
        assert a.item() == np.asarray(b).item()
    from repro_torch.distributed.collectives import AxisGroup, axis_sizes
    assert axis_sizes(AxisGroup(None, 0, 6, "gloo", (2, 3))) == (2, 3)
    assert axis_sizes(AxisGroup(None, 0, 4, "gloo")) == (4,)


@pytest.mark.parametrize("transposed", [False, True])
def test_ogbn_products_loader_matches_reference(tmp_path, transposed):
    rng = np.random.default_rng(5)
    ei = rng.integers(0, 50, (2, 120)).astype(np.int64)
    np.save(tmp_path / "edge.npy", ei.T if transposed else ei)
    gt = tg.ogbn_products_graph(str(tmp_path))
    gj = jg.ogbn_products_graph(str(tmp_path))
    assert (gt.n_vertices, gt.n_edges) == (gj.n_vertices, gj.n_edges)
    for f in ("src", "dst", "weight", "row_ptr"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    assert tg.get_generator("ogbn-products") is tg.ogbn_products_graph
    with pytest.raises(FileNotFoundError, match="edge.npy"):
        tg.ogbn_products_graph(str(tmp_path / "missing"))
