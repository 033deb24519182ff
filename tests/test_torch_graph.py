"""Host data of the PyTorch port against the JAX package: generators,
CSR, reference oracles, partition and Trishla, all exact."""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core.partition as j_part  # noqa: E402
import repro.core.trishla as j_tri  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core.partition as t_part  # noqa: E402
import repro_torch.core.trishla as t_tri  # noqa: E402
import repro_torch.graph as tg  # noqa: E402

GRAPHS = {
    "rmat": dict(fn="rmat_graph", kw=dict(scale=8, edge_factor=4, seed=1)),
    "rmat-directed": dict(fn="rmat_graph",
                          kw=dict(scale=7, edge_factor=6, seed=4,
                                  undirected=False, e_pad=2000)),
    "road": dict(fn="road_grid_graph", kw=dict(side=12, seed=2)),
    "random": dict(fn="random_graph", kw=dict(n=200, m=600, seed=3)),
}


def _pair(name):
    spec = GRAPHS[name]
    return (getattr(jg, spec["fn"])(**spec["kw"]),
            getattr(tg, spec["fn"])(**spec["kw"]))


def _assert_graph_equal(gj, gt):
    assert (gt.n_vertices, gt.n_edges) == (gj.n_vertices, gj.n_edges)
    for a in ("src", "dst", "weight", "row_ptr"):
        ref = np.asarray(getattr(gj, a))
        got = getattr(gt, a).numpy()
        assert got.dtype == ref.dtype, a
        np.testing.assert_array_equal(got, ref, err_msg=a)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generators_match_reference(name):
    gj, gt = _pair(name)
    _assert_graph_equal(gj, gt)
    np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))


def test_preset_matches_reference():
    _assert_graph_equal(jg.preset_graph("scale-1e5"),
                        tg.preset_graph("scale-1e5"))
    assert tg.SCALE_PRESETS == jg.SCALE_PRESETS
    assert set(tg.GENERATORS) <= set(jg.GENERATORS)
    with pytest.raises(KeyError):
        tg.get_generator("nope")


def test_csr_from_coo_dedups_like_reference():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 30, 400)
    dst = rng.integers(0, 30, 400)
    w = rng.uniform(1, 20, 400).astype(np.float32)
    for dedup in (True, False):
        _assert_graph_equal(jg.csr_from_coo(src, dst, w, 30, dedup=dedup),
                            tg.csr_from_coo(src, dst, w, 30, dedup=dedup))


def test_graph_from_arrays_round_trip():
    gj, _ = _pair("road")
    gt = tg.graph_from_arrays(gj.src, gj.dst, gj.weight, gj.row_ptr,
                              gj.n_vertices, gj.n_edges)
    _assert_graph_equal(gj, gt)
    for a, b in zip(jg.structure.graph_to_numpy(gj), tg.graph_to_numpy(gt)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["rmat", "road", "rmat-directed"])
def test_oracles_match_reference(name):
    gj, gt = _pair(name)
    for s in (0, 5, gt.n_vertices - 1):
        np.testing.assert_array_equal(tg.dijkstra_reference(gt, s),
                                      jg.dijkstra_reference(gj, s))
        np.testing.assert_array_equal(tg.bellman_ford_reference(gt, s),
                                      jg.bellman_ford_reference(gj, s))


@pytest.mark.parametrize("P", [1, 3, 8])
def test_partition_matches_reference(P):
    gj, gt = _pair("random")
    pj, pt = j_part.partition_1d(gj, P), t_part.partition_1d(gt, P)
    assert (pt.block, pt.n_parts) == (pj.block, pj.n_parts)
    for f in ("src_local", "dst_global", "dst_owner", "dst_local", "weight",
              "valid", "is_cut"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(pj, f)), err_msg=f)
    np.testing.assert_array_equal(t_part.inter_edge_counts(pt),
                                  j_part.inter_edge_counts(pj))


def _trishla_inputs(P=3, e_all=40, T=25, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(1, 20, (P, e_all)).astype(np.float32)
    w[:, -3:] = np.inf
    uj, ui, ij = (rng.integers(0, e_all, (P, T)).astype(np.int32)
                  for _ in range(3))
    valid = rng.random((P, T)) < 0.8
    pruned = rng.random((P, e_all)) < 0.1
    return w, pruned, uj, ui, ij, valid


def test_prune_pass_and_offline_match_reference():
    w, pruned, uj, ui, ij, valid = _trishla_inputs()
    t = [torch.from_numpy(a) for a in (w, pruned, uj, ui, ij, valid)]
    got = t_tri.prune_pass(*t).numpy()
    off = t_tri.prune_offline(t[0][:, :30], t[0][:, 30:], *t[2:],
                              n_passes=2).numpy()
    for p in range(w.shape[0]):
        ref = j_tri.prune_pass(jnp.asarray(w[p]), jnp.asarray(pruned[p]),
                               uj[p], ui[p], ij[p], valid[p])
        np.testing.assert_array_equal(got[p], np.asarray(ref))
        ref_off = j_tri.prune_offline(jnp.asarray(w[p, :30]),
                                      jnp.asarray(w[p, 30:]), uj[p], ui[p],
                                      ij[p], valid[p], n_passes=2)
        np.testing.assert_array_equal(off[p], np.asarray(ref_off))


@pytest.mark.parametrize("chunk", [4, 64])
def test_prune_chunk_matches_reference(chunk):
    w, pruned, uj, ui, ij, valid = _trishla_inputs(seed=chunk)
    cursor = np.array([0, 7, 24], np.int32)
    t = [torch.from_numpy(a) for a in (w, pruned)]
    got = t_tri.prune_chunk(*t, torch.from_numpy(cursor),
                            *[torch.from_numpy(a) for a in (uj, ui, ij, valid)],
                            chunk)
    for p in range(w.shape[0]):
        ref = j_tri.prune_chunk(jnp.asarray(w[p]), jnp.asarray(pruned[p]),
                                jnp.int32(cursor[p]), uj[p], ui[p], ij[p],
                                valid[p], chunk)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a[p].numpy(), np.asarray(b))
