"""Shards of the PyTorch port against the JAX package: every ``SsspShards``
field equal (values, dtype, shape) with triangles enumerated, the
arrays-in constructor, layout bytes and the input checks."""
import dataclasses

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.shards as shards_mod  # noqa: E402
import repro_torch.graph as tg  # noqa: E402

GRAPHS = {
    "rmat": ("rmat_graph", dict(scale=8, edge_factor=4, seed=1)),
    "road": ("road_grid_graph", dict(side=12, seed=2)),
    "random": ("random_graph", dict(n=200, m=600, seed=3)),
}


def _graphs(name):
    fn, kw = GRAPHS[name]
    return getattr(jg, fn)(**kw), getattr(tg, fn)(**kw)


def jax_fields(sh):
    """A JAX ``SsspShards`` read out as numpy (None fields kept)."""
    return {f.name: (None if getattr(sh, f.name) is None
                     else np.asarray(getattr(sh, f.name)))
            for f in dataclasses.fields(sh)
            if f.metadata.get("static") is not True}


def jax_static(sh):
    return {f.name: getattr(sh, f.name) for f in dataclasses.fields(sh)
            if f.metadata.get("static") is True}


def assert_shards_equal(st, sj):
    ref = {k: v for k, v in jax_fields(sj).items() if v is not None}
    got = {k: v.numpy() for k, v in st.arrays().items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for k, v in jax_static(sj).items():
        assert getattr(st, k) == v, k


@pytest.mark.parametrize("P", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_shards_match_reference(name, P):
    gj, gt = _graphs(name)
    sj, st = jc.build_shards(gj, P), tc.build_shards(gt, P)
    assert bool(np.asarray(sj.tri_valid).any())   # triangles enumerated
    assert_shards_equal(st, sj)
    assert st.layout_bytes() == sj.layout_bytes()


def test_shards_from_arrays_equals_own_build():
    gj, gt = _graphs("rmat")
    sj = jc.build_shards(gj, 4, max_triangles_per_part=50)
    st = tc.shards_from_arrays(jax_fields(sj), **jax_static(sj))
    own = tc.build_shards(gt, 4, max_triangles_per_part=50)
    for k, v in own.arrays().items():
        assert torch.equal(getattr(st, k), v), k
    assert_shards_equal(st, sj)


def test_shard_tile_sizes_match_reference():
    gj, gt = _graphs("road")
    kw = dict(relax_vb=32, relax_eb=64, send_sb=16, send_eb=32, merge_vb=32,
              merge_eb=64, enumerate_triangles=False)
    assert_shards_equal(tc.build_shards(gt, 3, **kw),
                        jc.build_shards(gj, 3, **kw))


def test_shards_move_between_devices():
    _, gt = _graphs("random")
    st = tc.build_shards(gt, 2, enumerate_triangles=False)
    back = st.to("cpu")
    assert back.device == torch.device("cpu")
    assert all(torch.equal(a, back.arrays()[k]) for k, a in st.arrays().items())


@pytest.mark.parametrize("bad", [np.nan, -1.0, np.inf])
def test_rejects_bad_weights(bad):
    w = np.array([1.0, bad, 2.0], np.float32)
    g = tg.csr_from_coo(np.array([0, 1, 2]), np.array([1, 2, 0]), w, 3)
    with pytest.raises(ValueError, match="invalid edge weights"):
        tc.build_shards(g, 2)


def test_rejects_out_of_range_endpoints():
    g = tg.graph_from_arrays([0, 1], [1, 7], [1.0, 1.0], [0, 1, 2, 2], 3, 2)
    with pytest.raises(ValueError, match="out-of-range"):
        tc.build_shards(g, 2)


def test_ragged_layout_not_ported():
    """Both entry points take ``layout="ragged"`` (its parity with the JAX
    package is in test_torch_ragged.py); an unknown layout name raises, and
    ragged shards need their chunk->tile maps."""
    _, gt = _graphs("random")
    sh = tc.build_shards(gt, 2, layout="ragged")
    assert sh.layout == "ragged" and sh.rx_ctile is not None
    back = tc.shards_from_arrays(
        {k: v.numpy() for k, v in sh.arrays().items()},
        **{k: getattr(sh, k) for k in shards_mod._STATIC})
    assert all(torch.equal(v, getattr(back, k)) for k, v in sh.arrays().items())
    with pytest.raises(ValueError, match="unknown layout"):
        tc.build_shards(gt, 2, layout="csr")
    with pytest.raises(ValueError, match="unknown layout"):
        tc.shards_from_arrays({}, layout="csr")
    fields = {k: v.numpy() for k, v in sh.arrays().items()
              if k != "tx_ctile"}
    with pytest.raises(ValueError, match="tx_ctile"):
        tc.shards_from_arrays(fields, **{k: getattr(sh, k)
                                         for k in shards_mod._STATIC})


@pytest.mark.parametrize("args", [
    (4, None, True, True, 64),
    (4, None, False, True, 64, 128, True, 32, 256, 64, 128, "dense"),
    (3, 40, True, True, 32, 64, True, 16, 32, 32, 64, "ragged")])
def test_build_shards_takes_the_reference_argument_order(args):
    """A positional call in the reference's order (``relax_layout`` fifth,
    ``comm_layout`` eighth) builds the same tiles in both packages."""
    gj, gt = _graphs("rmat")
    sj, st = jc.build_shards(gj, *args), tc.build_shards(gt, *args)
    assert (st.rx_vb, st.rx_eb) == (sj.rx_vb, sj.rx_eb) == (
        args[4], args[5] if len(args) > 5 else 512)
    assert_shards_equal(st, sj)


def test_build_shards_stream_takes_the_reference_keywords():
    gj, gt = _graphs("road")
    kw = dict(relax_layout=True, relax_vb=32, relax_eb=64, comm_layout=True,
              send_sb=16, send_eb=32, merge_vb=32, merge_eb=64)
    st = tc.build_shards_stream(tg.edge_chunks_of(gt, 100), gt.n_vertices, 3,
                                **kw)
    sj = jc.build_shards_stream(jg.edge_chunks_of(gj, 100), gj.n_vertices,
                                3, **kw)
    assert (st.rx_vb, st.rx_eb, st.tx_sb) == (32, 64, 16)
    assert_shards_equal(st, sj)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("option", ["relax_layout", "comm_layout", "both"])
def test_layout_options_false_raise(option, stream):
    """Shards built without a tile layout (``relax_layout=False``,
    ``comm_layout=False`` or both; the name is from when False raised):
    field for field the JAX package's, None exactly where its fields are
    None, with equal ``layout_bytes()``, dense from ``build_shards`` and
    ragged from ``build_shards_stream``."""
    gj, gt = _graphs("rmat")
    opts = ({"relax_layout": False, "comm_layout": False} if option == "both"
            else {option: False})
    if stream:
        sj = jc.build_shards_stream(jg.edge_chunks_of(gj, 300),
                                    gj.n_vertices, 3, **opts)
        st = tc.build_shards_stream(tg.edge_chunks_of(gt, 300),
                                    gt.n_vertices, 3, **opts)
    else:
        sj, st = jc.build_shards(gj, 3, **opts), tc.build_shards(gt, 3, **opts)
    want_none = {k for k, v in jax_fields(sj).items() if v is None}
    got_none = {f.name for f in dataclasses.fields(st)
                if f.name not in shards_mod._STATIC
                and getattr(st, f.name) is None}
    assert got_none == want_none
    assert ({"rx_src", "rx_eid"} <= got_none) == (option != "comm_layout")
    assert ({"tx_payload_slot", "mx_pos"} <= got_none) == (
        option != "relax_layout")
    assert_shards_equal(st, sj)
    assert st.layout_bytes() == sj.layout_bytes()
    for name in ("relax", "send", "merge"):
        assert getattr(st, f"has_{name}_layout") == getattr(
            sj, f"has_{name}_layout")
        assert (getattr(st, f"{name}_layout") is None) == (
            getattr(sj, f"{name}_layout") is None)
    # the derived views and the device move survive the missing layouts
    assert st.to("cpu").arrays().keys() == st.arrays().keys()
    assert st.shard(1).n_rows == 1
    assert st.round_chunks is None
    assert (st.relax_chunks is None) == (option != "comm_layout" or stream)
    back = tc.shards_from_arrays(jax_fields(sj), **jax_static(sj))
    assert_shards_equal(back, sj)
