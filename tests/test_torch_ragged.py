"""The ragged (CSR-chunked) path of the PyTorch port against the JAX
package: the edge streams, the ragged and stream-built shards (every
field, the three chunk->tile maps included), and each ragged kernel's
plain version against the Pallas ragged kernel in interpret mode. The
tolerance is zero throughout: the same fp32 adds and exact mins in the
same chunk order."""
import dataclasses
import itertools

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jc  # noqa: E402
import repro.graph as jg  # noqa: E402
import repro.kernels.merge as j_merge  # noqa: E402
import repro.kernels.relax as j_relax  # noqa: E402
import repro.kernels.send as j_send  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.kernels.common import chunk_bounds  # noqa: E402
from repro_torch.kernels.merge import (build_msg_ragged_layout,  # noqa: E402
                                       merge_scatter)
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_ragged_layout, fixpoint_operands,
    relax_dst_ragged_fixpoint_batch)
from repro_torch.kernels.send import (build_slot_ragged_layout,  # noqa: E402
                                      send_pack)

INF = np.float32(np.inf)
TILE = dict(relax_vb=32, relax_eb=64, send_sb=32, send_eb=64, merge_vb=32,
            merge_eb=64)
CTILES = ("rx_ctile", "tx_ctile", "mx_ctile")


def t(a):
    return torch.from_numpy(np.array(a))


def _chunks_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for ca, cb in zip(a, b):
        for x, y in zip(ca, cb):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ generators --

@pytest.mark.parametrize("undirected", [True, False])
def test_rmat_edge_stream_matches_reference(undirected):
    kw = dict(scale=7, edge_factor=6, seed=11, undirected=undirected,
              chunk_edges=100)
    _chunks_equal(tg.rmat_edge_stream(**kw), jg.rmat_edge_stream(**kw))


def test_preset_edge_stream_matches_reference():
    nt, ct = tg.preset_edge_stream("scale-1e5", chunk_edges=1 << 14)
    nj, cj = jg.preset_edge_stream("scale-1e5", chunk_edges=1 << 14)
    assert nt == nj == 1 << 13
    _chunks_equal(ct, cj)
    with pytest.raises(KeyError):
        tg.preset_edge_stream("nope")


def test_edge_chunks_of_matches_reference():
    gj = jg.rmat_graph(scale=7, edge_factor=8, seed=3)
    gt = tg.rmat_graph(scale=7, edge_factor=8, seed=3)
    _chunks_equal(tg.edge_chunks_of(gt, chunk_edges=333),
                  jg.edge_chunks_of(gj, chunk_edges=333))


def test_stream_edge_set_independent_of_consumption():
    """Chunk i is the same whether a consumer stops early, interleaves two
    streams or drains one: each chunk has its own counter-keyed RNG."""
    kw = dict(scale=7, edge_factor=6, seed=5, chunk_edges=64)
    full = list(tg.rmat_edge_stream(**kw))
    early = list(itertools.islice(tg.rmat_edge_stream(**kw), 3))
    a, b = tg.rmat_edge_stream(**kw), tg.rmat_edge_stream(**kw)
    mixed = [next(a), next(b), next(b), next(a)]
    _chunks_equal(early, full[:3])
    _chunks_equal(mixed, [full[0], full[0], full[1], full[1]])


# ---------------------------------------------------------------- shards --

def jax_fields(sh):
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
    assert st.layout_bytes() == sj.layout_bytes()


@pytest.fixture(scope="module")
def graphs():
    kw = dict(scale=8, edge_factor=4, seed=1)
    return jg.rmat_graph(**kw), tg.rmat_graph(**kw)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_ragged_shards_match_reference(graphs, P):
    gj, gt = graphs
    sj = jc.build_shards(gj, P, layout="ragged", **TILE)
    st = tc.build_shards(gt, P, layout="ragged", **TILE)
    assert st.layout == "ragged" and all(
        getattr(st, k) is not None for k in CTILES)
    assert_shards_equal(st, sj)
    assert len(st.relax_layout) == len(st.send_layout) == 5
    assert len(st.merge_layout) == 4
    # a dense build of the same graph carries no ctile map
    assert all(getattr(tc.build_shards(gt, P, **TILE), k) is None
               for k in CTILES)


@pytest.mark.parametrize("P", [1, 4, 8])
def test_stream_shards_match_reference(P):
    """``build_shards_stream`` over the scale-1e5 preset's stream equals the
    JAX package's, field for field (default tiles, ragged, no triangles)."""
    nt, ct = tg.preset_edge_stream("scale-1e5", chunk_edges=1 << 14)
    nj, cj = jg.preset_edge_stream("scale-1e5", chunk_edges=1 << 14)
    st = tc.build_shards_stream(ct, nt, P)
    assert_shards_equal(st, jc.build_shards_stream(cj, nj, P))
    assert not bool(st.tri_valid.any())


def test_stream_build_equals_batch_build(graphs):
    _, gt = graphs
    batch = tc.build_shards(gt, 4, layout="ragged", enumerate_triangles=False,
                            **TILE)
    for chunk_edges in (100, 999, 10_000):
        stream = tc.build_shards_stream(
            tg.edge_chunks_of(gt, chunk_edges=chunk_edges), gt.n_vertices, 4,
            **TILE)
        for k, v in batch.arrays().items():
            assert torch.equal(getattr(stream, k), v), (chunk_edges, k)


def test_stream_build_dense_layout_and_dedup(graphs):
    """The stream build dedups like ``csr_from_coo``: a graph streamed twice
    over builds the shards of the graph streamed once, in either layout."""
    gj, gt = graphs
    twice = itertools.chain(tg.edge_chunks_of(gt, 500),
                            tg.edge_chunks_of(gt, 300))
    st = tc.build_shards_stream(twice, gt.n_vertices, 4, layout="dense",
                                **TILE)
    assert_shards_equal(st, jc.build_shards(gj, 4, enumerate_triangles=False,
                                            **TILE))


def _raise_message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("src,dst,w", [
    ([0, 1, 9], [1, -2, 3], [1.0, 1.0, 1.0]),          # endpoints
    ([0, 1, 2], [1, 2, 0], [1.0, np.nan, -3.0]),        # weights
    ([0, 1, 2], [1, 2, 0], [np.inf, 1.0, 2.0]),
])
def test_stream_rejects_bad_input_like_reference(src, dst, w):
    chunk = (np.array(src), np.array(dst), np.array(w, np.float32))
    msg_t = _raise_message(lambda: tc.build_shards_stream(iter([chunk]), 8, 2))
    msg_j = _raise_message(lambda: jc.build_shards_stream(iter([chunk]), 8, 2))
    assert msg_t == msg_j
    with pytest.raises(ValueError, match="unknown layout"):
        tc.build_shards_stream(iter([]), 8, 2, layout="csr")


def test_shards_from_arrays_ragged(graphs):
    gj, gt = graphs
    sj = jc.build_shards(gj, 4, layout="ragged", max_triangles_per_part=50,
                         **TILE)
    st = tc.shards_from_arrays(jax_fields(sj), **jax_static(sj))
    own = tc.build_shards(gt, 4, layout="ragged", max_triangles_per_part=50,
                          **TILE)
    for k, v in own.arrays().items():
        assert torch.equal(getattr(st, k), v), k
    assert_shards_equal(st, sj)
    # the derived tile -> chunk ranges are no field, and follow the device
    assert torch.equal(st.send_bounds, chunk_bounds(st.tx_ctile, st.n_stiles))
    assert "send_bounds" not in st.arrays()
    moved = st.to("cpu")
    assert moved.send_bounds is not st.send_bounds
    bad = jax_fields(sj)
    bad["tx_ctile"] = bad["tx_ctile"][:, ::-1].copy()    # decreasing
    with pytest.raises(ValueError, match="non-decreasing"):
        tc.shards_from_arrays(bad, **jax_static(sj))


def test_chunk_bounds_ranges():
    ctile = t(np.array([[0, 0, 2, 2, 2, 4, 4], [1, 3, 4, 4, 4, 4, 4]],
                       np.int32))
    np.testing.assert_array_equal(chunk_bounds(ctile, 4).numpy(),
                                  [[0, 2, 2, 5, 5], [0, 0, 1, 1, 2]])


# --------------------------------------------------------------- kernels --

def _ragged_stack(lays, fills):
    """Per-shard ragged planes [tc_p, ...] padded to the longest shard with
    ``fills`` and stacked [P, ...], as the shard builders stack them."""
    tc_max = max(lay[0].shape[0] for lay in lays)
    return [torch.stack([torch.nn.functional.pad(
        lay[k], (0, 0) * (lay[k].dim() - 1) + (0, tc_max - lay[k].shape[0]),
        value=fill) for lay in lays]) for k, fill in enumerate(fills)]


def _edges(rng, n, e, hi):
    """e random edges into [0, hi) from [0, n): tiles past ``hi`` get no
    chunk at all."""
    return (rng.integers(0, n, e), rng.integers(0, hi, e),
            rng.uniform(1, 20, e).astype(np.float32))


@pytest.mark.parametrize("nq", [1, 3])
def test_relax_ragged_plain_matches_pallas(nq):
    """Two shards: one with 700 edges and its last two vertex tiles empty,
    one with 150 (so it stacks with sentinel padding chunks); random rows,
    frontier and Trishla mask."""
    rng = np.random.default_rng(nq)
    n, vb, eb, sweeps = 300, 32, 64, 6
    edges = [_edges(rng, n, 700, n - 2 * vb - 10), _edges(rng, n, 150, n)]
    lays = []
    for src, dst, w in edges:
        lay = build_dst_ragged_layout(src, dst, w, n, vb=vb, eb=eb,
                                      with_eid=True)
        ref = j_relax.build_dst_ragged_layout(src, dst, w, n, vb=vb, eb=eb,
                                              with_eid=True)
        for a, b in zip(lay, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        lays.append(lay)
    bp = lays[0][5]
    n_vtiles = bp // vb
    src_r, w_r, dstrel_r, eid_r, ctile = _ragged_stack(
        lays, (bp - 1, float("inf"), 0, 700, n_vtiles))
    assert int(ctile[0].max()) < n_vtiles - 2            # empty last tiles
    assert int(ctile[1, -1]) == n_vtiles                 # sentinel padding
    dist = rng.uniform(0, 50, (2, nq, n)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = INF
    active = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    if nq > 1:
        active[:, 0] = False
    pruned = rng.random((2, 700)) < 0.2
    pruned[1, 150:] = False             # shard 1 has 150 edges
    d, f, p_t = fixpoint_operands(t(dist), t(active), t(pruned), eid_r, bp)
    out = relax_dst_ragged_fixpoint_batch(d, f, ctile, src_r, w_r, dstrel_r,
                                          p_t, vb=vb, n_sweeps=sweeps)
    for p in range(2):
        ref = j_relax.relax_fixpoint_batch_ragged_pallas(
            *[jnp.asarray(a[p].numpy()) for a in (d, f, ctile, src_r, w_r,
                                                  dstrel_r, p_t)],
            vb=vb, eb=eb, n_sweeps=sweeps, interpret=True)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
    assert int(out[2].sum()) > 0


def _send_shard(rng, n, e, s, hi, nq):
    seg = np.sort(rng.integers(0, hi, e))
    src = rng.integers(0, n, e)
    w = rng.uniform(1, 20, e).astype(np.float32)
    dist = rng.uniform(0, 50, (nq, n)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = INF
    last = rng.uniform(0, 60, (nq, s)).astype(np.float32)
    last[rng.random(last.shape) < 0.5] = INF
    valid = np.zeros(s, bool)
    valid[np.unique(seg)] = True
    return src, seg, w, dist, last, valid, rng.random(e) < 0.2


@pytest.mark.parametrize("nq", [1, 3])
def test_send_ragged_plain_matches_pallas_and_ref(nq):
    """Two shards, one whose last slot tiles have no cut edges (their
    slots finalize to +inf with no send), one short enough to stack with
    sentinel padding chunks."""
    rng = np.random.default_rng(10 + nq)
    n, e, s, sb, eb = 300, 600, 200, 32, 64
    shards = [_send_shard(rng, n, e, s, s - 2 * sb - 5, nq),
              _send_shard(rng, n, 90, s, s, nq)]
    lays = [build_slot_ragged_layout(src, seg, w, s, sb=sb, eb=eb)
            for src, seg, w, *_ in shards]
    src_r, w_r, seg_r, eid_r, ctile = _ragged_stack(
        lays, (0, float("inf"), 0, e, -(-s // sb)))
    # each shard's Trishla mask in layout order; padding ids give 0
    pruned_t = torch.stack([t(np.append(sh[6], False).astype(np.int32)[
        np.minimum(eid_r[p].numpy(), len(sh[6]))])
        for p, sh in enumerate(shards)])
    dist = t(np.stack([sh[3] for sh in shards]))
    last = t(np.stack([sh[4] for sh in shards]))
    valid = t(np.stack([sh[5] for sh in shards]))
    out = send_pack(dist, last, valid, src_r, w_r, seg_r, pruned_t, sb=sb,
                    ctile=ctile)
    for p, (src, seg, w, d, lst, v, pr) in enumerate(shards):
        jl = j_send.build_slot_ragged_layout(src, seg, w, s, sb=sb, eb=eb)
        for a, b in zip(lays[p], jl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        ref = j_send.send_pack_pallas(
            jnp.asarray(d), jnp.asarray(lst), jnp.asarray(v),
            *[jnp.asarray(a[p].numpy()) for a in (src_r, w_r, seg_r,
                                                  pruned_t)],
            jnp.asarray(ctile[p].numpy()), sb=sb, eb=eb, interpret=True)
        oracle = j_send.send_pack_ref(
            jnp.asarray(d), src.astype(np.int32), np.where(pr, INF, w),
            seg.astype(np.int32), s, jnp.asarray(v), jnp.asarray(lst))
        for got, want, want2 in zip(out, ref, oracle):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want2))
    assert int(out[2].sum()) > 0
    assert not bool(torch.isfinite(out[0][0, :, s - sb:]).any())


@pytest.mark.parametrize("nq", [1, 3])
def test_merge_ragged_plain_matches_pallas_and_ref(nq):
    """Two shards, one whose receive table addresses none of its last two
    vertex tiles (they keep their distances, frontier empty), one with few
    messages (sentinel padding chunks when stacked)."""
    rng = np.random.default_rng(20 + nq)
    block, Pn, C, vb, eb = 300, 4, 150, 32, 64
    shards = []
    for hi, frac in ((block - 2 * vb - 3, 0.0), (block, 0.9)):
        ridx = rng.integers(0, hi, (Pn, C))
        ridx[rng.random(ridx.shape) < frac] = block     # sentinel = none
        dist = rng.uniform(0, 50, (nq, block)).astype(np.float32)
        dist[rng.random(dist.shape) < 0.3] = INF
        inc = rng.uniform(0, 60, (nq, Pn * C)).astype(np.float32)
        inc[rng.random(inc.shape) < 0.4] = INF
        inc[:, ridx.reshape(-1) >= block] = INF
        shards.append((ridx, dist, inc))
    lays = [build_msg_ragged_layout(r, block, vb=vb, eb=eb)
            for r, _, _ in shards]
    n_vtiles = lays[0][4] // vb
    pos_r, dr_r, valid_r, ctile = _ragged_stack(lays, (0, 0, 0, n_vtiles))
    assert int(ctile[1, -1]) == n_vtiles
    dist = t(np.stack([d for _, d, _ in shards]))
    inc = t(np.stack([i for _, _, i in shards]))
    out = merge_scatter(dist, inc, pos_r, dr_r, valid_r, vb=vb, ctile=ctile)
    for p, (ridx, d, i) in enumerate(shards):
        jl = j_merge.build_msg_ragged_layout(ridx, block, vb=vb, eb=eb)
        for a, b in zip(lays[p], jl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        ref = j_merge.merge_scatter_pallas(
            jnp.asarray(d), jnp.asarray(i),
            *[jnp.asarray(a[p].numpy()) for a in (pos_r, dr_r, valid_r,
                                                  ctile)],
            vb=vb, eb=eb, interpret=True)
        oracle = j_merge.merge_scatter_ref(jnp.asarray(d), jnp.asarray(i),
                                           ridx.reshape(-1).astype(np.int32))
        for got, want, want2 in zip(out, ref, oracle):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want2))
    assert int(out[2].sum()) > 0
    np.testing.assert_array_equal(out[0][0, :, -2 * vb:].numpy(),
                                  shards[0][1][:, -2 * vb:])
