"""The relax, send and merge kernels of the PyTorch port.

On the CPU each wrapper runs its plain PyTorch version, held here against
the JAX package's Pallas kernel in interpret mode (exact: the same fp32
adds and exact mins in the same tile and chunk order) and against the JAX
``ref.py`` oracles, for K in {1, 3}. The CUDA kernels are held against
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
import repro.kernels.merge as j_merge  # noqa: E402
import repro.kernels.relax as j_relax  # noqa: E402
import repro.kernels.send as j_send  # noqa: E402
from repro.kernels import tile_reduce as j_tile  # noqa: E402
from repro_torch.kernels import build, tile_reduce  # noqa: E402
from repro_torch.kernels.merge import (build_msg_tiled_layout,  # noqa: E402
                                       merge_scatter)
from repro_torch.kernels.relax import (  # noqa: E402
    fixpoint_operands, relax_dst_tiled_fixpoint_batch,
    relax_dst_tiled_fixpoint_batch_plain)
from repro_torch.kernels.send import (build_slot_tiled_layout,  # noqa: E402
                                      send_pack, send_payload_bucket)

INF = np.float32(np.inf)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- inputs --

@pytest.fixture(scope="module")
def relax_shards():
    """Dense relax layouts with several tiles and chunks per shard."""
    g1 = jg.rmat_graph(scale=8, edge_factor=4, seed=1)
    g2 = jg.rmat_graph(scale=9, edge_factor=8, seed=2)
    return {"P1": jc.build_shards(g1, 1, enumerate_triangles=False),
            "P2": jc.build_shards(g2, 2, enumerate_triangles=False)}


def _relax_state(sh, nq, seed):
    """Random rows and masks for every shard: dist [P, K, block] (30% +inf),
    active frontier on finite entries (query 0 empty when K > 1), pruned
    local edges."""
    rng = np.random.default_rng(seed)
    P, block, e_loc = sh.n_parts, sh.block, sh.loc_src.shape[1]
    dist = rng.uniform(0, 50, (P, nq, block)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = INF
    active = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    if nq > 1:
        active[:, 0] = False
    pruned = rng.random((P, e_loc)) < 0.2
    return dist, active, pruned


def _relax_operands(sh, dist, active, pruned):
    eid = t(np.asarray(sh.rx_eid))
    bp = eid.shape[1] * sh.rx_vb
    d, f, p_t = fixpoint_operands(t(dist), t(active), t(pruned), eid, bp)
    lay = (t(np.asarray(sh.rx_src)), t(np.asarray(sh.rx_w)),
           t(np.asarray(sh.rx_dstrel)))
    return (d, f, *lay, p_t)


# ----------------------------------------------------------------- relax --

@pytest.mark.parametrize("sweeps", [3, 8])
@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("which", ["P1", "P2"])
def test_relax_plain_matches_pallas(relax_shards, which, nq, sweeps):
    sh = relax_shards[which]
    dist, active, pruned = _relax_state(sh, nq, seed=nq * 10 + sweeps)
    args = _relax_operands(sh, dist, active, pruned)
    out = relax_dst_tiled_fixpoint_batch(*args, vb=sh.rx_vb,
                                         n_sweeps=sweeps)
    for p in range(sh.n_parts):
        ref = j_relax.relax_fixpoint_batch_pallas(
            *[jnp.asarray(a[p].numpy()) for a in args], vb=sh.rx_vb,
            eb=sh.rx_eb, n_sweeps=sweeps, interpret=True)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
    assert int(out[2].sum()) > 0


@pytest.mark.parametrize("nq", [1, 3])
def test_relax_fixpoint_matches_ref_oracle(relax_shards, nq):
    """Relaunched to an empty residual from a frontier of every finite
    vertex, the kernel's rows are the min-plus closure that iterating the
    reference's ``relax_ref`` reaches."""
    sh = relax_shards["P1"]
    dist, _, pruned = _relax_state(sh, nq, seed=7)
    args = list(_relax_operands(sh, dist, np.isfinite(dist), pruned))
    for _ in range(100):
        args[0], args[1], _n = relax_dst_tiled_fixpoint_batch_plain(
            *args, vb=sh.rx_vb, n_sweeps=8)
        if not bool(args[1].any()):
            break
    w = np.where(pruned[0], INF, np.asarray(sh.loc_w[0]))
    src, dst = np.asarray(sh.loc_src[0]), np.asarray(sh.loc_dst[0])
    for q in range(nq):
        d = jnp.asarray(dist[0, q])
        while True:
            nd = j_relax.relax_ref(d, src, dst, w)
            if bool(jnp.all(nd == d)):
                break
            d = nd
        np.testing.assert_array_equal(args[0][0, q, :sh.block].numpy(),
                                      np.asarray(d))


# ------------------------------------------------------------------ send --

def _send_state(n, e, s, nq, seed, P=2):
    """Random cut-edge pack inputs per shard, as the shard contract makes
    them: seg ids sorted, last_sent +inf or a previous candidate."""
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(P):
        seg = np.sort(rng.integers(0, s, e))
        src = rng.integers(0, n, e)
        w = rng.uniform(1, 20, e).astype(np.float32)
        dist = rng.uniform(0, 50, (nq, n)).astype(np.float32)
        dist[rng.random(dist.shape) < 0.3] = INF
        last = rng.uniform(0, 60, (nq, s)).astype(np.float32)
        last[rng.random(last.shape) < 0.5] = INF
        valid = np.zeros(s, bool)
        valid[np.unique(seg)] = True
        pruned = rng.random(e) < 0.2
        shards.append((src, seg, w, dist, last, valid, pruned))
    return shards


def _send_port_inputs(shards, s, sb, eb):
    lays = [build_slot_tiled_layout(src, seg, w, s, sb=sb, eb=eb)
            for src, seg, w, *_ in shards]
    n_chunks = max(lay[0].shape[1] for lay in lays)

    def stack(k, fill):
        return torch.stack([torch.nn.functional.pad(
            lay[k], (0, 0, 0, n_chunks - lay[k].shape[1]), value=fill)
            for lay in lays])

    eid = stack(3, len(shards[0][6]))
    pruned_t = torch.stack([
        torch.from_numpy(np.append(sh[6], False).astype(np.int32))[
            eid[p].long().clamp(max=len(sh[6]))]
        for p, sh in enumerate(shards)])
    return lays, (stack(0, 0), stack(1, float("inf")), stack(2, 0), pruned_t)


@pytest.mark.parametrize("nq", [1, 3])
def test_send_plain_matches_pallas_and_ref(nq):
    n, e, s, sb, eb = 300, 600, 200, 128, 256
    shards = _send_state(n, e, s, nq, seed=nq)
    lays, layout = _send_port_inputs(shards, s, sb, eb)
    dist = t(np.stack([sh[3] for sh in shards]))
    last = t(np.stack([sh[4] for sh in shards]))
    valid = t(np.stack([sh[5] for sh in shards]))
    out = send_pack(dist, last, valid, *layout, sb=sb)
    for p, (src, seg, w, d, lst, v, pr) in enumerate(shards):
        jl = j_send.build_slot_tiled_layout(src, seg, w, s, sb=sb, eb=eb)
        for a, b in zip(lays[p][:4], jl[:4]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        nch = jl[0].shape[1]
        ref = j_send.send_pack_pallas(
            jnp.asarray(d), jnp.asarray(lst), jnp.asarray(v),
            *[jnp.asarray(a[p, :, :nch].numpy()) for a in layout], sb=sb,
            eb=eb, interpret=True)
        oracle = j_send.send_pack_ref(
            jnp.asarray(d), src.astype(np.int32), np.where(pr, INF, w),
            seg.astype(np.int32), s, jnp.asarray(v), jnp.asarray(lst))
        for got, want, want2 in zip(out, ref, oracle):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want2))
    assert int(out[2].sum()) > 0


def test_payload_gather_matches_reference():
    rng = np.random.default_rng(3)
    P, nq, S, C = 3, 2, 20, 9
    send_val = rng.uniform(0, 9, (P, nq, S)).astype(np.float32)
    slot = rng.integers(0, S + 1, (P, P, C)).astype(np.int32)
    got = send_payload_bucket(t(send_val), t(slot)).numpy()
    for p in range(P):
        np.testing.assert_array_equal(
            got[p], np.asarray(j_send.send_payload_bucket(
                jnp.asarray(send_val[p]), jnp.asarray(slot[p]))))


# ----------------------------------------------------------------- merge --

def _merge_state(block, Pn, C, nq, seed, P=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(P):
        ridx = rng.integers(0, block + block // 3, (Pn, C))
        ridx[ridx >= block] = block          # sentinel = no message
        dist = rng.uniform(0, 50, (nq, block)).astype(np.float32)
        dist[rng.random(dist.shape) < 0.3] = INF
        inc = rng.uniform(0, 60, (nq, Pn * C)).astype(np.float32)
        inc[rng.random(inc.shape) < 0.4] = INF
        inc[:, ridx.reshape(-1) >= block] = INF   # nobody sends there
        out.append((ridx, dist, inc))
    return out


@pytest.mark.parametrize("nq", [1, 3])
def test_merge_plain_matches_pallas_and_ref(nq):
    block, Pn, C, vb, eb = 300, 4, 150, 128, 128
    shards = _merge_state(block, Pn, C, nq, seed=nq)
    lays = [build_msg_tiled_layout(r, block, vb=vb, eb=eb)
            for r, _, _ in shards]
    n_chunks = max(lay[0].shape[1] for lay in lays)
    layout = [torch.stack([torch.nn.functional.pad(
        lay[k], (0, 0, 0, n_chunks - lay[k].shape[1])) for lay in lays])
        for k in range(3)]
    dist = t(np.stack([d for _, d, _ in shards]))
    inc = t(np.stack([i for _, _, i in shards]))
    out = merge_scatter(dist, inc, *layout, vb=vb)
    for p, (ridx, d, i) in enumerate(shards):
        jl = j_merge.build_msg_tiled_layout(ridx, block, vb=vb, eb=eb)
        for a, b in zip(lays[p][:3], jl[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        nch = jl[0].shape[1]
        ref = j_merge.merge_scatter_pallas(
            jnp.asarray(d), jnp.asarray(i),
            *[jnp.asarray(a[p, :, :nch].numpy()) for a in layout], vb=vb,
            eb=eb, interpret=True)
        oracle = j_merge.merge_scatter_ref(jnp.asarray(d), jnp.asarray(i),
                                           ridx.reshape(-1).astype(np.int32))
        for got, want, want2 in zip(out, ref, oracle):
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))
            np.testing.assert_array_equal(got[p].numpy(), np.asarray(want2))
    assert int(out[2].sum()) > 0


# ----------------------------------------------------- shared primitive --

@pytest.mark.parametrize("nq", [1, 3])
def test_tile_min_matches_reference(nq):
    rng = np.random.default_rng(nq)
    cand = rng.uniform(0, 9, (nq, 64)).astype(np.float32)
    cand[rng.random(cand.shape) < 0.3] = INF
    rel = rng.integers(0, 16, 64).astype(np.int32)
    got = tile_reduce.tile_min_batch(t(cand), t(rel), width=16).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        j_tile.tile_min_batch(jnp.asarray(cand), jnp.asarray(rel), width=16)))
    np.testing.assert_array_equal(
        tile_reduce.tile_min(t(cand[0]), t(rel), width=16).numpy(),
        np.asarray(j_tile.tile_min(jnp.asarray(cand[0]), jnp.asarray(rel),
                                   width=16)))


def test_cpu_tensors_take_the_plain_version(relax_shards):
    """CPU tensors never load a kernel library nor count a launch."""
    before = dict(build.LAUNCHES)
    sh = relax_shards["P1"]
    args = _relax_operands(sh, *_relax_state(sh, 2, seed=1))
    relax_dst_tiled_fixpoint_batch(*args, vb=sh.rx_vb, n_sweeps=2)
    assert build.LAUNCHES == before
    assert not build._LIBS
