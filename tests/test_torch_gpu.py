"""The CUDA kernels of the PyTorch port on the card, against their plain
PyTorch versions (bit-equal), and the engine's card run against its CPU
run. Every test is marked ``gpu`` and skips without a CUDA device.

Kernel 12 (flash attention) is held against its plain version within
2e-5 in f32 (the reference's tolerance, the 3xTF32 kernel) and 2 bf16
ulps in bf16 (the bf16 kernel), not bit for bit: it sums in another
order. This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed; the repository's conftest imports JAX, so run it
there without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import pad_last  # noqa: E402
from repro_torch.kernels.common import chunk_bounds  # noqa: E402
from repro_torch.kernels.common import live_chunks  # noqa: E402
from repro_torch.kernels.merge import (  # noqa: E402
    build_msg_ragged_layout, build_msg_tiled_layout, merge_scatter_ragged,
    merge_scatter_ragged_plain, merge_scatter_tiled,
    merge_scatter_tiled_plain)
from repro_torch.kernels.round import (  # noqa: E402
    fused_round_operands, fused_round_ragged, fused_round_ragged_plain,
    fused_round_tiled, fused_round_tiled_plain)
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_ragged_layout, fixpoint_operands,
    relax_dst_ragged_fixpoint_batch, relax_dst_ragged_fixpoint_batch_plain,
    relax_dst_tiled_fixpoint_batch, relax_dst_tiled_fixpoint_batch_plain)
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_tiled_layout, relax_dst_tiled, relax_dst_tiled_fixpoint,
    relax_dst_tiled_fixpoint_plain, relax_dst_tiled_masked,
    relax_dst_tiled_masked_plain, relax_dst_tiled_plain)
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_p, embedding_bag_p_plain)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_p, flash_attention_p_plain)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention)
from repro_torch.kernels.send import (  # noqa: E402
    build_slot_ragged_layout, build_slot_tiled_layout, send_operands,
    send_pack_ragged,
    send_pack_ragged_plain, send_pack_tiled, send_pack_tiled_plain)

pytestmark = pytest.mark.gpu
ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas")
STAGED = ("relax", "send", "merge")         # the staged round's kernels
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "bytes_moved")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shards():
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    return g, tc.build_shards(g, 2)


def _state(sh, nq, seed):
    """Random rows: dist [P, K, block] (30% +inf), a frontier on finite
    entries (query 0 empty when K > 1), random Trishla masks."""
    rng = np.random.default_rng(seed)
    P, block = sh.n_parts, sh.block
    dist = rng.uniform(0, 50, (P, nq, block)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = np.inf
    active = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    if nq > 1:
        active[:, 0] = False
    pruned = rng.random((P, sh.e_loc + sh.e_cut)) < 0.2
    last = rng.uniform(0, 60, (P, nq, sh.n_slots)).astype(np.float32)
    last[rng.random(last.shape) < 0.5] = np.inf
    return [torch.from_numpy(a) for a in (dist, active, pruned, last)]


def _relax_args(sh, dist, active, pruned, device):
    src_t, w_t, dstrel_t, eid_t = sh.relax_layout
    d, f, p_t = fixpoint_operands(dist, active, pruned[:, :sh.e_loc], eid_t,
                                  src_t.shape[1] * sh.rx_vb)
    return [a.to(device) for a in (d, f, src_t, w_t, dstrel_t, p_t)]


@pytest.mark.parametrize("sweeps", [2, 8])
@pytest.mark.parametrize("nq", [1, 3])
def test_relax_kernel_matches_plain(cuda, shards, nq, sweeps):
    _, sh = shards
    dist, active, pruned, _ = _state(sh, nq, seed=nq)
    args = _relax_args(sh, dist, active, pruned, cuda)
    n0 = build.LAUNCHES["relax"]
    out = relax_dst_tiled_fixpoint_batch(*args, vb=sh.rx_vb, n_sweeps=sweeps)
    ref = relax_dst_tiled_fixpoint_batch_plain(*args, vb=sh.rx_vb,
                                               n_sweeps=sweeps)
    assert build.LAUNCHES["relax"] == n0 + 1
    assert int(out[2].sum()) > 0
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("nq", [1, 3])
def test_send_kernel_matches_plain(cuda, shards, nq):
    _, sh = shards
    dist, _, pruned, last = _state(sh, nq, seed=10 + nq)
    src_t, w_t, segrel_t, eid_t = sh.send_layout
    P = sh.n_parts
    cut = torch.cat([pruned[:, sh.e_loc:].int(),
                     torch.zeros((P, 1), dtype=torch.int32)], 1)
    pruned_t = torch.gather(cut, 1, eid_t.reshape(P, -1).long()
                            ).reshape(eid_t.shape)
    args = [a.to(cuda) for a in (
        *send_operands(dist, last, sh.slot_valid, src_t.shape[1], sh.tx_sb),
        src_t, w_t, segrel_t, pruned_t)]
    n0 = build.LAUNCHES["send"]
    out = send_pack_tiled(*args, sb=sh.tx_sb)
    ref = send_pack_tiled_plain(*args, sb=sh.tx_sb)
    assert build.LAUNCHES["send"] == n0 + 1
    assert int(out[2].sum()) > 0
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("nq", [1, 3])
def test_merge_kernel_matches_plain(cuda, nq):
    rng = np.random.default_rng(nq)
    block, Pn, C, vb = 300, 4, 150, 128
    lays, dists, incs = [], [], []
    for _ in range(2):
        ridx = rng.integers(0, block + block // 3, (Pn, C))
        ridx[ridx >= block] = block
        lays.append(build_msg_tiled_layout(ridx, block, vb=vb, eb=128))
        d = rng.uniform(0, 50, (nq, block)).astype(np.float32)
        d[rng.random(d.shape) < 0.3] = np.inf
        inc = rng.uniform(0, 60, (nq, Pn * C)).astype(np.float32)
        inc[rng.random(inc.shape) < 0.4] = np.inf
        inc[:, ridx.reshape(-1) >= block] = np.inf
        dists.append(d)
        incs.append(inc)
    nch = max(lay[0].shape[1] for lay in lays)
    layout = [torch.stack([torch.nn.functional.pad(
        lay[k], (0, 0, 0, nch - lay[k].shape[1])) for lay in lays])
        for k in range(3)]
    dist = pad_last(torch.from_numpy(np.stack(dists)), 3 * vb, float("inf"))
    args = [a.to(cuda) for a in (dist, torch.from_numpy(np.stack(incs)),
                                 *layout)]
    n0 = build.LAUNCHES["merge"]
    out = merge_scatter_tiled(*args, vb=vb)
    ref = merge_scatter_tiled_plain(*args, vb=vb)
    assert build.LAUNCHES["merge"] == n0 + 1
    assert int(out[2].sum()) > 0
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


def test_kernel_wrappers_reject_bad_operands(cuda, shards):
    _, sh = shards
    dist, active, pruned, _ = _state(sh, 1, seed=2)
    args = _relax_args(sh, dist, active, pruned, cuda)
    args[2] = args[2].long()                    # int64 indices
    with pytest.raises(ValueError, match="relax"):
        relax_dst_tiled_fixpoint_batch(*args, vb=sh.rx_vb, n_sweeps=2)


def test_engine_on_gpu_matches_cpu_and_launches_kernels(cuda, shards):
    g, sh = shards
    rng = np.random.default_rng(2)
    deg = np.diff(g.row_ptr.numpy())
    srcs = [int(s) for s in rng.choice(np.nonzero(deg)[0], 3, replace=False)]
    cfg = tc.SsspConfig(**ALL_KERNELS)
    on_cpu = tc.SsspEngine.build(sh, cfg, device="cpu").solve(srcs)
    build.reset_launches()
    eng = tc.SsspEngine.build(sh, cfg)               # cuda by default
    on_gpu = eng.solve(srcs)
    assert eng.device.type == "cuda"
    assert min(build.LAUNCHES[k] for k in STAGED) > 0
    assert on_gpu.status == on_cpu.status == "converged"
    np.testing.assert_array_equal(on_gpu.dist, on_cpu.dist)
    for f in ("rounds", "relaxations", "msgs_sent", "msgs_recv",
              "pruned_edges", "q_rounds", "q_relaxations"):
        np.testing.assert_array_equal(np.asarray(getattr(on_gpu.stats, f)),
                                      np.asarray(getattr(on_cpu.stats, f)))


# ---------------------------------------------------------------- ragged --

VB, EB = 32, 64


def _stack_ragged(lays, fills):
    """Per-shard ragged planes padded to the longest shard with ``fills``
    and stacked [P, ...], as the shard builders stack them."""
    n = max(lay[0].shape[0] for lay in lays)
    return [torch.stack([torch.nn.functional.pad(
        lay[k], (0, 0) * (lay[k].dim() - 1) + (0, n - lay[k].shape[0]),
        value=fill) for lay in lays]) for k, fill in enumerate(fills)]


def _rows(rng, shape, p_inf):
    a = rng.uniform(0, 50, shape).astype(np.float32)
    a[rng.random(shape) < p_inf] = np.inf
    return a


@pytest.mark.parametrize("nq", [1, 3])
def test_relax_ragged_kernel_matches_plain(cuda, nq):
    """Two shards: the first leaves its last two vertex tiles without a
    chunk, the second is short and stacks with sentinel padding chunks."""
    rng = np.random.default_rng(nq)
    n = 300
    lays = []
    for e, hi in ((900, n - 2 * VB - 10), (150, n)):
        lays.append(build_dst_ragged_layout(
            rng.integers(0, n, e), rng.integers(0, hi, e),
            rng.uniform(1, 20, e).astype(np.float32), n, vb=VB, eb=EB,
            with_eid=True))
    bp = lays[0][5]
    src, w, rel, eid, ctile = _stack_ragged(
        lays, (bp - 1, float("inf"), 0, 900, bp // VB))
    dist = _rows(rng, (2, nq, n), 0.3)
    active = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    pruned = rng.random((2, 900)) < 0.2
    d, f, p_t = fixpoint_operands(torch.from_numpy(dist),
                                  torch.from_numpy(active),
                                  torch.from_numpy(pruned), eid, bp)
    args = [a.to(cuda) for a in (d, f, ctile, src, w, rel, p_t)]
    n0 = build.LAUNCHES["relax_ragged"]
    out = relax_dst_ragged_fixpoint_batch(*args, vb=VB, n_sweeps=6)
    ref = relax_dst_ragged_fixpoint_batch_plain(*args, vb=VB, n_sweeps=6)
    assert build.LAUNCHES["relax_ragged"] == n0 + 1
    assert int(out[2].sum()) > 0
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


@pytest.mark.parametrize("nq", [1, 3])
def test_send_ragged_kernel_matches_plain(cuda, nq):
    rng = np.random.default_rng(10 + nq)
    n, s = 300, 200
    lays = []
    for e, hi in ((600, s - 2 * VB - 5), (90, s)):
        lays.append(build_slot_ragged_layout(
            rng.integers(0, n, e), np.sort(rng.integers(0, hi, e)),
            rng.uniform(1, 20, e).astype(np.float32), s, sb=VB, eb=EB))
    n_stiles = lays[0][5] // VB
    src, w, seg, eid, ctile = _stack_ragged(
        lays, (0, float("inf"), 0, 600, n_stiles))
    pruned_t = torch.from_numpy((rng.random(eid.shape) < 0.2).astype(np.int32))
    dist = torch.from_numpy(_rows(rng, (2, nq, n), 0.3))
    last = torch.from_numpy(_rows(rng, (2, nq, s), 0.5))
    valid = torch.from_numpy(rng.random((2, s)) < 0.9)
    args = [a.to(cuda) for a in (
        *send_operands(dist, last, valid, n_stiles, VB), ctile, src, w, seg,
        pruned_t)]
    bounds = chunk_bounds(args[3], n_stiles)
    n0 = build.LAUNCHES["send_ragged"]
    out = send_pack_ragged(*args, sb=VB, bounds=bounds)
    again = send_pack_ragged(*args, sb=VB)          # bounds derived inside
    ref = send_pack_ragged_plain(*args, sb=VB)
    assert build.LAUNCHES["send_ragged"] == n0 + 2
    assert int(out[2].sum()) > 0
    for got, got2, want in zip(out, again, ref):
        assert torch.equal(got, want) and torch.equal(got2, want)


@pytest.mark.parametrize("nq", [1, 3])
def test_merge_ragged_kernel_matches_plain(cuda, nq):
    rng = np.random.default_rng(20 + nq)
    block, Pn, C = 300, 4, 150
    lays, incs = [], []
    for hi, frac in ((block - 2 * VB - 3, 0.0), (block, 0.9)):
        ridx = rng.integers(0, hi, (Pn, C))
        ridx[rng.random(ridx.shape) < frac] = block
        lays.append(build_msg_ragged_layout(ridx, block, vb=VB, eb=EB))
        inc = _rows(rng, (nq, Pn * C), 0.4)
        inc[:, ridx.reshape(-1) >= block] = np.inf
        incs.append(inc)
    bp = lays[0][4]
    pos, rel, valid, ctile = _stack_ragged(lays, (0, 0, 0, bp // VB))
    dist = pad_last(torch.from_numpy(_rows(rng, (2, nq, block), 0.3)), bp,
                    float("inf"))
    args = [a.to(cuda) for a in (dist, torch.from_numpy(np.stack(incs)),
                                 ctile, pos, rel, valid)]
    n0 = build.LAUNCHES["merge_ragged"]
    out = merge_scatter_ragged(*args, vb=VB)
    ref = merge_scatter_ragged_plain(*args, vb=VB)
    assert build.LAUNCHES["merge_ragged"] == n0 + 1
    assert int(out[2].sum()) > 0
    for got, want in zip(out, ref):
        assert torch.equal(got, want)


def test_ragged_engine_on_gpu_matches_cpu(cuda):
    """A stream-built ragged solve on the card equals its CPU solve and the
    card's dense solve, and runs the ragged kernels only."""
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    ragged = tc.build_shards_stream(tg.edge_chunks_of(g), g.n_vertices, 4)
    dense = tc.build_shards(g, 4, enumerate_triangles=False)
    rng = np.random.default_rng(3)
    deg = np.diff(g.row_ptr.numpy())
    srcs = [int(s) for s in rng.choice(np.nonzero(deg)[0], 3, replace=False)]
    cfg = tc.SsspConfig(**ALL_KERNELS)
    on_cpu = tc.SsspEngine.build(ragged, cfg, device="cpu").solve(srcs)
    build.reset_launches()
    on_gpu = tc.SsspEngine.build(ragged, cfg).solve(srcs)
    assert min(build.LAUNCHES[f"{k}_ragged"] for k in STAGED) > 0
    assert max(build.LAUNCHES[k] for k in build.KERNELS) == 0
    gpu_dense = tc.SsspEngine.build(dense, cfg).solve(srcs)
    assert on_gpu.status == on_cpu.status == gpu_dense.status == "converged"
    for other in (on_cpu, gpu_dense):
        np.testing.assert_array_equal(on_gpu.dist, other.dist)
        for f in ("rounds", "relaxations", "msgs_sent", "msgs_recv",
                  "pruned_edges", "q_rounds", "q_relaxations"):
            np.testing.assert_array_equal(np.asarray(getattr(on_gpu.stats, f)),
                                          np.asarray(getattr(other.stats, f)))


# ----------------------------------------------------------- fused round --

def _round_operands(sh, nq, dense, seed):
    """Kernel operands (``fused_round_operands``) of a random mid-solve
    state: dist 30% +inf, frontier, live queries, bucket messages at the
    routed positions only (or a dense [P, K, block] incoming), last_sent
    +inf on invalid slots, Trishla masks."""
    rng = np.random.default_rng(seed)
    P, block, S = sh.n_parts, sh.block, sh.n_slots
    ridx = sh.recv_idx.reshape(P, -1).numpy()
    dist = _rows(rng, (P, nq, block), 0.3)
    front = rng.random(dist.shape) < 0.2
    live = rng.random((P, nq)) < 0.8
    if dense:
        inc = _rows(rng, (P, nq, block), 0.5)
    else:
        inc = _rows(rng, (P, nq, ridx.shape[1]), 0.5)
        inc[np.broadcast_to((ridx == block)[:, None], inc.shape)] = np.inf
    last = _rows(rng, (P, nq, S), 0.5)
    last[~np.broadcast_to(sh.slot_valid.numpy()[:, None], last.shape)] = np.inf
    prn_loc = rng.random((P, sh.e_loc)) < 0.15
    prn_cut = rng.random((P, sh.e_cut)) < 0.15
    return fused_round_operands(
        *map(torch.from_numpy, (dist, front, live, inc, last)),
        sh.slot_valid, sh.relax_layout, sh.send_layout, sh.merge_layout,
        *map(torch.from_numpy, (prn_loc, prn_cut)), vb=sh.rx_vb,
        sb=sh.tx_sb, dense=dense)


def _to(ops, device):
    return [None if a is None else
            a.to(device) if isinstance(a, torch.Tensor) else
            tuple(x.to(device) for x in a) for a in ops]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_round_kernel_matches_plain(cuda, layout, dense):
    """Kernels 7 and 8 against their plain versions, all six outputs, on
    layouts with several tiles and chunks (VB 32, EB 64)."""
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    sh = tc.build_shards(g, 2, layout=layout, relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    args = _to(_round_operands(sh, 3, dense, seed=dense), cuda)
    kernel, plain, name = ((fused_round_ragged, fused_round_ragged_plain,
                            "round_ragged") if layout == "ragged" else
                           (fused_round_tiled, fused_round_tiled_plain,
                            "round"))
    # kernel 7 walks the live chunks the shards derive once
    chunks = ({} if layout == "ragged"
              else dict(chunks=sh.to(cuda).round_chunks))
    n0 = build.LAUNCHES[name]
    for sweeps in (2, 8):
        kw = dict(vb=VB, sb=VB, n_sweeps=sweeps, dense=dense)
        out = kernel(*args, **kw, **chunks)
        ref = plain(*args, **kw)
        assert int(out[4].sum()) > 0 and int(out[5].sum()) > 0
        for got, want in zip(out, ref):
            assert torch.equal(got, want)
    assert build.LAUNCHES[name] == n0 + 2


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_fused_engine_on_gpu_matches_cpu(cuda, layout):
    """round="fused" on the card equals its CPU run and the card's staged
    solve (all but n_dispatches), with one fused launch a round and no
    merge launch."""
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    sh = tc.build_shards(g, 4, layout=layout, relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    rng = np.random.default_rng(4)
    deg = np.diff(g.row_ptr.numpy())
    srcs = [int(s) for s in rng.choice(np.nonzero(deg)[0], 3, replace=False)]
    cfg = tc.SsspConfig(round="fused", pallas_sweeps=2, tri_chunk=16)
    on_cpu = tc.SsspEngine.build(sh, cfg, device="cpu").solve(srcs)
    build.reset_launches()
    on_gpu = tc.SsspEngine.build(sh, cfg).solve(srcs)
    sfx = "_ragged" if layout == "ragged" else ""
    assert build.LAUNCHES["round" + sfx] == int(on_gpu.stats.rounds)
    assert build.LAUNCHES["merge" + sfx] == 0
    assert build.LAUNCHES["relax" + sfx] >= build.LAUNCHES["send" + sfx] > 0
    staged = tc.SsspEngine.build(sh, tc.SsspConfig(
        **ALL_KERNELS, pallas_sweeps=2, tri_chunk=16)).solve(srcs)
    assert on_gpu.status == on_cpu.status == staged.status == "converged"
    assert int(on_gpu.stats.n_dispatches) == 2 * int(on_gpu.stats.rounds)
    for other in (on_cpu, staged):
        np.testing.assert_array_equal(on_gpu.dist, other.dist)
        for f in COUNTERS:
            np.testing.assert_array_equal(np.asarray(getattr(on_gpu.stats, f)),
                                          np.asarray(getattr(other.stats, f)))


# ------------------ kernels 2 and 8 on the ragged chain: placement, hazard --

def _path_shards():
    """A hazard that must show: 128 vertices on 2 shards (ragged, VB 32,
    EB 4), a path 0 -> 1 -> ... -> 30 inside vertex tile 0 of shard 0
    (four hops a chunk) and a few cut edges."""
    src = np.r_[np.arange(30), 30, 5, 70, 100]
    dst = np.r_[np.arange(1, 31), 70, 100, 71, 101]
    g = tg.csr_from_coo(src, dst, np.ones(len(src), np.float32), 128)
    return tc.build_shards(g, 2, enumerate_triangles=False, layout="ragged",
                           relax_vb=32, relax_eb=4, send_sb=32, send_eb=4,
                           merge_vb=32, merge_eb=4)


def _wide_shards():
    """A row wider than the shared-memory bitmask limit: 2 shards of 2**20
    vertices (VB 128, EB 512: 8,192 vertex tiles), the path of
    ``_path_shards`` and 20,000 random edges into the first 64 tiles, from
    sources anywhere (cut edges from shard 1)."""
    rng = np.random.default_rng(9)
    n = 1 << 21
    src = np.r_[np.arange(30), rng.integers(0, n, 20_000)]
    dst = np.r_[np.arange(1, 31), rng.integers(0, 8192, 20_000)]
    w = np.r_[np.ones(30), rng.uniform(0, 20, 20_000)].astype(np.float32)
    return tc.build_shards(tg.csr_from_coo(src, dst, w, n), 2,
                           enumerate_triangles=False, layout="ragged")


@functools.lru_cache(maxsize=None)
def _chain_shards(case):
    return _path_shards() if case == "path" else _wide_shards()


def _chain_operands(case, nq, device):
    """Kernel 8's operands (kernel 2's are among them) at a random mid-solve
    state, row 0 replaced by 10 v at local vertices v < 31, all in the
    frontier, +inf elsewhere: a path that improves within one sweep."""
    sh = _chain_shards(case)
    ops = _to(_round_operands(sh, nq, False, seed=nq), device)
    dist, front, live = ops[0], ops[1], ops[2]
    dist[:, 0] = float("inf")
    dist[:, 0, :31] = 10.0 * torch.arange(31, device=device)
    front[:, 0] = 0.0
    front[:, 0, :31] = 1.0
    live[:, 0] = 1.0
    src, w, rel, prn, ct = ops[7]
    return sh, ops, (dist, front, ct, src, w, rel, prn)


@pytest.mark.parametrize("sweeps", [1, 8])
@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("case", ["path", "wide"])
def test_ragged_chain_kernels_match_plain(cuda, case, nq, sweeps):
    """Kernels 2 and 8 bit-equal to their plain versions, on a path
    inside one tile and on a row whose bitmasks live in device memory
    (``*_ragged_scratch_bytes`` > 0)."""
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.round import round as round_mod
    sh, ops, rargs = _chain_operands(case, nq, cuda)
    bp = rargs[0].shape[-1]
    vb, sb = sh.rx_vb, sh.tx_sb
    need = (build.load("relax", relax_mod._SIGNATURES)
            .relax_ragged_scratch_bytes(bp, bp // vb, sh.rx_eb, vb),
            build.load("round", round_mod._SIGNATURES)
            .round_ragged_scratch_bytes(bp, bp // vb, sh.rx_eb, vb, sb))
    assert all((n > 0) == (case == "wide") for n in need)
    rkw = dict(vb=vb, n_sweeps=sweeps)
    want = relax_dst_ragged_fixpoint_batch_plain(*rargs, **rkw)
    assert int(want[2].sum()) > 0
    n0 = build.LAUNCHES["relax_ragged"]
    for g, w in zip(relax_dst_ragged_fixpoint_batch(*rargs, **rkw), want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["relax_ragged"] == n0 + 1
    kw = dict(vb=vb, sb=sb, n_sweeps=sweeps, dense=False)
    want = fused_round_ragged_plain(*ops, **kw)
    n0 = build.LAUNCHES["round_ragged"]
    for g, w in zip(fused_round_ragged(*ops, **kw), want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["round_ragged"] == n0 + 1


@pytest.mark.parametrize("nq", [1, 3, 16])
def test_ragged_chain_planted_fault_is_caught(cuda, nq):
    """Kernels 2 and 8 with the hazard re-read off (every source read from
    its early gather) differ from their plain versions on the path."""
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.round import round as round_mod
    _, ops, rargs = _chain_operands("path", nq, cuda)
    bad = relax_mod._launch_ragged(*rargs, vb=32, n_sweeps=1, hazard=False)
    want = relax_dst_ragged_fixpoint_batch_plain(*rargs, vb=32, n_sweeps=1)
    assert not torch.equal(bad[0], want[0])
    kw = dict(vb=32, sb=32, n_sweeps=1, dense=False)
    bad = round_mod._launch_ragged(*ops, **kw, hazard=False)
    assert not torch.equal(bad[0], fused_round_ragged_plain(*ops, **kw)[0])


def test_ragged_chain_row_past_cap_raises(cuda):
    """A row past the ragged chain's cap (its shared memory holds a byte a
    vertex tile beside the ring and window: 83,904 tiles for kernel 2,
    75,200 for kernel 8 at EB 512, VB = SB = 128) raises a ValueError that
    names it, before any launch."""
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.round import round as round_mod
    lib_r = build.load("relax", relax_mod._SIGNATURES)
    lib_x = build.load("round", round_mod._SIGNATURES)
    vb, eb = 128, 512
    assert lib_r.relax_ragged_scratch_bytes(83_904 * vb, 83_904, eb, vb) > 0
    assert lib_r.relax_ragged_scratch_bytes(83_905 * vb, 83_905, eb, vb) == -1
    assert lib_x.round_ragged_scratch_bytes(75_200 * vb, 75_200, eb, vb,
                                            vb) > 0
    assert lib_x.round_ragged_scratch_bytes(75_201 * vb, 75_201, eb, vb,
                                            vb) == -1
    # one shard, one query, one chunk of no edges: 90,000 vertex tiles
    bp = 90_000 * vb
    dist = torch.zeros((1, 1, bp), device=cuda)
    front = torch.zeros_like(dist)
    ct = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    src = torch.zeros((1, 1, eb), dtype=torch.int32, device=cuda)
    w = torch.full((1, 1, eb), float("inf"), device=cuda)
    n0 = build.LAUNCHES["relax_ragged"]
    with pytest.raises(ValueError, match="past the ragged chain's cap"):
        relax_dst_ragged_fixpoint_batch(dist, front, ct, src, w, src, src,
                                        vb=vb, n_sweeps=1)
    assert build.LAUNCHES["relax_ragged"] == n0


# ---- kernels 9 and 7 on the chain over the dense layout's live chunks --

def _with_dead_chunk(sh, at):
    """Dense shards with a dead chunk (+inf weights, as a real edge of
    weight +inf leaves one) inserted at chunk ``at`` of every tile of the
    relax and send layouts: in the middle of every tile that has more."""
    def insert(a, fill):
        dead = torch.full((*a.shape[:2], 1, a.shape[3]), fill, dtype=a.dtype)
        return torch.cat([a[:, :, :at], dead, a[:, :, at:]], 2).contiguous()
    fills = (0, float("inf"), 0, 10 ** 9)
    rx = ("rx_src", "rx_w", "rx_dstrel", "rx_eid")
    tx = ("tx_src", "tx_w", "tx_segrel", "tx_eid")
    return dataclasses.replace(sh, **{
        k: insert(getattr(sh, k), f) for names in (rx, tx)
        for k, f in zip(names, fills)})


@functools.lru_cache(maxsize=None)
def _dense_path_shards(case):
    """The path of ``_path_shards`` in the dense layout (VB 32, EB 4), a
    dead chunk after the third chunk of every tile; tile 1 of shard 0 has
    no edge. "no-live": the relax layout holds no live chunk at all.
    "wide": the graph of ``_wide_shards`` in the dense layout."""
    if case == "wide":
        rng = np.random.default_rng(9)
        n = 1 << 21
        src = np.r_[np.arange(30), rng.integers(0, n, 20_000)]
        dst = np.r_[np.arange(1, 31), rng.integers(0, 8192, 20_000)]
        w = np.r_[np.ones(30), rng.uniform(0, 20, 20_000)].astype(np.float32)
        return tc.build_shards(tg.csr_from_coo(src, dst, w, n), 2,
                               enumerate_triangles=False, layout="dense")
    src = np.r_[np.arange(30), 30, 5, 70, 100]
    dst = np.r_[np.arange(1, 31), 70, 100, 71, 101]
    g = tg.csr_from_coo(src, dst, np.ones(len(src), np.float32), 128)
    sh = _with_dead_chunk(tc.build_shards(
        g, 2, enumerate_triangles=False, layout="dense", relax_vb=32,
        relax_eb=4, send_sb=32, send_eb=4, merge_vb=32, merge_eb=4), 3)
    if case == "no-live":
        sh = dataclasses.replace(sh, rx_w=torch.full_like(sh.rx_w,
                                                          float("inf")))
    return sh


def _dense_chain_operands(case, nq, device):
    """Kernel 7's operands at a random mid-solve state, row 0 holding the
    path (10 v at v < 31, all in the frontier), and kernel 9's (shard 0,
    row 0)."""
    sh = _dense_path_shards(case)
    ops = _to(_round_operands(sh, nq, False, seed=nq), device)
    dist, front, live = ops[0], ops[1], ops[2]
    dist[:, 0] = float("inf")
    dist[:, 0, :31] = 10.0 * torch.arange(31, device=device)
    front[:, 0] = 0.0
    front[:, 0, :31] = 1.0
    live[:, 0] = 1.0
    args9 = (dist[0, 0].contiguous(), front[0, 0].contiguous(),
             *(a[0].contiguous() for a in ops[7]))
    return sh, ops, args9


@pytest.mark.parametrize("sweeps", [1, 8])
@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("case", ["path", "no-live"])
def test_live_chain_kernels_match_plain(cuda, case, nq, sweeps):
    """Kernels 9 and 7 bit-equal to their plain versions on dense layouts
    with a dead chunk in the middle of a tile and a tile with no live chunk
    ("path"), and with no live relax chunk at all ("no-live": out == dist,
    resid empty, no relaxation); kernel 7 with the shards' live chunks."""
    sh, ops, args9 = _dense_chain_operands(case, nq, cuda)
    kw9 = dict(vb=32, n_sweeps=sweeps)
    want = relax_dst_tiled_fixpoint_plain(*args9, **kw9)
    assert (int(want[2]) > 0) == (case == "path")
    n0 = build.LAUNCHES["relax_single"]
    for g, w in zip(relax_dst_tiled_fixpoint(*args9, **kw9), want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["relax_single"] == n0 + 1
    kw = dict(vb=32, sb=32, n_sweeps=sweeps, dense=False)
    want = fused_round_tiled_plain(*ops, **kw)
    if case == "no-live":
        assert int(want[4].sum()) == 0 and not bool(want[1].any())
    n0 = build.LAUNCHES["round"]
    got = fused_round_tiled(*ops, **kw, chunks=sh.to(cuda).round_chunks)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert build.LAUNCHES["round"] == n0 + 1


@pytest.mark.parametrize("nq", [1, 3, 16])
def test_live_chain_planted_fault_is_caught(cuda, nq):
    """Kernels 9 and 7 with the hazard re-read off (every source read from
    its early gather) differ from their plain versions on the path."""
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.round import round as round_mod
    sh, ops, args9 = _dense_chain_operands("path", nq, cuda)
    bad = relax_mod._launch_single(*args9, vb=32, n_sweeps=1, hazard=False)
    want = relax_dst_tiled_fixpoint_plain(*args9, vb=32, n_sweeps=1)
    assert not torch.equal(bad[0], want[0])
    kw = dict(vb=32, sb=32, n_sweeps=1, dense=False)
    bad = round_mod._launch_tiled(
        *ops, **kw, chunks=sh.to(cuda).round_chunks, hazard=False)
    assert not torch.equal(bad[0], fused_round_tiled_plain(*ops, **kw)[0])


def test_live_chain_wide_row_matches_plain(cuda):
    """Kernels 9 and 7 on rows whose bitmasks do not fit beside the ring
    (they live in device memory): ``_wide_shards``' graph in the dense
    layout, 8,192 vertex tiles a shard, all but the first 64 dead."""
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.round import round as round_mod
    sh, ops, args9 = _dense_chain_operands("wide", 3, cuda)
    bp, vb, eb = args9[0].shape[0], sh.rx_vb, sh.rx_eb
    assert build.load("relax", relax_mod._SIGNATURES).relax_ragged_scratch_bytes(
        bp, bp // vb, eb, vb) > 0
    assert build.load("round", round_mod._SIGNATURES).round_ragged_scratch_bytes(
        bp, bp // vb, eb, vb, sh.tx_sb) > 0
    want = relax_dst_tiled_fixpoint_plain(*args9, vb=vb, n_sweeps=2)
    assert int(want[2]) > 0
    for g, w in zip(relax_dst_tiled_fixpoint(*args9, vb=vb, n_sweeps=2),
                    want):
        assert torch.equal(g, w)
    kw = dict(vb=vb, sb=sh.tx_sb, n_sweeps=2, dense=False)
    want = fused_round_tiled_plain(*ops, **kw)
    assert int(want[4].sum()) > 0
    for g, w in zip(fused_round_tiled(*ops, **kw,
                                      chunks=sh.to(cuda).round_chunks), want):
        assert torch.equal(g, w)


def test_live_chain_row_past_cap_raises(cuda):
    """Kernel 9's row past the chain's cap (83,904 vertex tiles at EB 512,
    VB 128, as kernel 2's) raises before any launch; kernel 7 shares kernel
    8's cap (``round_ragged_scratch_bytes``)."""
    vb, eb, n_vtiles = 128, 512, 90_000
    dist = torch.zeros(n_vtiles * vb, device=cuda)
    src = torch.zeros((n_vtiles, 1, eb), dtype=torch.int32, device=cuda)
    w = torch.full((n_vtiles, 1, eb), float("inf"), device=cuda)
    n0 = build.LAUNCHES["relax_single"]
    with pytest.raises(ValueError, match="past the ragged chain's cap"):
        relax_dst_tiled_fixpoint(dist, dist, src, w, src, src, vb=vb,
                                 n_sweeps=1)
    assert build.LAUNCHES["relax_single"] == n0


# ---------------- kernel 1 on the chain over the relax layout's live chunks --

def _kernel1_operands(case, nq, device, shards):
    """Kernel 1's operands (dist, front, src, w, rel, pruned) on the card
    and their shards: "rmat" the module's ``shards`` at a random state,
    "path" the dense path shards (a dead chunk inside every tile, a tile
    with no edge) with row 0 holding the path."""
    if case == "path":
        sh, ops, _ = _dense_chain_operands("path", nq, device)
        return sh, (ops[0], ops[1], *ops[7])
    _, sh = shards
    dist, active, pruned, _ = _state(sh, nq, seed=30 + nq)
    return sh, tuple(_relax_args(sh, dist, active, pruned, device))


@pytest.mark.parametrize("sweeps", [1, 8])
@pytest.mark.parametrize("nq", [1, 3, 16])
@pytest.mark.parametrize("case", ["rmat", "path"])
def test_kernel1_matches_plain_with_and_without_chunks(cuda, shards, case,
                                                       nq, sweeps):
    """Kernel 1 bit-equal to its plain version (distances, residual
    frontier, per-(shard, query) relaxations) with the shards' relax live
    chunks, as the engine passes them, and without (the entry point's
    pre-pass finds them), on a layout with dead chunks inside tiles and a
    tile with no live chunk."""
    sh, args = _kernel1_operands(case, nq, cuda, shards)
    kw = dict(vb=sh.rx_vb, n_sweeps=sweeps)
    want = relax_dst_tiled_fixpoint_batch_plain(*args, **kw)
    assert int(want[2].sum()) > 0
    chunks = sh.to(cuda).relax_chunks
    n0 = build.LAUNCHES["relax"]
    for ch in (chunks, None):
        got = relax_dst_tiled_fixpoint_batch(*args, **kw, chunks=ch)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert build.LAUNCHES["relax"] == n0 + 2


@pytest.mark.parametrize("nq", [1, 3, 16])
def test_kernel1_planted_fault_is_caught(cuda, shards, nq):
    """Kernel 1 with the hazard re-read off (every source read from its
    early gather) differs from its plain version on the path, with the
    shards' live chunks and with the pre-pass's."""
    from repro_torch.kernels.relax import relax as relax_mod
    sh, args = _kernel1_operands("path", nq, cuda, shards)
    want = relax_dst_tiled_fixpoint_batch_plain(*args, vb=32, n_sweeps=1)
    for ch in (sh.to(cuda).relax_chunks, None):
        bad = relax_mod._launch_tiled(*args, vb=32, n_sweeps=1, chunks=ch,
                                      hazard=False)
        assert not torch.equal(bad[0], want[0])


def test_kernel1_row_past_cap_raises(cuda):
    """Kernel 1's row past the chain's cap (83,904 vertex tiles at EB 512,
    VB 128, as kernels 2 and 9) raises before any launch, with or without
    the live chunks; it never falls back to another kernel."""
    from repro_torch.kernels.common import live_chunks
    vb, eb, n_vtiles = 128, 512, 90_000
    dist = torch.zeros((1, 1, n_vtiles * vb), device=cuda)
    src = torch.zeros((1, n_vtiles, 1, eb), dtype=torch.int32, device=cuda)
    w = torch.full((1, n_vtiles, 1, eb), float("inf"), device=cuda)
    chunks = live_chunks(w < float("inf"))
    n0 = build.LAUNCHES["relax"]
    for ch in (chunks, None):
        with pytest.raises(ValueError, match="past the ragged chain's cap"):
            relax_dst_tiled_fixpoint_batch(dist, dist, src, w, src, src,
                                           vb=vb, n_sweeps=1, chunks=ch)
    assert build.LAUNCHES["relax"] == n0


# ------------------ kernels 4 and 3: (edge, query) pairs, interleaved rows --

def _send_case(layout, K, device, sb=VB):
    """Kernel 4's (ragged) or 3's (dense) operands, P = 2, slot tiles of
    sb, chunks of EB: shard 0 has a hub slot (3,000 edges into slot 7),
    600 random edges and no edge into slots [200, 400) nor into its last
    five tiles; shard 1 has 90 edges, so the ragged stack pads it with
    sentinel chunks (and the dense one with padding chunks); 20% of the
    edges pruned; rows with 30% +inf, last_sent with 50%, 90% of the slots
    valid."""
    rng = np.random.default_rng(40 + K)
    n, s = 300, 1000
    band = np.r_[0:200, 400:s - 5 * sb]
    cases = [(np.r_[np.full(3000, 7), rng.choice(band, 600)],
              rng.integers(0, n, 3600)),
             (rng.integers(0, s, 90), rng.integers(0, n, 90))]
    build_lay = (build_slot_ragged_layout if layout == "ragged"
                 else build_slot_tiled_layout)
    lays = [build_lay(src, np.sort(seg), rng.uniform(1, 20, len(seg)).astype(
        np.float32), s, sb=sb, eb=EB) for seg, src in cases]
    if layout == "ragged":
        n_stiles = lays[0][5] // sb
        planes = _stack_ragged(lays, (0, float("inf"), 0, 10 ** 6, n_stiles))
        lead, planes = [planes[4]], planes[:3]
    else:
        n_stiles = lays[0][0].shape[0]
        n_chunks = max(lay[0].shape[1] for lay in lays)
        planes = [torch.stack([torch.nn.functional.pad(
            lay[k], (0, 0, 0, n_chunks - lay[k].shape[1]), value=fill)
            for lay in lays]) for k, fill in enumerate((0, float("inf"), 0))]
        lead = []
    pruned = torch.from_numpy(
        (rng.random(planes[0].shape) < 0.2).astype(np.int32))
    dist = torch.from_numpy(_rows(rng, (2, K, n), 0.3))
    last = torch.from_numpy(_rows(rng, (2, K, s), 0.5))
    valid = torch.from_numpy(rng.random((2, s)) < 0.9)
    return [a.to(device) for a in (
        *send_operands(dist, last, valid, n_stiles, sb), *lead, *planes,
        pruned)]


@pytest.mark.parametrize("K,sb", [(1, VB), (3, VB), (16, VB), (48, VB),
                                  (450, 128), (451, 128), (512, 128),
                                  (1000, 128), (894, 64), (1760, VB)])
@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_send_kernels_match_plain_at_many_queries(cuda, layout, K, sb):
    """Kernels 4 (ragged) and 3 (dense), which gather from the query-
    interleaved rows, bit-equal to their plain versions at K = 1 (no
    interleave), 3 (not a power of two), 16 and 48 (more queries than a
    warp's lanes) on a layout with a hub slot, empty slot tiles and
    padding chunks; and past the most queries whose tile of minima leaves
    room for a full staged batch (418 at the engine's slot tiles of 128,
    1,636 at 32), where the launch splits the queries into groups that fit
    six CTAs to an SM: 450 and 451 (eleven groups at sb 128), 512
    (twelve), 1,000 (twenty-four), 894 at sb 64 (eleven) and 1,760 at 32
    (eleven)."""
    args = _send_case(layout, K, cuda, sb=sb)
    kernel, plain, counter = (
        (send_pack_ragged, send_pack_ragged_plain, "send_ragged")
        if layout == "ragged" else
        (send_pack_tiled, send_pack_tiled_plain, "send"))
    n0 = build.LAUNCHES[counter]
    got = kernel(*args, sb=sb)
    want = plain(*args, sb=sb)
    assert build.LAUNCHES[counter] == n0 + 1
    assert int(want[2].sum()) > 0
    hub = want[1][0, :, 7]
    assert bool(torch.isfinite(hub).any())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("layout", ["ragged", "dense"])
def test_send_kernels_reject_a_tile_past_shared_memory(cuda, layout):
    """A slot tile too wide for even one query's tile of minima and one
    staged edge (65,536 slots: 256 KB of keys) raises before any launch;
    no fallback. Any number of queries runs (the cases above)."""
    K, sb, eb = 1, 65536, 64
    dist = torch.zeros((1, K, 128), device=cuda)
    last = torch.zeros((1, K, sb), device=cuda)
    valid = torch.ones((1, sb), dtype=torch.int32, device=cuda)
    src = torch.zeros((1, 1, 1, eb), dtype=torch.int32, device=cuda)
    w = torch.ones((1, 1, 1, eb), device=cuda)
    counter = "send_ragged" if layout == "ragged" else "send"
    n0 = build.LAUNCHES[counter]
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        if layout == "ragged":
            ct = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
            send_pack_ragged(dist, last, valid, ct, src[0], w[0], src[0],
                             src[0], sb=sb)
        else:
            send_pack_tiled(dist, last, valid, src, w, src, src, sb=sb)
    assert build.LAUNCHES[counter] == n0


# ------------------------------------- the standalone kernel API (9-11, 13) --

def _single(rng, device, negative=False):
    """One block of 600 vertices (5 tiles of 128, several chunks of 128
    edges), a row with 30% +inf, a 40% frontier, a 20% Trishla mask; with
    ``negative``, distances and weights of both signs."""
    n, m = 600, 5000
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    lo = -20 if negative else 1
    w = rng.uniform(lo, 20, m).astype(np.float32)
    src_t, w_t, dr_t, eid_t, bp = build_dst_tiled_layout(
        src, dst, w, n, vb=128, eb=128, with_eid=True)
    dist = rng.uniform(-50 if negative else 0, 50, bp).astype(np.float32)
    dist[rng.random(bp) < 0.3] = np.inf
    front = (rng.random(bp) < 0.4).astype(np.float32)
    pruned = torch.from_numpy((rng.random(m + 1) < 0.2).astype(np.int32))
    pruned[m] = 0                           # the padding eid: not pruned
    pr_t = pruned[eid_t.long()]
    return [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
            else a.contiguous().to(device)
            for a in (dist, front, src_t, w_t, dr_t, pr_t)]


@pytest.mark.parametrize("negative", [False, True])
def test_relax_single_kernels_match_plain(cuda, negative):
    """Kernels 11, 10 and 9 bit-equal to their plain versions, negative
    distances and weights included (the order-preserving key), each
    launched once."""
    dist, front, src_t, w_t, dr_t, pr_t = _single(
        np.random.default_rng(3 + negative), cuda, negative)
    n0 = dict(build.LAUNCHES)
    out = relax_dst_tiled(dist, src_t, w_t, dr_t, vb=128)
    assert torch.equal(out, relax_dst_tiled_plain(dist, src_t, w_t, dr_t,
                                                  vb=128))
    assert bool((out < dist).any())
    out, nrel = relax_dst_tiled_masked(dist, front, src_t, w_t, dr_t, pr_t,
                                       vb=128)
    ref = relax_dst_tiled_masked_plain(dist, front, src_t, w_t, dr_t, pr_t,
                                       vb=128)
    assert int(nrel) > 0
    for got, want in zip((out, nrel), ref):
        assert torch.equal(got, want)
    for sweeps in (1, 4):
        out = relax_dst_tiled_fixpoint(dist, front, src_t, w_t, dr_t, pr_t,
                                       vb=128, n_sweeps=sweeps)
        ref = relax_dst_tiled_fixpoint_plain(dist, front, src_t, w_t, dr_t,
                                             pr_t, vb=128, n_sweeps=sweeps)
        for got, want in zip(out, ref):
            assert torch.equal(got, want)
    for k, n in (("relax_sweep", 1), ("relax_masked", 1),
                 ("relax_single", 2)):
        assert build.LAUNCHES[k] == n0[k] + n


def _same_nan(got, want):
    """Bit-equal, NaN in the same places (whatever its payload)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _hub_single(device):
    """600 vertices in tiles of 128, chunks of 64 edges: tile 1 takes a hub
    of 900 edges and more (19 live chunks), tile 2 no edge (no live
    chunk), tile 3 only edges from sources 500-599, which the frontier
    leaves out; a row with 30% +inf, a 20% Trishla mask."""
    rng = np.random.default_rng(11)
    n = 600
    src = np.r_[rng.integers(0, 500, 900), rng.integers(500, 600, 100),
                rng.integers(0, n, 700)]
    dst = np.r_[np.full(900, 130), rng.integers(384, 512, 100),
                rng.choice(np.r_[0:256, 512:600], 700)]
    w = rng.uniform(1, 20, len(src)).astype(np.float32)
    src_t, w_t, dr_t, eid_t, bp = build_dst_tiled_layout(
        src, dst, w, n, vb=128, eb=64, with_eid=True)
    dist = rng.uniform(0, 50, bp).astype(np.float32)
    dist[rng.random(bp) < 0.3] = np.inf
    front = (rng.random(bp) < 0.5).astype(np.float32)
    front[500:] = 0.0
    pruned = torch.from_numpy((rng.random(len(src) + 1) < 0.2)
                              .astype(np.int32))
    pruned[-1] = 0
    return [torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
            else a.contiguous().to(device)
            for a in (dist, front, src_t, w_t, dr_t, pruned[eid_t.long()])]


def _sweep_case(case, device):
    if case == "hub":
        return _hub_single(device)
    args = _single(np.random.default_rng(7), device, case != "single")
    if case == "neg-inf":
        # a few distances at -inf, the padding source's among them: -inf +
        # inf is NaN in the plain version, dead chunks included
        d = args[0].cpu().numpy()
        d[np.random.default_rng(8).random(d.size) < 0.05] = -np.inf
        d[-1] = -np.inf
        args[0] = torch.from_numpy(d).to(device)
    return args


@pytest.mark.parametrize("route", ["chunks", "pre-pass"])
@pytest.mark.parametrize("case", ["single", "negative", "neg-inf", "hub"])
def test_sweep_kernels_over_live_chunks_match_plain(cuda, case, route):
    """Kernels 11 and 10 (one cooperative launch over the live chunks)
    bit-equal to their plain versions, with the caller's live chunks or the
    entry point's pre-pass: a tile of many live chunks, a tile with none, a
    live chunk whose sources are all outside the frontier ("hub"),
    negative values, and -inf distances, where the plain version's -inf +
    inf gives NaN (dead chunks included) and the kernels give NaN in the
    same places; one launch counted a call."""
    dist, front, src_t, w_t, dr_t, pr_t = _sweep_case(case, cuda)
    chunks = (live_chunks(w_t[None] < float("inf")) if route == "chunks"
              else None)
    if case == "hub":
        assert chunks is None or 0 in chunks[1][0].diff().tolist()
    n0 = dict(build.LAUNCHES)
    out = relax_dst_tiled(dist, src_t, w_t, dr_t, vb=128, chunks=chunks)
    want = relax_dst_tiled_plain(dist, src_t, w_t, dr_t, vb=128)
    _same_nan(out, want)
    out10 = relax_dst_tiled_masked(dist, front, src_t, w_t, dr_t, pr_t,
                                   vb=128, chunks=chunks)
    want10 = relax_dst_tiled_masked_plain(dist, front, src_t, w_t, dr_t,
                                          pr_t, vb=128)
    _same_nan(out10[0], want10[0])
    assert torch.equal(out10[1], want10[1]) and int(want10[1]) > 0
    assert bool(torch.isnan(want).any()) == (case == "neg-inf")
    for k in ("relax_sweep", "relax_masked"):
        assert build.LAUNCHES[k] == n0[k] + 1


def test_sweep_kernels_planted_fault_dropped_chunk_differs(cuda):
    """A list of live chunks that drops one (the first of the heaviest
    tile) gives another result than the plain version: the kernels read
    the list they are given and nothing else."""
    dist, front, src_t, w_t, dr_t, pr_t = _hub_single(cuda)
    idx, bounds = live_chunks(w_t[None] < float("inf"))
    t = int(bounds[0].diff().argmax())
    lo = int(bounds[0, t])
    bad = (torch.cat([idx[:, :lo], idx[:, lo + 1:], idx[:, lo:lo + 1]], 1),
           bounds.clone())
    bad[1][0, t + 1:] -= 1
    out = relax_dst_tiled(dist, src_t, w_t, dr_t, vb=128, chunks=bad)
    assert not torch.equal(out, relax_dst_tiled_plain(dist, src_t, w_t, dr_t,
                                                      vb=128))
    out10 = relax_dst_tiled_masked(dist, front, src_t, w_t, dr_t, pr_t,
                                   vb=128, chunks=bad)
    want10 = relax_dst_tiled_masked_plain(dist, front, src_t, w_t, dr_t,
                                          pr_t, vb=128)
    assert not (torch.equal(out10[0], want10[0])
                and torch.equal(out10[1], want10[1]))


def test_relax_single_wrappers_reject_bad_operands(cuda):
    dist, front, src_t, w_t, dr_t, pr_t = _single(np.random.default_rng(4),
                                                  cuda)
    with pytest.raises(ValueError, match="float32"):
        relax_dst_tiled(dist.double(), src_t, w_t, dr_t, vb=128)
    with pytest.raises(ValueError, match="int32"):
        relax_dst_tiled_masked(dist, front, src_t, w_t, dr_t, pr_t.long(),
                               vb=128)
    with pytest.raises(ValueError, match="do not match"):
        relax_dst_tiled_fixpoint(dist[:-128], front[:-128], src_t, w_t, dr_t,
                                 pr_t, vb=128, n_sweeps=2)
    with pytest.raises(ValueError, match="do not match"):
        relax_dst_tiled_masked(dist, front, src_t, w_t, dr_t,
                               pr_t[:, :-1].contiguous(), vb=128)
    with pytest.raises(ValueError, match="do not match"):
        relax_dst_tiled(dist, src_t, w_t, dr_t, vb=64)
    idx, bounds = live_chunks(w_t[None] < float("inf"))
    with pytest.raises(ValueError, match="do not match the layout"):
        relax_dst_tiled(dist, src_t, w_t, dr_t, vb=128,
                        chunks=(idx, bounds[:, :-1].contiguous()))
    with pytest.raises(ValueError, match="int32"):
        relax_dst_tiled_masked(dist, front, src_t, w_t, dr_t, pr_t, vb=128,
                               chunks=(idx.long(), bounds))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 6])
def test_embedding_bag_kernel_matches_plain(cuda, dtype, D):
    """Kernel 13, sum and mean, L 1..4, bit-equal to its plain version;
    D = 16 takes the 16-byte lane loads, D = 6 single elements. Indices in
    [-V, 0) wrap to row V + i; those outside [-V, V) are skipped."""
    rng = np.random.default_rng(D)
    V = 1000
    table = torch.from_numpy(rng.standard_normal((V, D)).astype(
        np.float32)).to(cuda, dtype)
    n0 = build.LAUNCHES["embedding_bag"]
    for L in range(1, 5):
        idx = rng.integers(0, V, (64, L))
        idx[rng.random(idx.shape) < 0.1] = V
        idx[0, 0] = -3
        idx[1, 0] = -V
        idx[2, -1] = -V - 5
        idx[3] = rng.integers(-V, 0, L)
        idx = torch.from_numpy(idx.astype(np.int32)).to(cuda)
        for mode in ("sum", "mean"):
            out = embedding_bag_p(table, idx, mode=mode)
            assert out.dtype == dtype
            assert torch.equal(out, embedding_bag_p_plain(table, idx,
                                                          mode=mode))
    assert build.LAUNCHES["embedding_bag"] == n0 + 8


def test_embedding_bag_wrapper_rejects_bad_operands(cuda):
    table = torch.ones((16, 8), device=cuda)
    idx = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_p(table, idx.long())
    with pytest.raises(ValueError, match="f32 or bf16"):
        embedding_bag_p(table.half(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_p(torch.ones((16, 16), device=cuda)[:, :8], idx)
    with pytest.raises(ValueError, match="multiple of bb"):
        embedding_bag_p(table, idx[:5])


FLASH_F32_TOL = 2e-5   # max abs error, test_kernels.py:63
FLASH_BF16_ULPS = 2    # same bf16 inputs, f32 math, one rounding each


def _bf16_ulps(got, want):
    """Largest elementwise |got - want| in bf16 ulps of |want|, an ulp
    being at least 5e-6 (for values near 0)."""
    w = want.float().abs()
    ulp = torch.exp2(torch.frexp(w)[1].float() - 8)
    ulp = torch.where(w > 0, ulp, 0.0).clamp(min=5e-6)
    return float(((got.float() - want.float()).abs() / ulp).max())


def _flash_inputs(device, dtype, B, Hq, Hkv, Sq, Skv, D, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g).to(device, dtype) for s in
            ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]


# the counter of the kernel each input type launches
FLASH_ROUTE = {torch.float32: "flash_attention",
               torch.bfloat16: "flash_attention_tc"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,q_offset", [
    (2, 4, 4, 128, 128, 16, True, 0),
    (2, 4, 2, 96, 160, 32, True, 0),            # GQA, kv padding
    (1, 8, 1, 64, 64, 64, False, 0),            # MQA, bidirectional
    (1, 6, 2, 200, 200, 128, True, 0),          # a group of 3
    (1, 24, 2, 130, 130, 128, True, 0),         # a group of 12 (mistral's)
    (1, 32, 2, 256, 256, 128, True, 0),         # a group of 16 (qwen3-moe's)
    (2, 2, 2, 256, 256, 256, True, 0),          # gemma's head width
    (1, 4, 4, 1, 300, 256, True, 299),          # decode-shaped
    (1, 3, 1, 40, 40, 32, True, -20),           # rows with no valid key
    (1, 4, 2, 200, 200, 64, True, 0),           # kv_len 200: mid-tile at 128
    (2, 2, 1, 160, 100, 256, False, 0),         # kv_len 100: mid-tile at 64
    (1, 2, 2, 300, 300, 256, True, 0),          # three q tiles, 300 % 64
])
def test_flash_attention_kernel_matches_plain(cuda, dtype, B, Hq, Hkv, Sq,
                                              Skv, D, causal, q_offset):
    """Kernel 12 through the entry point (padding to the blocks, kv_len
    masking) against its plain version on the same card tensors, through
    both routes: f32 launches the 3xTF32 kernel, bf16 the bf16 one, and
    only that one."""
    q, k, v = _flash_inputs(cuda, dtype, B, Hq, Hkv, Sq, Skv, D)
    kw = dict(causal=causal, q_offset=q_offset, block_q=min(64, Sq),
              block_k=64)
    n0 = dict(build.LAUNCHES)
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = {name: n - n0[name] for name, n in build.LAUNCHES.items()
           if n != n0[name]}
    assert ran == {FLASH_ROUTE[dtype]: 1}
    assert out.dtype == dtype and out.shape == q.shape
    bq = kw["block_q"]
    pad = lambda t, b: torch.nn.functional.pad(  # noqa: E731
        t, (0, 0, 0, (-t.shape[2]) % b))
    want = flash_attention_p_plain(
        pad(q, bq), pad(k, 64), pad(v, 64), scale=D ** -0.5, causal=causal,
        q_offset=q_offset, kv_len=Skv, block_q=bq, block_k=64)[:, :, :Sq]
    if dtype == torch.float32:
        err = float((out - want).abs().max())
        assert err <= FLASH_F32_TOL, err
    else:
        ulps = _bf16_ulps(out, want)
        assert ulps <= FLASH_BF16_ULPS, ulps
    if q_offset < 0:
        assert bool((out[:, :, :-q_offset] == 0).all())


def test_flash_attention_tc_fault_is_seen(cuda):
    """The tensor-core kernel with its P_lo products dropped (p rounded to
    bf16 alone, as plain bf16 FlashAttention does) misses the 2-ulp
    tolerance that the kernel itself meets."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _launch_tc)
    q, k, v = _flash_inputs(cuda, torch.bfloat16, 1, 4, 4, 1024, 1024, 256)
    kw = dict(scale=256 ** -0.5, causal=True, q_offset=0, kv_len=1024)
    want = flash_attention_p_plain(q, k, v, block_q=128, block_k=128, **kw)
    out = torch.empty_like(q)
    _launch_tc(q, k, v, out, **kw)
    assert _bf16_ulps(out, want) <= FLASH_BF16_ULPS
    _launch_tc(q, k, v, out, split_p=False, **kw)
    assert _bf16_ulps(out, want) > FLASH_BF16_ULPS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Hq,Hkv", [(128, 4, 2), (256, 2, 2), (64, 12, 1)])
def test_flash_attention_kernel_reads_strided_views(cuda, dtype, D, Hq, Hkv):
    """attention() hands the kernel [B, S, H, D] tensors seen as
    [B, H, S, D]; the result equals that of contiguous copies, and the
    output keeps the [B, S, H, D] layout."""
    g = torch.Generator().manual_seed(1)
    bshd = [torch.randn(s, generator=g).to(cuda, dtype)
            for s in ((2, 192, Hq, D), (2, 192, Hkv, D), (2, 192, Hkv, D))]
    views = [t.transpose(1, 2) for t in bshd]
    a = flash_attention(*views, block_q=64, block_k=64)
    b = flash_attention(*[t.contiguous() for t in views], block_q=64,
                        block_k=64)
    assert torch.equal(a, b)
    assert a.transpose(1, 2).is_contiguous()


def test_flash_attention_wrapper_rejects_bad_operands(cuda):
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 2, 2, 64, 64, 32)
    kw = dict(scale=0.2, causal=True, q_offset=0, kv_len=64, block_q=64,
              block_k=64)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention_p(q.half(), k.half(), v.half(), **kw)
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention_p(q, k.bfloat16(), v, **kw)
    strided = torch.zeros((1, 2, 64, 64), device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous last axis"):
        flash_attention_p(q, strided, v, **kw)
    q48, k48, v48 = _flash_inputs(cuda, torch.float32, 1, 2, 2, 64, 64, 48)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_p(q48, k48, v48, **kw)
    with pytest.raises(ValueError, match="multiples"):
        flash_attention_p(q, k, v, **dict(kw, block_k=48))
    # bf16 goes through TMA: a pointer or a stride off 16 bytes raises
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    buf = torch.zeros((1, 2, 64, 40), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_p(qb, buf[..., 1:33], vb, **kw)
    wide = torch.zeros((1, 2, 64, 36), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_p(qb, kb, wide[..., :32], **kw)


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-7b",
                                  "mistral-large-123b"])
def test_transformer_smoke_forward_on_gpu_matches_cpu(cuda, arch):
    """The smoke configs' forward with attn_impl="pallas": on the card
    (kernel 12's f32 route, one launch a layer) against the CPU (its plain
    version), f32 logits within 1e-4; prefill + decode on the card
    reproduce the card's forward at 2e-3 (tests/test_arch_smoke.py:92)."""
    import dataclasses

    from repro_torch.configs.registry import _load
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_load(arch, smoke=True)[1], attn_impl="pallas")
    params = materialize(tf.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu", default_dtype=cfg.dtype)
    on_card = {"embed": params["embed"].to(cuda),
               "final_norm": params["final_norm"].to(cuda),
               "unembed": params["unembed"].to(cuda),
               "layers": {k: t.to(cuda) for k, t in params["layers"].items()}}
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    n0 = build.LAUNCHES["flash_attention"]
    got, kv_got, _ = tf.forward(on_card, toks.to(cuda), cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    want, kv_want, _ = tf.forward(params, toks, cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    for a, b in zip(kv_got, kv_want):
        assert float((a.cpu() - b).abs().max()) <= 1e-4
    _, kvs = tf.make_prefill_step(cfg)(on_card, {"tokens": toks[:, :36].to(cuda)})
    caches = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4)) for t in kvs)
    n1 = build.LAUNCHES["flash_attention"]
    for i in range(36, 40):
        logits, caches = tf.make_serve_step(cfg)(
            on_card, toks[:, i:i + 1].to(cuda), caches, i)
        torch.testing.assert_close(logits, got[:, i], rtol=2e-3, atol=2e-3)
    assert build.LAUNCHES["flash_attention"] == n1     # decode: no kernel


@pytest.mark.parametrize("arch", ["gemma-7b", "deepseek-7b",
                                  "mistral-large-123b"])
def test_transformer_smoke_serve_bf16_launches_tc_kernel(cuda, arch):
    """The serve path in bf16 (the smoke configs in the full configs' type)
    with attn_impl="pallas": the prefill launches the tensor-core kernel
    once a layer and nothing else, decode launches no kernel, and each
    layer's attention is within 2 bf16 ulps of the plain version."""
    import dataclasses

    from repro_torch.configs.registry import _load
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    cfg = dataclasses.replace(_load(arch, smoke=True)[1], attn_impl="pallas",
                              dtype="bfloat16")
    params = materialize(tf.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu", default_dtype=cfg.dtype)
    on_card = {"embed": params["embed"].to(cuda),
               "final_norm": params["final_norm"].to(cuda),
               "unembed": params["unembed"].to(cuda),
               "layers": {k: t.to(cuda) for k, t in params["layers"].items()}}
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1)).to(cuda)
    real, worst = tf.attention, []

    def checked(q, k, v, c, **kw):
        out = real(q, k, v, c, **kw)
        plain = flash_attention_p_plain(
            *(t.transpose(1, 2) for t in (q, k, v)), scale=c.hd ** -0.5,
            causal=True, q_offset=0, kv_len=k.shape[1], block_q=q.shape[1],
            block_k=k.shape[1])
        worst.append(_bf16_ulps(out, plain.transpose(1, 2)))
        return out

    build.reset_launches()
    tf.attention = checked
    try:
        logits, kvs = tf.make_prefill_step(cfg)(on_card, {"tokens": toks})
    finally:
        tf.attention = real
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == dict(
        {n: 0 for n in build.COUNTERS}, flash_attention_tc=cfg.n_layers)
    assert len(worst) == cfg.n_layers and max(worst) <= FLASH_BF16_ULPS
    caches = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 2)) for t in kvs)
    build.reset_launches()
    tok = logits.argmax(-1)[:, None].to(torch.int32)
    for i in range(2):
        logits, caches = tf.make_serve_step(cfg)(on_card, tok, caches, 40 + i)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
    assert bool(torch.isfinite(logits).all())
    assert sum(build.LAUNCHES.values()) == 0


# ------------------------------------- kernel 12 f32 on the tensor cores --

@pytest.mark.parametrize("case", ["gqa", "decode", "kv_straddle"])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_flash_attention_f32_every_head_dim(cuda, D, case):
    """The f32 route (3xTF32 on wgmma) at every head width the kernel is
    built for: a GQA group of 2 over 200 causal rows (the last kv tile of 32
    straddles the diagonal and kv_len), gemma's decode shape (Sq = 1,
    q_offset = Skv - 1), and kv_len 70 inside a kv tile with more q rows
    than keys; one flash_attention launch, within 2e-5 of the plain
    version."""
    B, Hq, Hkv, Sq, Skv, causal, off = {
        "gqa": (1, 4, 2, 200, 200, True, 0),
        "decode": (2, 4, 4, 1, 300, True, 299),
        "kv_straddle": (2, 2, 1, 150, 70, False, 0)}[case]
    q, k, v = _flash_inputs(cuda, torch.float32, B, Hq, Hkv, Sq, Skv, D,
                            seed=D)
    kw = dict(causal=causal, q_offset=off, block_q=min(64, Sq), block_k=64)
    n0 = build.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attention"] == n0 + 1
    bq = kw["block_q"]
    pad = lambda t, b: torch.nn.functional.pad(  # noqa: E731
        t, (0, 0, 0, (-t.shape[2]) % b))
    want = flash_attention_p_plain(
        pad(q, bq), pad(k, 64), pad(v, 64), scale=D ** -0.5, causal=causal,
        q_offset=off, kv_len=Skv, block_q=bq, block_k=64)[:, :, :Sq]
    err = float((out - want).abs().max())
    assert err <= FLASH_F32_TOL, err


@pytest.mark.parametrize("D", [128, 256])
def test_flash_attention_f32_one_tf32_product_fails(cuda, D):
    """The planted fault: the f32 kernel with its lo products dropped (one
    TF32 product, 1xTF32, through the uncounted launcher) misses the 2e-5
    that the kernel itself meets."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        _launch_f32)
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 4, 4, 512, 512, D)
    kw = dict(scale=D ** -0.5, causal=True, q_offset=0, kv_len=512)
    want = flash_attention_p_plain(q, k, v, block_q=128, block_k=128, **kw)
    n0 = dict(build.LAUNCHES)
    out = torch.empty_like(q)
    _launch_f32(q, k, v, out, **kw)
    assert float((out - want).abs().max()) <= FLASH_F32_TOL
    _launch_f32(q, k, v, out, split=False, **kw)
    assert float((out - want).abs().max()) > FLASH_F32_TOL
    assert build.LAUNCHES == n0


# ----------------------------------------------------- kernels 5 and 6 ----

def _merge_case(layout, K, eb, all_inf, device, vb=128):
    """Two shards of 1000 vertices (tiles of ``vb``) receiving from 4
    senders x 400 bucket positions: tile 2 receives nothing, the hot tile 0
    takes a third of the messages (several chunks), query 0's incoming row
    is all +inf (or every row, with ``all_inf``). Returns (args, kw) of the
    wrapper of ``layout``."""
    rng = np.random.default_rng(5 * K + eb)
    block, Pn, C = 1000, 4, 400
    lays, incs = [], []
    for _ in range(2):
        ridx = rng.integers(0, block, (Pn, C))
        ridx[(ridx >= 2 * vb) & (ridx < 3 * vb)] = block   # tile 2 empty
        ridx[rng.random(ridx.shape) < 0.33] = 5
        ridx[rng.random(ridx.shape) < 0.1] = block          # no message
        build_ = (build_msg_tiled_layout if layout == "dense"
                  else build_msg_ragged_layout)
        lays.append(build_(ridx, block, vb=vb, eb=eb))
        inc = _rows(rng, (K, Pn * C), 0.4)
        inc[0] = np.inf
        if all_inf:
            inc[:] = np.inf
        inc[:, ridx.reshape(-1) >= block] = np.inf
        incs.append(inc)
    incoming = torch.from_numpy(np.stack(incs))
    if layout == "dense":
        nch = max(lay[0].shape[1] for lay in lays)
        planes = [torch.stack([torch.nn.functional.pad(
            lay[k], (0, 0, 0, nch - lay[k].shape[1])) for lay in lays])
            for k in range(3)]
        bp = lays[0][3]
    else:
        bp = lays[0][4]
        pos, rel, valid, ctile = _stack_ragged(lays, (0, 0, 0, bp // vb))
        planes = [ctile, pos, rel, valid]
    dist = pad_last(torch.from_numpy(_rows(rng, (2, K, block), 0.3)), bp,
                    float("inf"))
    return [a.to(device) for a in (dist, incoming, *planes)], dict(vb=vb)


@pytest.mark.parametrize("all_inf", [False, True])
@pytest.mark.parametrize("eb", [128, 102])
@pytest.mark.parametrize("K", [1, 3, 16, 17, 32])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_merge_kernels_match_plain_at_many_queries(cuda, layout, K, eb,
                                                   all_inf):
    """Kernels 5 and 6 bit-equal to their plain versions (out, front,
    recvs) at K 1, 3, 16 (one group of gathers), 17 and 32 (two groups),
    with a tile that receives no valid message, an all-inf incoming row,
    recvs summed over the CTAs of many tiles, and EB 102 (not a multiple of
    4: the quads read one word at a time)."""
    args, kw = _merge_case(layout, K, eb, all_inf, cuda)
    name = "merge" if layout == "dense" else "merge_ragged"
    kernel, plain = {"dense": (merge_scatter_tiled, merge_scatter_tiled_plain),
                     "ragged": (merge_scatter_ragged,
                                merge_scatter_ragged_plain)}[layout]
    n0 = build.LAUNCHES[name]
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    assert build.LAUNCHES[name] == n0 + 1
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    got_recvs = out[2]
    if all_inf:
        assert int(got_recvs.sum()) == 0 and torch.equal(out[0], args[0])
    else:
        assert int(got_recvs[:, 0].sum()) == 0
        if K > 1:
            assert int(got_recvs[:, 1:].min()) > 0
    # recvs is zeroed by the launch: a second call gives the same counts
    assert torch.equal(kernel(*args, **kw)[2], got_recvs)


@pytest.mark.parametrize("K,vb", [(451, 128), (512, 128), (1000, 128),
                                  (300, 256)])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_merge_kernels_match_plain_past_one_group(cuda, layout, K, vb):
    """Kernels 5 and 6 past one query group (a [K, vb] tile that lets an
    SM hold eight CTAs: 56 queries at vb 128, 28 at 256): the launch splits
    the queries into groups (nine at 451, ten at 512, eighteen at 1,000,
    eleven at 300 with vb 256, the first two past the most one block
    holds), each group's CTAs adding to its own queries' recvs; out, front
    and recvs bit-equal to the plain versions."""
    args, kw = _merge_case(layout, K, 128, False, cuda, vb=vb)
    name = "merge" if layout == "dense" else "merge_ragged"
    kernel, plain = {"dense": (merge_scatter_tiled, merge_scatter_tiled_plain),
                     "ragged": (merge_scatter_ragged,
                                merge_scatter_ragged_plain)}[layout]
    n0 = build.LAUNCHES[name]
    out = kernel(*args, **kw)
    ref = plain(*args, **kw)
    assert build.LAUNCHES[name] == n0 + 1
    for got, want in zip(out, ref):
        assert torch.equal(got, want)
    assert int(out[2][:, 0].sum()) == 0 and int(out[2][:, 1:].min()) > 0


def test_merge_kernels_reject_a_tile_past_shared_memory(cuda):
    """A vertex tile too wide for even one query (65,536 vertices: 256 KB
    of keys) raises before any launch; no fallback."""
    vb, eb = 65536, 4
    dist = torch.zeros((1, 1, vb), device=cuda)
    inc = torch.zeros((1, 1, 4), device=cuda)
    lay = torch.zeros((1, 1, 1, eb), dtype=torch.int32, device=cuda)
    ct = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    n0 = dict(build.LAUNCHES)
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        merge_scatter_tiled(dist, inc, lay, lay, lay, vb=vb)
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        merge_scatter_ragged(dist, inc, ct, lay[0], lay[0], lay[0], vb=vb)
    assert build.LAUNCHES == n0


# ------------------------------ the engine past one query group (3-6) ----

@pytest.mark.parametrize("K", [300, 1000])
@pytest.mark.parametrize("layout,rnd", [("dense", "staged"),
                                        ("ragged", "staged"),
                                        ("ragged", "fused"),
                                        ("dense", "fused")])
def test_engine_many_queries_on_gpu(cuda, layout, rnd, K):
    """K = 300 (bucket 512) and 1,000 (bucket 1,024) sources on the card,
    past one query group of kernels 3-6 at the engine's tiles of 128 (past
    the 418 queries one send group holds): converged, equal to the CPU run in
    distances, every counter and status, and to the same sources solved on
    the card in batches of at most 256 in distances and per-query rounds and
    relaxations."""
    g = tg.rmat_graph(scale=8, edge_factor=4, seed=1)
    sh = tc.build_shards(g, 4, layout=layout, relax_eb=EB, send_eb=EB,
                         merge_eb=EB)
    rng = np.random.default_rng(K)
    deg = np.diff(g.row_ptr.numpy())
    srcs = [int(s) for s in rng.choice(np.nonzero(deg)[0], K)]
    cfg = (tc.SsspConfig(**ALL_KERNELS) if rnd == "staged"
           else tc.SsspConfig(round="fused"))
    build.reset_launches()
    eng = tc.SsspEngine.build(sh, cfg)
    on_gpu = eng.solve(srcs)
    sfx = "_ragged" if layout == "ragged" else ""
    if rnd == "staged":
        assert min(build.LAUNCHES[k + sfx] for k in STAGED) > 0
    else:
        assert build.LAUNCHES["round" + sfx] == int(on_gpu.stats.rounds)
    assert on_gpu.bucket_k == (512 if K == 300 else 1024)
    assert on_gpu.status == "converged" and on_gpu.q_converged.all()
    on_cpu = tc.SsspEngine.build(sh, cfg, device="cpu").solve(srcs)
    assert on_cpu.status == on_gpu.status
    np.testing.assert_array_equal(on_gpu.dist, on_cpu.dist)
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(on_gpu.stats, f)),
                                      np.asarray(getattr(on_cpu.stats, f)),
                                      err_msg=f)
    parts = [eng.solve(srcs[i:i + 256]) for i in range(0, K, 256)]
    np.testing.assert_array_equal(np.concatenate([p.dist for p in parts]),
                                  on_gpu.dist)
    for f in ("q_rounds", "q_relaxations"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, f) for p in parts]),
            getattr(on_gpu, f), err_msg=f)


# ------------------------------------------------- the session engine --

def _engine_case(layout, triangles=True):
    """R-MAT scale 9 on 4 shards in ``layout``, 3 live sources and 4 live
    pivots (none of them a source)."""
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    sh = tc.build_shards(g, 4, layout=layout, relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB,
                         enumerate_triangles=triangles)
    rng = np.random.default_rng(6)
    live = np.nonzero(np.diff(g.row_ptr.numpy()))[0]
    picks = [int(s) for s in rng.choice(live, 7, replace=False)]
    return sh, picks[:3], picks[3:]


def _assert_same(a, b):
    np.testing.assert_array_equal(a.dist, b.dist)
    for f in COUNTERS + ("q_converged",):
        np.testing.assert_array_equal(np.asarray(getattr(a.stats, f)),
                                      np.asarray(getattr(b.stats, f)),
                                      err_msg=f)
    assert (a.status, a.warm_started) == (b.status, b.warm_started)


@pytest.mark.parametrize("config", ["staged", "fused"])
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_warm_engine_on_gpu_matches_cold_and_cpu(cuda, layout, config):
    """A landmark-warm solve on the card (round 0 with every seeded vertex
    in the frontier) equals the card's cold solve in distances and the
    CPU's warm solve in distances and every counter, through the
    layout's kernels."""
    sh, srcs, piv = _engine_case(layout)
    base = (dict(ALL_KERNELS) if config == "staged"
            else dict(round="fused", pallas_sweeps=2))
    cfg = tc.SsspConfig(**base, warm_start="landmark")
    on_cpu = tc.SsspEngine.build(sh, cfg, device="cpu")
    on_cpu.precompute_landmarks(piv)
    eng = tc.SsspEngine.build(sh, cfg)
    lm = eng.precompute_landmarks(piv)
    assert lm.dist.is_cuda
    np.testing.assert_array_equal(lm.dist.cpu().numpy(),
                                  on_cpu.landmarks.dist.numpy())
    build.reset_launches()
    warm = eng.solve(srcs)
    sfx = "_ragged" if layout == "ragged" else ""
    names = STAGED if config == "staged" else ("round",)
    assert min(build.LAUNCHES[k + sfx] for k in names) > 0
    assert warm.warm_started and warm.status == "converged"
    _assert_same(warm, on_cpu.solve(srcs))
    cold = tc.SsspEngine.build(sh, tc.SsspConfig(**base)).solve(srcs)
    np.testing.assert_array_equal(warm.dist, cold.dist)


def test_drain_on_gpu_matches_single_solves(cuda):
    """Single-source handles drained on the card in buckets of 4 equal
    K=1 solves of their sources (distances, per-query rounds and
    relaxations: no triangles, so no online Trishla, whose idle shards
    depend on the batch), and the CPU's drain."""
    sh, srcs, piv = _engine_case("dense", triangles=False)
    cfg = tc.SsspConfig(**ALL_KERNELS)
    eng = tc.SsspEngine.build(sh, cfg, max_bucket=4)
    cpu = tc.SsspEngine.build(sh, cfg, device="cpu", max_bucket=4)
    sources = srcs + piv
    hs = [eng.submit(s) for s in sources]
    hc = [cpu.submit(s) for s in sources]
    build.reset_launches()
    out = eng.drain()
    cpu.drain()
    assert min(build.LAUNCHES[k] for k in STAGED) > 0
    assert [r.bucket_k for r in out] == [4] * 7
    assert eng.batches_served == 2 and eng.queries_served == 7
    for h, c, s in zip(hs, hc, sources):
        one = eng.solve([s])
        for f in ("dist", "q_rounds", "q_relaxations", "q_converged"):
            np.testing.assert_array_equal(getattr(h.result(), f),
                                          getattr(one, f), err_msg=f)
        _assert_same(h.result(), c.result())


@pytest.mark.parametrize("config", ["delta", "toka1", "toka1-fused"])
def test_delta_and_toka1_on_gpu_match_cpu(cuda, config):
    """The delta local solver (plain ops on the card) and toka1 (staged
    kernels, fused kernel) on the card equal their CPU solves in
    distances and every counter, and the toka0 solve in distances."""
    sh, srcs, _ = _engine_case("dense")
    extra = {"delta": dict(local_solver="delta"),
             "toka1": dict(ALL_KERNELS, toka="toka1"),
             "toka1-fused": dict(round="fused", toka="toka1")}[config]
    cfg = tc.SsspConfig(**extra)
    on_gpu = tc.SsspEngine.build(sh, cfg).solve(srcs)
    _assert_same(on_gpu, tc.SsspEngine.build(sh, cfg,
                                             device="cpu").solve(srcs))
    toka0 = tc.SsspEngine.build(sh, tc.SsspConfig(**ALL_KERNELS)).solve(srcs)
    assert on_gpu.status == "converged"
    np.testing.assert_array_equal(on_gpu.dist, toka0.dist)


# ------------------------------------- the asynchronous mode (exchanges) --

EXCHANGE_SETTINGS = {"bucket": {}, "async": {},
                     "async_bucket": dict(async_lag=2), "pmin": {},
                     "a2a_dense": {}, "async_ppermute": {}}
DENSE_EXCHANGES = ("pmin", "a2a_dense", "async_ppermute")


def _assert_same_async(a, b):
    _assert_same(a, b)
    for f in ("stale_merges", "overlap_rounds", "n_dispatches"):
        assert int(getattr(a.stats, f)) == int(getattr(b.stats, f)), f


@pytest.mark.parametrize("rnd", ["staged", "fused"])
@pytest.mark.parametrize("exchange", sorted(EXCHANGE_SETTINGS))
@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_exchanges_on_gpu_match_cpu(cuda, layout, exchange, rnd):
    """Every exchange, staged (all-kernel) and fused, on the card equals
    its CPU solve in distances and every counter and the bucket solve in
    distances. Launches: the fused round one round kernel a round (its
    dense merge mode under a dense exchange) and no merge kernel; the
    staged round the merge kernel only under a bucketed exchange."""
    sh, srcs, _ = _engine_case(layout)
    base = (dict(ALL_KERNELS) if rnd == "staged"
            else dict(round="fused", pallas_sweeps=2))
    cfg = tc.SsspConfig(**base, exchange=exchange,
                        **EXCHANGE_SETTINGS[exchange])
    build.reset_launches()
    on_gpu = tc.SsspEngine.build(sh, cfg).solve(srcs)
    got = dict(build.LAUNCHES)
    _assert_same_async(on_gpu, tc.SsspEngine.build(sh, cfg, device="cpu")
                       .solve(srcs))
    assert on_gpu.status == "converged"
    sync = tc.SsspEngine.build(sh, tc.SsspConfig(**base)).solve(srcs)
    np.testing.assert_array_equal(on_gpu.dist, sync.dist)
    sfx = "_ragged" if layout == "ragged" else ""
    rounds = int(on_gpu.stats.rounds)
    if rnd == "fused":
        assert got["round" + sfx] == rounds and got["merge" + sfx] == 0
    else:
        assert got["relax" + sfx] > 0 and got["send" + sfx] > 0
        assert (got["merge" + sfx] == 0) == (exchange in DENSE_EXCHANGES)
    if exchange.startswith("async"):
        assert rounds > int(sync.stats.rounds)
        assert int(on_gpu.stats.stale_merges) > 0


@pytest.mark.parametrize("exchange", ["bucket", "async", "a2a_dense"])
@pytest.mark.parametrize("toka", ["toka2", "toka3"])
def test_detectors_on_gpu_match_cpu(cuda, toka, exchange):
    """toka2 (the token ring) and toka3 (the timeout) on the card equal
    their CPU solves in distances and every counter, and the toka0 solve
    of the same exchange in distances."""
    sh, srcs, _ = _engine_case("dense")
    cfg = tc.SsspConfig(**ALL_KERNELS, exchange=exchange, toka=toka)
    on_gpu = tc.SsspEngine.build(sh, cfg).solve(srcs)
    _assert_same_async(on_gpu, tc.SsspEngine.build(sh, cfg, device="cpu")
                       .solve(srcs))
    toka0 = tc.SsspEngine.build(sh, tc.SsspConfig(
        **ALL_KERNELS, exchange=exchange)).solve(srcs)
    assert on_gpu.status == "converged"
    np.testing.assert_array_equal(on_gpu.dist, toka0.dist)
    assert int(on_gpu.stats.rounds) > int(toka0.stats.rounds)


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_round_kernel_dense_mode_at_a_deferred_state(cuda, layout):
    """Kernels 7 and 8 in their dense merge mode at a state of a fused
    ``async_ppermute`` solve (the first round from the third on whose
    delivered dense row holds a message, out of phase with the frontier),
    all six outputs bit-equal to their plain versions, for 1 and 8
    sweeps."""
    sh, srcs, _ = _engine_case(layout)
    eng = tc.SsspEngine.build(sh, tc.SsspConfig(round="fused",
                                                exchange="async_ppermute"))
    carry = eng.start(srcs)
    for r in range(12):
        carry = eng.round_fn(carry)
        if r >= 2 and bool(torch.isfinite(carry.incoming).any()):
            break
    dsh = eng.shards
    assert carry.incoming.shape == carry.dist.shape
    assert bool(torch.isfinite(carry.incoming).any())
    live = ~carry.done
    ops = fused_round_operands(
        carry.dist, carry.active & live[..., None], live, carry.incoming,
        carry.last_sent, dsh.slot_valid, dsh.relax_layout, dsh.send_layout,
        dsh.merge_layout, carry.pruned[:, :dsh.e_loc],
        carry.pruned[:, dsh.e_loc:], vb=dsh.rx_vb, sb=dsh.tx_sb, dense=True)
    ragged = layout == "ragged"
    kernel, plain = ((fused_round_ragged, fused_round_ragged_plain)
                     if ragged else
                     (fused_round_tiled, fused_round_tiled_plain))
    chunks = {} if ragged else dict(chunks=dsh.round_chunks)
    for sweeps in (1, 8):
        kw = dict(vb=dsh.rx_vb, sb=dsh.tx_sb, n_sweeps=sweeps, dense=True)
        out = kernel(*ops, **kw, **chunks)
        ref = plain(*ops, **kw)
        for got, want in zip(out, ref):
            assert torch.equal(got, want)


# ---------------------------------------------- fault injection (item 7b) --

FAULT_PLANS = {"drop": dict(drop=0.3, resend_period=4),
               "delay": dict(delay=0.4), "duplicate": dict(duplicate=0.4),
               "reorder": dict(reorder=0.4)}


def test_fault_draws_on_gpu_match_cpu(cuda):
    """The injector's draws on the card equal the CPU's bit for bit:
    ``uniform`` and ``randint`` under the per-shard keys of two rounds,
    [P, K, M] at a width past one CTA's."""
    from repro_torch.core import prng
    from repro_torch.core.faults import round_keys
    shape = (5, 70_001)
    for rnd in (0, 9):
        keys = round_keys(tc.FaultPlan(delay=0.4, seed=12), rnd, 8, "cpu")
        for k_dev, k_cpu in zip(prng.split(keys.to(cuda)), prng.split(keys)):
            u = prng.uniform(k_dev, shape)
            assert u.device.type == cuda.type
            assert torch.equal(u.cpu().view(torch.int32),
                               prng.uniform(k_cpu, shape).view(torch.int32))
            assert torch.equal(prng.randint(k_dev, shape, 0, 3).cpu(),
                               prng.randint(k_cpu, shape, 0, 3))


@pytest.mark.parametrize("rnd", ["staged", "fused"])
@pytest.mark.parametrize("exchange", ["bucket", "a2a_dense"])
@pytest.mark.parametrize("regime", sorted(FAULT_PLANS))
def test_faults_on_gpu_match_cpu(cuda, regime, exchange, rnd):
    """Each regime of the fault matrix under bucket and a2a_dense, staged
    (all-kernel) and fused: the card's solve equals the CPU's in distances
    and every counter (stale_merges and resends included), converged, the
    fault-free distances; the path's kernels launched."""
    sh, srcs, _ = _engine_case("dense")
    base = (dict(ALL_KERNELS) if rnd == "staged"
            else dict(round="fused", pallas_sweeps=2))
    cfg = tc.SsspConfig(**base, exchange=exchange,
                        faults=tc.FaultPlan(**FAULT_PLANS[regime]))
    build.reset_launches()
    on_gpu = tc.SsspEngine.build(sh, cfg).solve(srcs)
    got = dict(build.LAUNCHES)
    on_cpu = tc.SsspEngine.build(sh, cfg, device="cpu").solve(srcs)
    _assert_same_async(on_gpu, on_cpu)
    assert int(on_gpu.stats.resends) == int(on_cpu.stats.resends)
    assert on_gpu.status == "converged"
    clean = tc.SsspEngine.build(sh, tc.SsspConfig(
        **base, exchange=exchange)).solve(srcs)
    np.testing.assert_array_equal(on_gpu.dist, clean.dist)
    if rnd == "fused":
        assert got["round"] == int(on_gpu.stats.rounds) and not got["merge"]
    else:
        assert got["relax"] > 0 and got["send"] > 0
        assert (got["merge"] > 0) == (exchange == "bucket")
    if regime == "drop":
        assert int(on_gpu.stats.resends) > 0


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_send_and_round_kernels_with_resend_rows(cuda, layout):
    """Kernels 3/4 and 7/8 at a mid-solve state with ``last_sent`` +inf on
    every other query (what a resend round hands them): bit-equal to their
    plain versions, and more sends than without."""
    sh, srcs, _ = _engine_case(layout)
    eng = tc.SsspEngine.build(sh, tc.SsspConfig(round="fused"))
    carry = eng.start(srcs)
    for _ in range(2):
        carry = eng.round_fn(carry)
    dsh = eng.shards
    resend = carry.last_sent.clone()
    resend[:, ::2] = float("inf")
    live = ~carry.done
    ragged = layout == "ragged"
    kernel, plain = ((fused_round_ragged, fused_round_ragged_plain)
                     if ragged else
                     (fused_round_tiled, fused_round_tiled_plain))
    chunks = {} if ragged else dict(chunks=dsh.round_chunks)
    kw = dict(vb=dsh.rx_vb, sb=dsh.tx_sb, n_sweeps=8, dense=False)
    sends = []
    for last in (carry.last_sent, resend):
        ops = fused_round_operands(
            carry.dist, carry.active & live[..., None], live,
            carry.incoming.reshape(*carry.dist.shape[:2], -1), last,
            dsh.slot_valid, dsh.relax_layout, dsh.send_layout,
            dsh.merge_layout, carry.pruned[:, :dsh.e_loc],
            carry.pruned[:, dsh.e_loc:], vb=dsh.rx_vb, sb=dsh.tx_sb,
            dense=False)
        out = kernel(*ops, **kw, **chunks)
        for got, want in zip(out, plain(*ops, **kw)):
            assert torch.equal(got, want)
        sends.append(int(out[5].sum()))
        lay = dsh.send_layout
        pruned_t = torch.zeros(lay[3].shape, dtype=torch.int32,
                               device=cuda)
        n_stiles = dsh.n_stiles if ragged else lay[0].shape[1]
        s_ops = send_operands(out[0][..., :dsh.block], last, dsh.slot_valid,
                              n_stiles, dsh.tx_sb)
        if ragged:
            s_args = (*s_ops, lay[4], *lay[:3], pruned_t)
            s_out = send_pack_ragged(*s_args, sb=dsh.tx_sb,
                                     bounds=dsh.send_bounds)
            s_ref = send_pack_ragged_plain(*s_args, sb=dsh.tx_sb)
        else:
            s_args = (*s_ops, *lay[:3], pruned_t)
            s_out = send_pack_tiled(*s_args, sb=dsh.tx_sb)
            s_ref = send_pack_tiled_plain(*s_args, sb=dsh.tx_sb)
        for got, want in zip(s_out, s_ref):
            assert torch.equal(got, want)
    assert sends[1] > sends[0]


# ------------------------------------------------ the shmap backend ----

def _plain_wrappers(monkeypatch):
    """Swap the solver's kernel wrappers, where the ops modules call them,
    for their plain versions (the schedule arguments dropped)."""
    import importlib
    for mod, names in (
            ("relax", ("relax_dst_tiled_fixpoint_batch",
                       "relax_dst_ragged_fixpoint_batch")),
            ("send", ("send_pack_tiled", "send_pack_ragged")),
            ("merge", ("merge_scatter_tiled", "merge_scatter_ragged")),
            ("round", ("fused_round_tiled", "fused_round_ragged"))):
        ops = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
        impl = importlib.import_module(f"repro_torch.kernels.{mod}.{mod}")
        for n in names:
            plain = getattr(impl, f"{n}_plain")
            monkeypatch.setattr(ops, n, functools.partial(
                lambda p, *a, chunks=None, bounds=None, **kw: p(*a, **kw),
                plain))


def _flat(x):
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    return [x]


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_kernels_on_a_one_shard_stack_match_plain(cuda, layout, monkeypatch):
    """A rank of the shmap backend runs the round's kernels (1/2, 3/4, 5/6,
    7/8) on its one-shard stack (``SsspShards.shard``): each, through the
    round's phase function on every shard's [1, ...] view at round 2 of a
    solve, launches its kernel and is bit-equal to its plain version on the
    same inputs."""
    from repro_torch.core import sssp as S
    from repro_torch.core.local_solver import _batch_pallas
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    cfg = tc.SsspConfig(**ALL_KERNELS)
    eng = tc.SsspEngine.build(g, cfg, n_parts=4, device=cuda, layout=layout,
                              enumerate_triangles=False)
    dsh = eng.shards
    carry = eng.start([0, 5, 77])
    for _ in range(2):
        carry = eng.round_fn(carry)
    live = ~carry.done
    act = carry.active & live[..., None]
    payload = S._phase_send_pallas(dsh, carry.dist, carry.pruned,
                                   carry.last_sent)[0]
    incoming = payload.transpose(0, 2).contiguous()
    sfx = "_ragged" if layout == "ragged" else ""
    for r in range(dsh.n_parts):
        v = dsh.shard(r)
        assert v.n_rows == 1 and v.n_parts == 4 and v.row0 == r

        def row(t):
            return t[r:r + 1]

        calls = {
            "relax": lambda: _batch_pallas(
                row(carry.dist), row(act), v.loc_src, v.loc_dst, v.loc_w,
                row(carry.pruned)[:, :v.e_loc], max_iters=cfg.local_iters,
                delta=cfg.delta, relax_layout=v.relax_layout,
                relax_vb=v.rx_vb, pallas_sweeps=cfg.pallas_sweeps,
                chunks=v.relax_chunks),
            "send": lambda: S._phase_send_pallas(
                v, row(carry.dist), row(carry.pruned), row(carry.last_sent)),
            "merge": lambda: S._phase_merge_pallas(v, row(carry.dist),
                                                   row(incoming)),
            "round": lambda: S._phase_fused(
                v, row(carry.dist), row(act), row(live), row(incoming),
                row(carry.last_sent), row(carry.pruned), cfg, dense=False)}
        for name, call in calls.items():
            build.reset_launches()
            got = _flat(tuple(call()))
            if name != "relax" or bool(row(act).any()):
                assert build.LAUNCHES[name + sfx] >= 1, (r, name)
            with monkeypatch.context() as m:
                _plain_wrappers(m)
                want = _flat(tuple(call()))
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a, b), (r, name)


def test_shmap_on_cuda_over_gloo_matches_sim(cuda, tmp_path):
    """Four gloo ranks on the card (CUDA tensors in the collectives), one
    shard each, all-kernel staged, fused under async_ppermute with toka2,
    drop with resend under toka3, the landmark warm start and ragged
    shards: every rank's result equals the sim engine's on the card in
    distances, every counter, status and the engine's accounting."""
    import _torch_dist_ref as dref
    scs = [dict(cfg=dict(ALL_KERNELS)),
           dict(cfg=dict(round="fused", exchange="async_ppermute",
                         toka="toka2")),
           dict(shards="faults", cfg=dict(ALL_KERNELS, toka="toka3",
                                          faults=dict(drop=0.2, seed=0,
                                                      resend_period=4))),
           dict(op="warm", landmarks=[3, 60, 120],
                cfg=dict(ALL_KERNELS, warm_start="landmark")),
           dict(shards="ragged", sources=[1, 9, 40], cfg=dict(ALL_KERNELS))]
    per_rank, sims = dref.run_ranks(
        dref.rank_scenarios, tmp_path, scs, world=4, device="cuda",
        meanwhile=lambda: [dref.sim_scenario(sc, "cuda") for sc in scs])
    for i, want in enumerate(sims):
        for res in per_rank:
            dref.assert_same_scenario(res[i], want)


def _round2(sh, cfg, sources, device):
    eng = tc.SsspEngine.build(sh, cfg, device=device)
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    return eng, carry


def _phase_calls(eng, carry, fused_eng, fused_carry):
    """sim_phase_fns' callables with their round-2 arguments."""
    fns = tc.sim_phase_fns(eng.shards, eng.cfg)
    ffns = tc.sim_phase_fns(fused_eng.shards, fused_eng.cfg)
    act = carry.active & ~carry.done[..., None]
    local = fns["local"](carry.dist, act, carry.pruned, carry.tri_cursor)
    send = fns["send"](local[0], local[1], carry.last_sent)
    live = ~fused_carry.done
    return {
        "local": local, "send": send,
        "merge": fns["merge"](local[0], fns["exchange"](send[0])),
        "fused": ffns["fused"](fused_carry.dist,
                               fused_carry.active & live[..., None], live,
                               fused_carry.incoming, fused_carry.last_sent,
                               fused_carry.pruned)}


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_sim_phase_fns_on_the_card_match_the_cpu(cuda, layout):
    """``sim_phase_fns`` with the pallas backends launches kernels 1/2,
    3/4, 5/6 and 7/8 on the card, each phase equal bit for bit to the
    same phase on the CPU (the plain versions) at round 2."""
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    sh = tc.build_shards(g, 4, layout=layout, enumerate_triangles=False)
    cfg, fcfg = tc.SsspConfig(**ALL_KERNELS), tc.SsspConfig(round="fused")
    out = {}
    for dev in (cuda, "cpu"):
        build.reset_launches()
        out[str(dev)] = _phase_calls(*_round2(sh, cfg, [0, 5, 77], dev),
                                     *_round2(sh, fcfg, [0, 5, 77], dev))
        if dev is cuda:
            sfx = "_ragged" if layout == "ragged" else ""
            for k in STAGED + ("round",):
                assert build.LAUNCHES[k + sfx] >= 1, k
    for name, got in out[str(cuda)].items():
        for a, b in zip(_flat(tuple(got)), _flat(tuple(out["cpu"][name])),
                        strict=True):
            assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_shard_wrappers_on_the_card_match_the_cpu(cuda, layout):
    """The reference's per-shard wrappers launch their kernels on the card
    and equal the same calls on the CPU bit for bit."""
    from repro_torch.kernels.merge import merge_scatter_pallas
    from repro_torch.kernels.relax import (
        relax_fixpoint_batch_pallas, relax_fixpoint_batch_ragged_pallas)
    from repro_torch.kernels.send import send_pack_pallas
    from repro_torch.core.local_solver import local_fixpoint_pallas_batch
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    sh = tc.build_shards(g, 2, layout=layout, enumerate_triangles=False)
    dist, active, pruned, last = (t[0] for t in _state(sh, 3, seed=5))
    ragged = layout == "ragged"
    sfx = "_ragged" if ragged else ""
    tx = tuple(a[0] for a in sh.send_layout)
    mx = tuple(a[0] for a in sh.merge_layout)
    rx = tuple(a[0] for a in sh.relax_layout)
    rng = np.random.default_rng(6)
    inc = rng.uniform(0, 50, (3, sh.n_parts * sh.bucket_cap)).astype(
        np.float32)
    inc[:, sh.recv_idx[0].reshape(-1).numpy() >= sh.block] = np.inf
    inc = torch.from_numpy(inc)
    d_pad, f_pad, rx_p = fixpoint_operands(
        dist[None], active[None], pruned[None, :sh.e_loc], rx[3][None],
        -(-sh.block // sh.rx_vb) * sh.rx_vb if ragged
        else rx[0].shape[0] * sh.rx_vb)
    tx_p = torch.gather(pad_last(pruned[sh.e_loc:].int(), sh.e_cut + 1, 0),
                        0, tx[3].reshape(-1).long()).reshape(tx[3].shape)
    calls = {
        "send": lambda d: send_pack_pallas(
            *(t.to(d) for t in (dist, last, sh.slot_valid[0], *tx[:3], tx_p)),
            *((tx[4].to(d),) if ragged else ()), sb=sh.tx_sb, eb=sh.tx_eb),
        "merge": lambda d: merge_scatter_pallas(
            *(t.to(d) for t in (dist, inc, *mx)), vb=sh.mx_vb, eb=sh.mx_eb),
        "relax": lambda d: (
            relax_fixpoint_batch_ragged_pallas(
                d_pad[0].to(d), f_pad[0].to(d), rx[4].to(d),
                *(t.to(d) for t in rx[:3]), rx_p[0].to(d), vb=sh.rx_vb,
                eb=sh.rx_eb, n_sweeps=4) if ragged else
            relax_fixpoint_batch_pallas(
                d_pad[0].to(d), f_pad[0].to(d), *(t.to(d) for t in rx[:3]),
                rx_p[0].to(d), vb=sh.rx_vb, eb=sh.rx_eb, n_sweeps=4)),
        "local": lambda d: local_fixpoint_pallas_batch(
            dist.to(d), active.to(d), pruned[:sh.e_loc].to(d),
            tuple(t.to(d) for t in rx), vb=sh.rx_vb, max_iters=100,
            sweeps=2)}
    for name, call in calls.items():
        kernel = "relax" if name == "local" else name
        build.reset_launches()
        got = _flat(tuple(call(cuda)))
        assert build.LAUNCHES[kernel + sfx] >= 1, name
        for a, b in zip(got, _flat(tuple(call("cpu"))), strict=True):
            assert torch.equal(a.cpu(), b), name


@pytest.mark.parametrize("layout", ["dense", "ragged"])
def test_no_layout_solves_on_the_card(cuda, layout):
    """Shards without tile layouts: the all-kernel and fused configs fall
    back to plain ops on the card too (no kernel launch) and equal the
    CPU's solve and the plain config on layout-full shards."""
    import warnings
    g = tg.rmat_graph(scale=9, edge_factor=8, seed=2)
    bare = tc.build_shards(g, 4, layout=layout, relax_layout=False,
                           comm_layout=False)
    full = tc.build_shards(g, 4, layout=layout)
    want = tc.SsspEngine.build(full, tc.SsspConfig(), device=cuda).solve(
        [0, 5, 77])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for cfg in (tc.SsspConfig(**ALL_KERNELS),
                    tc.SsspConfig(round="fused")):
            build.reset_launches()
            got = tc.SsspEngine.build(bare, cfg, device=cuda).solve(
                [0, 5, 77])
            assert not any(build.LAUNCHES.values())
            cpu = tc.SsspEngine.build(bare, cfg, device="cpu").solve(
                [0, 5, 77])
            for other in (want, cpu):
                np.testing.assert_array_equal(got.dist, other.dist)
                for f in COUNTERS + ("n_dispatches",):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(got.stats, f)),
                        np.asarray(getattr(other.stats, f)), err_msg=f)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """The SMOKE transformer in f32 (chunked attention): the loss and
    every gradient on the card against the CPU, then a train step; a
    gradient through attn_impl="pallas" raises on the card."""
    from repro_torch.configs.registry import _load
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    c = _load("deepseek-7b", smoke=True)[1]
    p = materialize(tf.param_defs(c), torch.Generator().manual_seed(0),
                    device="cpu", default_dtype=c.dtype)
    toks = torch.randint(0, c.vocab_size, (4, 41),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}
    lc, gc = tf._value_and_grad(p, batch, c)
    lg, gg = tf._value_and_grad(to(p, cuda), to(batch, cuda), c)
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc), strict=True):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())
    step = tf.make_train_step(c, AdamWConfig(), microbatches=2)
    _, _, mc = step(p, adamw_init(p), batch)
    _, _, mg = step(to(p, cuda), adamw_init(to(p, cuda)), to(batch, cuda))
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(
        float(mc["loss"]))
    with pytest.raises(NotImplementedError, match="no backward"):
        tf._value_and_grad(to(p, cuda), to(batch, cuda),
                           dataclasses.replace(c, attn_impl="pallas"))


# ------------------------------------------------ the MoE FFN, checkpoints --

def _moe_smoke(arch):
    from repro_torch.configs.registry import _load
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    cfg = dataclasses.replace(_load(arch, smoke=True)[1], attn_impl="pallas")
    params = materialize(tf.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu", default_dtype=cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (4, 41),
                         generator=torch.Generator().manual_seed(1))
    return cfg, params, toks


def _to_dev(tree, device):
    from repro_torch.models.params import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [t.to(device) for t in tree_leaves(tree)])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_moe_smoke_forward_on_gpu_matches_cpu(cuda, arch, monkeypatch):
    """The MoE smoke configs' forward in f32 with attn_impl="pallas": on
    the card (kernel 12's f32 route once a layer) against the CPU, logits
    within 1e-4 of the largest and every layer's routing (topi,
    slot_token, pos, keep) equal; then the loss and every gradient
    (chunked attention) within 1e-4 relative and 1e-3 of each gradient's
    largest value."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, toks = _moe_smoke(arch)
    real = moe._routing_group
    runs = {}
    for device in (cuda, torch.device("cpu")):
        routes = []

        def record(topi_g, *a):
            out = real(topi_g, *a)
            routes.append([t.cpu() for t in (topi_g, *out)])
            return out

        monkeypatch.setattr(moe, "_routing_group", record)
        n0 = build.LAUNCHES["flash_attention"]
        logits = tf.forward(_to_dev(params, device), toks[:2, :40].to(device),
                            cfg)[0].cpu()
        runs[device.type] = (logits, routes,
                             build.LAUNCHES["flash_attention"] - n0)
    (got, r_gpu, n_gpu), (want, r_cpu, _) = runs["cuda"], runs["cpu"]
    assert n_gpu == cfg.n_layers
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert len(r_gpu) == len(r_cpu) == cfg.n_layers
    for x, y in zip(r_gpu, r_cpu):
        assert all(torch.equal(a, b) for a, b in zip(x, y))
    monkeypatch.setattr(moe, "_routing_group", real)
    c = dataclasses.replace(cfg, attn_impl="chunked")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    lc, gc = tf._value_and_grad(params, batch, c)
    lg, gg = tf._value_and_grad(_to_dev(params, cuda), _to_dev(batch, cuda),
                                c)
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc), strict=True):
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())


def test_moe_top_k_breaks_ties_on_gpu_as_on_cpu(cuda):
    """The port's top-k (the first k of a stable descending sort) keeps the
    lower expert first among equal probabilities on the card as on the
    CPU, on bf16-rounded router logits full of ties."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(3)
    logits = (torch.randn((4096, 128), generator=g) * 0.05).bfloat16()
    probs = torch.softmax(logits.float(), dim=-1)
    for k in (1, 2, 8):
        vc, ic = moe.top_k(probs, k)
        vg, ig = moe.top_k(probs.to(cuda), k)
        assert torch.equal(ig.cpu(), ic) and torch.equal(vg.cpu(), vc)
    assert torch.equal(moe.top_k(torch.tensor(
        [[0.1, .3, .3, .3, 0, .3]], device=cuda), 3)[1].cpu(),
        torch.tensor([[1, 2, 3]], dtype=torch.int32))


def test_checkpoint_roundtrip_of_cuda_bf16_tensors(cuda, tmp_path):
    """A tree of CUDA tensors (bf16 parameters, the f32 AdamW state and
    its int32 step) saved and restored bit for bit onto the card, and onto
    params.abstract's meta tensors with the device named."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import abstract, materialize, tree_leaves
    from repro_torch.optim import adamw_init
    cfg, _, _ = _moe_smoke("olmoe-1b-7b")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = materialize(tf.param_defs(cfg), gen, device=cuda,
                         default_dtype="bfloat16")
    tree = (params, adamw_init(params))
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, tree)
    got, step = mgr.restore(tree)
    assert step == 1
    for a, b in zip(tree_leaves(got), tree_leaves(tree), strict=True):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)
    meta = abstract(tf.param_defs(cfg), "bfloat16")
    got = mgr.restore((meta, adamw_init(params)), device=cuda)[0][0]
    for a, b in zip(tree_leaves(got), tree_leaves(params), strict=True):
        assert a.device.type == "cuda" and torch.equal(a, b)


# -------------------------------------------------- AutoInt and the GNN zoo --

def _card_vs_cpu_grads(loss_f, params, batch, cfg, cuda):
    """The loss and every gradient on the card against the CPU: 1e-4
    relative in the loss, each gradient within 1e-3 of its largest
    value."""
    from repro_torch.models.gnn import value_and_grad
    from repro_torch.models.params import tree_leaves
    lc, gc = value_and_grad(loss_f, params, batch, cfg)
    lg, gg = value_and_grad(loss_f, _to_dev(params, cuda),
                            _to_dev(batch, cuda), cfg)
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    for a, b in zip(tree_leaves(gg), tree_leaves(gc), strict=True):
        assert a.device == lg.device
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())


@pytest.mark.parametrize("arch", ["gat-cora", "egnn", "mace", "graphcast"])
def test_gnn_smoke_on_gpu_matches_cpu(cuda, arch):
    """Each GNN's SMOKE config in f32 on the launcher's graph (256 nodes,
    1,024 edges): the forward output within 1e-4 of its largest value,
    the loss and every gradient card vs CPU, one train step's loss; no
    kernel launched."""
    from repro_torch.configs.registry import _load
    from repro_torch.launch.train import build_gnn
    from repro_torch.models import gnn
    from repro_torch.models.params import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    torch.backends.cuda.matmul.allow_tf32 = False
    c = _load(arch, smoke=True)[1]
    params, step, data = build_gnn(arch, c, AdamWConfig(), "cpu")
    batch = next(data)
    _, fwd, loss_f = gnn.MODELS[arch]
    build.reset_launches()
    want = tree_leaves(fwd(params, batch, c))
    got = tree_leaves(fwd(_to_dev(params, cuda), _to_dev(batch, cuda), c))
    for a, b in zip(got, want, strict=True):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    _card_vs_cpu_grads(loss_f, params, batch, c, cuda)
    _, _, mc = step(params, adamw_init(params), batch)
    pg = _to_dev(params, cuda)
    _, _, mg = step(pg, adamw_init(pg), _to_dev(batch, cuda))
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4 * abs(
        float(mc["loss"]))
    assert not any(build.LAUNCHES.values())


def test_autoint_smoke_on_gpu_matches_cpu(cuda):
    """AutoInt's SMOKE config in f32 with bags of 3 ids holding the padding
    sentinel: serve scores within 1e-4 of the largest, the loss and every
    gradient card vs CPU, and the retrieval's indices equal on candidates
    with duplicated rows (ties: the lower index first on both)."""
    from repro_torch.configs.registry import _load
    from repro_torch.data import RecsysBatcher
    from repro_torch.models import autoint as ai
    from repro_torch.models.params import materialize
    torch.backends.cuda.matmul.allow_tf32 = False
    c = dataclasses.replace(_load("autoint", smoke=True)[1], multi_hot=3)
    params = materialize(ai.autoint_param_defs(c),
                         torch.Generator().manual_seed(0), device="cpu")
    batch = next(RecsysBatcher(64, c.n_sparse, c.vocab_per_field,
                               c.multi_hot, seed=3, device="cpu"))
    batch["sparse_idx"].view(-1)[::5] = c.total_vocab
    build.reset_launches()
    sc = ai.make_autoint_serve_step(c)(params, batch)
    sg = ai.make_autoint_serve_step(c)(_to_dev(params, cuda),
                                       _to_dev(batch, cuda)).cpu()
    assert float((sg - sc).abs().max()) <= 1e-4 * float(sc.abs().max())
    _card_vs_cpu_grads(ai.autoint_loss, params, batch, c, cuda)
    base = torch.randn((512, c.d_retrieval),
                       generator=torch.Generator().manual_seed(4))
    cands = base[torch.randint(0, 512, (4096,),
                               generator=torch.Generator().manual_seed(5))]
    q = {"sparse_idx": batch["sparse_idx"][:2], "cand_vecs": cands}
    vc, ic = ai.make_retrieval_step(c, 100)(params, q)
    vg, ig = ai.make_retrieval_step(c, 100)(_to_dev(params, cuda),
                                            _to_dev(q, cuda))
    assert (vc[:, 1:] == vc[:, :-1]).any()          # ties occur
    assert torch.equal(ig.cpu(), ic)
    assert float((vg.cpu() - vc).abs().max()) <= 1e-4 * float(
        vc.abs().max())
    assert not any(build.LAUNCHES.values())


def test_launcher_gat_smoke_on_the_card(cuda, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch gat-cora --smoke`` on
    the card (no --device): 4 steps with a checkpoint every 2, then a
    resume to 6 within 1e-5 relative of an uninterrupted 6-step run (the
    scatters' atomics sum in another order from run to run)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as ttrain
    args = ["--arch", "gat-cora", "--smoke", "--log-every", "1"]
    ckpt = str(tmp_path / "ck")
    ttrain.main(args + ["--steps", "4", "--ckpt-dir", ckpt,
                        "--ckpt-every", "2"])
    assert latest_step(ckpt) == 4
    capsys.readouterr()
    resumed = ttrain.main(args + ["--steps", "6", "--ckpt-dir", ckpt])
    assert capsys.readouterr().out.splitlines()[0] == "resumed from step 4"
    whole = ttrain.main(args + ["--steps", "6"])
    assert len(resumed) == 2 and np.isfinite(whole).all()
    np.testing.assert_allclose(resumed, whole[4:], rtol=1e-5)
