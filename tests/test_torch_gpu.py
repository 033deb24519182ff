"""The CUDA kernels of the PyTorch port on the card, against their plain
PyTorch versions (bit-equal), and the engine's card run against its CPU
run. Every test is marked ``gpu`` and skips without a CUDA device.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed; the repository's conftest imports JAX, so run it
there without it:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.common import pad_last  # noqa: E402
from repro_torch.kernels.merge import (build_msg_tiled_layout,  # noqa: E402
                                       merge_scatter_tiled,
                                       merge_scatter_tiled_plain)
from repro_torch.kernels.relax import (  # noqa: E402
    fixpoint_operands, relax_dst_tiled_fixpoint_batch,
    relax_dst_tiled_fixpoint_batch_plain)
from repro_torch.kernels.send import (send_operands,  # noqa: E402
                                      send_pack_tiled, send_pack_tiled_plain)

pytestmark = pytest.mark.gpu
ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas")


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
    assert min(build.LAUNCHES.values()) > 0
    assert on_gpu.status == on_cpu.status == "converged"
    np.testing.assert_array_equal(on_gpu.dist, on_cpu.dist)
    for f in ("rounds", "relaxations", "msgs_sent", "msgs_recv",
              "pruned_edges", "q_rounds", "q_relaxations"):
        np.testing.assert_array_equal(np.asarray(getattr(on_gpu.stats, f)),
                                      np.asarray(getattr(on_cpu.stats, f)))
