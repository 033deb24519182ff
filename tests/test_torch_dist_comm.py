"""The port's multi-process layer on the CPU: the collectives on a 2x2
mesh of gloo ranks (ranks row-major over the axes, the rings equal to
``np.roll`` in both directions, as tests/test_multidevice.py holds the
reference's; all-to-all, min, max, sum, or, and, gather), ``ShmapComm``
against ``SimComm`` on the same stacked operands, the errors (NCCL with
more ranks than cards, ``--parts`` against the world size, ``shmap``
without a mesh), and the runner under ``torchrun`` on 4 ranks against its
``--backend sim`` run. Tolerance zero.
"""
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import _torch_dist_ref as ref  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core.toka import Token  # noqa: E402
from repro_torch.launch import sssp_run as trun  # noqa: E402
from repro_torch.launch.mesh import HostMesh, make_host_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 2)
AXES = ("data", "model")
SEED = 11


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return ref.run_ranks(ref.rank_collectives,
                         tmp_path_factory.mktemp("dist_comm"), SEED,
                         world=4, shape=SHAPE, axes=AXES)


def _members(r, axes):
    """The ranks spanning ``axes`` with rank r, in flat-rank order."""
    grid = np.arange(4).reshape(SHAPE)
    idx = list(np.unravel_index(r, SHAPE))
    for a in axes:
        idx[AXES.index(a)] = slice(None)
    return grid[tuple(idx)].reshape(-1)


def _x(r):
    return np.array([r, 10 * r], np.int32)


@pytest.mark.parametrize("axes", [AXES, ("data",), ("model",)],
                         ids=["data-model", "data", "model"])
def test_flat_rank_and_rings(ranks, axes):
    for r, res in enumerate(ranks):
        got = res[axes]
        m = list(_members(r, axes))
        i = m.index(r)
        assert got["rank"] == i and got["size"] == len(m)
        # the value rank r holds after a hop forward is its predecessor's:
        # np.roll(values, 1) over the ring, and np.roll(values, -1) back
        vals = np.stack([_x(q) for q in m])
        np.testing.assert_array_equal(got["fwd"], np.roll(vals, 1, 0)[i])
        np.testing.assert_array_equal(got["bwd"], np.roll(vals, -1, 0)[i])
        np.testing.assert_array_equal(got["unchanged"], _x(r))
    if axes == AXES:
        fwd = np.array([res[axes]["fwd"][0] for res in ranks])
        np.testing.assert_array_equal(fwd, np.roll(np.arange(4), 1))


@pytest.mark.parametrize("axes", [AXES, ("data",), ("model",)],
                         ids=["data-model", "data", "model"])
def test_all_to_all_reductions_and_gather(ranks, axes):
    for r, res in enumerate(ranks):
        got = res[axes]
        m = _members(r, axes)
        i = list(m).index(r)
        vals = np.stack([_x(q) for q in m])
        # row p came from member p's row for this rank
        np.testing.assert_array_equal(
            got["a2a"][:, 0], np.array([i + 100 * q for q in m], np.float32))
        np.testing.assert_array_equal(got["min"], (vals - 5).min(0))
        np.testing.assert_array_equal(got["max"], vals.max(0))
        np.testing.assert_array_equal(got["sum"], vals.sum(0))
        np.testing.assert_array_equal(got["amin"], (-vals).min(0))
        np.testing.assert_array_equal(got["any"], [1 in m, False])
        np.testing.assert_array_equal(got["all"], [1 not in m, True])
        np.testing.assert_array_equal(got["gather"], vals)


def test_shmap_comm_matches_sim_comm(ranks):
    """Each rank's ``ShmapComm`` result is its row of ``SimComm``'s on
    the stacked operands: the three exchanges, the token ring (every
    field, dtypes kept), the routing table, the transit hop, the flag
    reductions, the total and the gather."""
    P = 4
    st = ref.stacked_operands(SEED, P)
    sim = tc.SimComm(P)
    inc, fwd, bwd = sim.async_hop(st["fwd"].clone(), st["bwd"].clone())
    tok = sim.ring(Token(*(st[f"tok_{f}"] for f in Token._fields)))
    want = dict(bucket=sim.exchange_bucket(st["bucket"]),
                pmin=sim.exchange_pmin(st["dense"]),
                a2a_dense=sim.exchange_a2a_dense(st["dense"]),
                dest_dirs=sim.dest_dirs(), all_any=sim.all_any(st["flag"]),
                all_all=sim.all_all(st["flag"]), total=sim.total(st["count"]))
    for r, res in enumerate(ranks):
        got = res["comm"]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v[r:r + 1].numpy(),
                                          err_msg=k)
        for g, w in zip(got["ring"], tok, strict=True):
            assert g.dtype == w.numpy().dtype
            np.testing.assert_array_equal(g, w[r:r + 1].numpy())
        for g, w in zip(got["hop"], (inc, fwd, bwd), strict=True):
            np.testing.assert_array_equal(g, w[r:r + 1].numpy())
        assert bool(got["any_global"]) == bool(st["flag"][:, 0].any())
        np.testing.assert_array_equal(got["gather"], st["dense"].numpy())


# ------------------------------------------------------------ errors ----

def test_nccl_with_more_ranks_than_cards_names_gloo(tmp_path):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="backend='gloo'"):
        make_host_mesh((n + 1,), ("data",), backend="nccl",
                       init_method=f"file://{tmp_path}/store", rank=0,
                       world_size=n + 1)
    with pytest.raises(ValueError, match="unknown communication backend"):
        make_host_mesh((1,), ("data",), backend="mpi")
    with pytest.raises(TypeError):
        make_host_mesh((1,), ("data",))          # the backend is the caller's


def test_shmap_engine_errors():
    st = ref.shards("faults")
    with pytest.raises(ValueError, match="requires mesh and axis_names"):
        tc.SsspEngine.build(st, tc.SsspConfig(), "shmap", device="cpu")
    mesh = HostMesh(shape=(2,), axis_names=("data",), backend="gloo", rank=0)
    with pytest.raises(ValueError, match="span 2 processes"):
        tc.SsspEngine.build(st, tc.SsspConfig(), "shmap", mesh, ("data",),
                            device="cpu")
    with pytest.raises(ValueError, match="one-shard view"):
        tc.SsspEngine.build(st.shard(1), tc.SsspConfig(), device="cpu")
    with pytest.raises(ValueError, match="axes of the mesh"):
        mesh.axis_group(("model",))
    view = st.shard(2)
    assert (view.n_rows, view.n_parts, view.row0) == (1, 4, 2)
    assert view.inter_edges_total == st.inter_edges_total
    assert view.to("cpu").inter_edges_total == st.inter_edges_total
    assert int(view.inter_edges.sum()) < st.inter_edges_total


TINY = ("--graph", "random", "--scale", "7", "--edge-factor", "4",
        "--parts", "4", "--no-prune")
RUN = (*TINY, "--sources", "0,5,9", "--exchange", "async", "--toka", "toka3",
       "--fault-drop", "0.2", "--resend-period", "4", "--validate",
       "--device", "cpu")
_TIMES = re.compile(r"\d+\.\d+m?s\b|(MTEPS|queries/s)=\S+")


def _lines(text):
    return [_TIMES.sub("T", line) for line in text.splitlines()]


def test_runner_parts_must_equal_world_size(monkeypatch, capsys):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for extra, msg in ((("--dist-backend", "gloo"),
                        "--parts 4 must equal the world size 1"),
                       ((), "requires --dist-backend")):
        monkeypatch.setattr(sys, "argv", ["sssp_run", *RUN, "--backend",
                                          "shmap", *extra])
        with pytest.raises(SystemExit) as e:
            trun.main()
        out, err = capsys.readouterr()
        assert e.value.code == 2 and msg in err and not out


def test_runner_shmap_on_4_ranks_prints_the_sim_lines(monkeypatch, capsys):
    """``torchrun --nproc-per-node 4`` of the runner with ``--backend shmap
    --dist-backend gloo`` prints, from rank 0 alone, the lines of the
    ``--backend sim`` run on the same flags, times masked, and
    validates."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--master-addr", "localhost", "--master-port", str(port),
         "-m", "repro_torch.launch.sssp_run", *RUN, "--backend", "shmap",
         "--dist-backend", "gloo"],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    monkeypatch.setattr(sys, "argv", ["sssp_run", *RUN])
    trun.main()
    want = _lines(capsys.readouterr().out)
    assert _lines(proc.stdout) == want
    assert "validation vs Dijkstra (3 queries): OK" in want[-1]
