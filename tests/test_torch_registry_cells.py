"""The port's cell registry and its dry run against the reference's
(``configs/registry.py``, ``launch/dryrun.py``).

- ``list_cells()`` is the reference's 44 cells in its order.
- Every cell equals the reference's ``build_cell(arch, shape, mesh11,
  ax11)`` in ``kind``, ``skip`` and its reason, ``model_flops`` exactly,
  and the bytes of its arguments (the sum over ``args_struct``; the SSSP
  cells at ``n_parts=1``, the 1x1 mesh's size). Only abstract structs are
  built on either side: nothing is compiled or allocated.
- A SMOKE cell of each family runs through the one-card dry run's code
  (``dryrun.run_one_card``) on ``meta`` with counted FLOPs; gemma-7b's
  ``train_4k`` at full width counts within (0.5, 1] of its
  ``model_flops``; an SSSP cell carries its note.
- ``build_cell`` on a host mesh gives this rank's blocks of the
  arguments and their ``in_shardings``, and wants a mesh and its axes
  together; ``python -m repro_torch.launch.dryrun --one-card`` writes one
  JSON a cell. The production-mesh dry run is held in
  ``tests/test_torch_production_mesh.py``.
"""
import json
import math

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax

from repro.configs import registry as jax_registry

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402

CELLS = jax_registry.list_cells()


def _jax_bytes(args) -> int:
    return sum(math.prod(s.shape) * np.dtype(s.dtype).itemsize
               for s in jax.tree_util.tree_leaves(args))


def test_list_cells_equals_reference():
    assert torch_registry.list_cells() == CELLS
    assert len(CELLS) == 44
    assert torch_registry.list_cells(include_sssp=False) == \
        jax_registry.list_cells(include_sssp=False)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_equals_reference(arch, shape, mesh11, ax11):
    cj = jax_registry.build_cell(arch, shape, mesh11, ax11)
    ct = torch_registry.build_cell(arch, shape, None, None, n_parts=1)
    assert (ct.arch, ct.shape, ct.kind) == (cj.arch, cj.shape, cj.kind)
    assert ct.skip == cj.skip
    assert ct.note == cj.note
    if cj.skip:
        assert ct.step_fn is None and ct.args_struct is None
        return
    assert ct.model_flops == cj.model_flops
    assert torch_registry.argument_bytes(ct.args_struct) == _jax_bytes(
        cj.args_struct)
    leaves = torch_registry.arg_leaves(ct.args_struct)
    assert leaves and all(t.is_meta for t in leaves)
    assert [tuple(t.shape) for t in leaves] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(cj.args_struct)]


@pytest.mark.parametrize("arch,shape", [
    ("olmoe-1b-7b", "decode_32k"), ("mace", "molecule"),
    ("autoint", "serve_p99")])
def test_smoke_cell_runs_on_meta(arch, shape, monkeypatch):
    """A SMOKE cell of each family (an LM with MoE, a GNN, AutoInt) runs
    through the dry run's code on ``meta``."""
    monkeypatch.setattr(dryrun, "build_cell", lambda a, s, mesh, ax: (
        torch_registry.build_cell(a, s, mesh, ax, smoke=True)))
    rec = dryrun.run_one_card(arch, shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["flops"] > 0 and rec["useful_ratio"] > 0
    assert rec["fits"] is True
    assert rec["roofline"]["dominant"] in ("compute", "memory")


def test_gemma_train_4k_counts_near_model_flops():
    """gemma-7b's train step at full width (B = 256, S = 4,096) on meta:
    the counted FLOPs within (0.5, 1] of ``6 N_active B S`` over them."""
    rec = dryrun.run_one_card("gemma-7b", "train_4k")
    assert rec["status"] == "ok", rec.get("error")
    assert 0.5 < rec["useful_ratio"] <= 1.0
    cell = torch_registry.build_cell("gemma-7b", "train_4k", None, None)
    assert rec["argument_bytes"] == torch_registry.argument_bytes(
        cell.args_struct)
    assert rec["fits"] == (rec["argument_bytes"] <= hlo_analysis.HBM_BYTES)


def test_sssp_cell_records_bytes_and_note(tmp_path):
    dryrun.main(["--arch", "sp-async", "--shape", "graph1", "--one-card",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "sp-async__graph1__h100.json").read_text())
    assert rec["status"] == "ok" and rec["flops"] is None
    assert rec["flops_note"] == dryrun.SSSP_NOTE
    cell = torch_registry.build_cell("sp-async", "graph1", None, None)
    assert rec["model_flops"] == cell.model_flops
    assert rec["argument_bytes"] == torch_registry.argument_bytes(
        cell.args_struct)
    assert cell.args_struct[0].loc_src.shape[0] == 256


def test_build_cell_wants_a_mesh_and_its_axes_together():
    """A mesh without its ``MeshAxes``, or axes without a mesh, is
    refused; both None is the one-card cell."""
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.launch.mesh import HostMesh
    mesh = HostMesh(shape=(2, 2), axis_names=("data", "model"),
                    backend="gloo", rank=0)
    with pytest.raises(ValueError, match="mesh=None and ax=None"):
        torch_registry.build_cell("gemma-7b", "train_4k", mesh, None)
    with pytest.raises(ValueError, match="mesh=None and ax=None"):
        torch_registry.build_cell("sp-async", "graph1", None,
                                  MeshAxes(data=("data",)))
    cell = torch_registry.build_cell("gemma-7b", "train_4k", None, None)
    assert cell.in_shardings is None and cell.donate_argnums == ()


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-7b", "decode_32k"), ("olmoe-1b-7b", "train_4k"),
    ("gat-cora", "full_graph_sm"), ("autoint", "retrieval_cand"),
    ("sp-async", "graph2")])
@pytest.mark.parametrize("rank", [0, 5])
def test_build_cell_on_a_host_mesh(arch, shape, rank):
    """On a (2, 3) host mesh (no process group needed to build a cell), a
    cell's arguments are this rank's blocks (``shard_ranges``) of the
    one-card cell's, its ``in_shardings`` one ``NamedSharding`` on the
    mesh an argument; an SSSP cell holds a one-shard view over the six
    processes, ``shard_id`` the rank."""
    from repro_torch.distributed.sharding import MeshAxes, shard_ranges
    from repro_torch.launch.mesh import HostMesh
    mesh = HostMesh(shape=(2, 3), axis_names=("data", "model"),
                    backend="gloo", rank=rank)
    ax = MeshAxes(data=("data",), data_shards=2)
    cell = torch_registry.build_cell(arch, shape, mesh, ax)
    whole = torch_registry.build_cell(arch, shape, None, None, n_parts=6)
    got = torch_registry.arg_leaves(cell.args_struct)
    want = torch_registry.arg_leaves(whole.args_struct)
    shardings = torch_registry.sharding_leaves(cell.in_shardings)
    assert len(got) == len(want) == len(shardings)
    for g, w, ns in zip(got, want, shardings):
        assert g.is_meta and g.dtype == w.dtype and ns.mesh is mesh
        assert tuple(g.shape) == tuple(
            hi - lo for lo, hi in shard_ranges(w.shape, ns.spec, mesh))
    assert cell.model_flops == whole.model_flops
    if arch == "sp-async":
        assert cell.args_struct[0].shard_id == rank
        assert cell.args_struct[0].n_parts == 6


def test_collective_bytes_is_an_explicit_omission():
    with pytest.raises(NotImplementedError, match="no HLO"):
        hlo_analysis.collective_bytes("", 1)
    t = hlo_analysis.roofline_terms(989.4e12, 3.35e12, 0.0, 1, 494.7e12)
    assert t["compute_s"] == t["memory_s"] == t["bound_s"] == 1.0
    assert t["useful_ratio"] == 0.5
