"""The registry's cells on the reference's production meshes and the
dry run on them (``configs/registry.py: build_cell(arch, shape, mesh,
ax)``, ``launch/mesh.py: make_production_mesh``, ``launch/dryrun.py:
run_cell``, ``launch/hlo_analysis.py: collective_bytes``), against the
JAX reference.

- Every one of the 44 cells' ``in_shardings`` has the reference's specs,
  leaf for leaf, on the single-pod (16, 16) and multi-pod (2, 16, 16)
  meshes; the reference's side is built on 1 x 1 and 1 x 1 x 1 host
  meshes (its specs name the axes, not their sizes).
- A rank's arguments are its ceil blocks of those specs (``shard_ranges``
  of the one-card cell's whole shapes; an SSSP cell's at ``n_parts`` the
  mesh's size), for the first and the last rank; where the mesh's sizes
  divide a dimension, JAX's ``NamedSharding.shard_shape`` on an
  ``AbstractMesh`` of the production shape gives the same.
- ``collective_bytes`` sums a hand-made record by the reference's wire
  formulas, and equals the reference's HLO parser on HLO lines of the
  same collectives (each over the whole mesh); a reduce-scatter counts
  its input's bytes, as the reference's formula says, where its parser
  reads the result's (1/P of them).
- In one subprocess on the dry run's stand-in group (``fake``, 256 or 512
  ranks): the record of ``collectives.recording`` for every hooked
  helper; ``make_production_mesh`` refusing a group of the other size;
  ``make_host_mesh`` refusing the ``fake`` backend; and ``run_cell`` on
  both meshes for a SMOKE cell of each family (qwen3-moe SMOKE widened
  to 16 query heads and 16 experts, so that the model axis of 16 splits
  them, with the full config's attention chunk of 1,024, at its three LM
  shapes; MACE on molecules; AutoInt's serving;
  SSSP graph1), each ``ok`` with non-zero collective bytes, and
  mistral-large-123b's ``decode_32k`` at full width, whose single-pod
  rank holds 5,905,580,032 B of caches (11,811,160,064 B in the layout
  that kept a rank's query heads' KV heads over the whole sequence).
"""
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax

from repro import compat
from repro.configs import registry as jax_registry
from repro.distributed import sharding as jsh
from repro.launch import hlo_analysis as jhlo

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.distributed import collectives as tcoll  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import hlo_analysis as thlo  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION, HostMesh  # noqa: E402

CELLS = jax_registry.list_cells()
SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def jax_meshes():
    return {False: compat.make_mesh((1, 1), ("data", "model")),
            True: compat.make_mesh((1, 1, 1), ("pod", "data", "model"))}


def _port_mesh(multi_pod: bool, rank: int = 0) -> HostMesh:
    shape, axes = PRODUCTION[multi_pod]
    return HostMesh(shape=shape, axis_names=axes, backend="nccl", rank=rank)


def _jax_specs(in_shardings):
    return [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        in_shardings, is_leaf=lambda x: isinstance(
            x, jax.sharding.NamedSharding))]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_shardings_and_blocks(jax_meshes, arch, shape, multi_pod):
    """The cell's spec tree equals the reference's leaf for leaf, and the
    first and the last rank's arguments are their blocks of it."""
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
    cj = jax_registry.build_cell(arch, shape, jax_meshes[multi_pod],
                                 jsh.mesh_axes(multi_pod))
    mesh = _port_mesh(multi_pod)
    ax = tsh.mesh_axes(multi_pod)
    ct = torch_registry.build_cell(arch, shape, mesh, ax)
    assert ct.skip == cj.skip and ct.kind == cj.kind
    assert ct.donate_argnums == cj.donate_argnums == ()
    if cj.skip:
        assert ct.in_shardings is None and cj.in_shardings is None
        return
    shardings = torch_registry.sharding_leaves(ct.in_shardings)
    assert [tuple(s.spec) for s in shardings] == _jax_specs(cj.in_shardings)
    assert all(s.mesh is mesh for s in shardings)
    whole = torch_registry.arg_leaves(torch_registry.build_cell(
        arch, shape, None, None, n_parts=mesh.size).args_struct)
    amesh = AbstractMesh(mesh.shape, mesh.axis_names)
    for rank in (0, mesh.size - 1):
        got = torch_registry.arg_leaves(torch_registry.build_cell(
            arch, shape, _port_mesh(multi_pod, rank), ax).args_struct)
        assert len(got) == len(whole) == len(shardings)
        for g, w, s in zip(got, whole, shardings):
            want = tuple(hi - lo for lo, hi in tsh.shard_ranges(
                w.shape, s.spec, _port_mesh(multi_pod, rank)))
            assert tuple(g.shape) == want and g.dtype == w.dtype
            assert g.is_meta
            js = NamedSharding(amesh, PartitionSpec(*s.spec))
            parts = [math.prod(mesh.shape[mesh.axis_names.index(a)]
                               for a in tsh.entry_axes(e, mesh))
                     for e in tuple(s.spec)]
            if all(d % p == 0 for d, p in zip(w.shape, parts)):
                assert tuple(g.shape) == tuple(js.shard_shape(w.shape))


def _hlo(lines):
    return "\n".join(["HloModule m", "", "ENTRY %main () -> f32[] {",
                      *lines, "}"])


def test_collective_bytes_by_the_reference_formulas():
    """A hand-made record over groups of 16 and of the whole mesh: each
    kind's wire bytes and counts by the formulas; over the whole mesh
    the same as the reference's HLO parser on HLO lines of the same
    collectives, but the reduce-scatter, which the formula counts by its
    input (the parser by its result, 1/P of it); ``loop_scale`` scales
    every entry; HLO text raises."""
    C = tcoll.Collective
    trace = [C("all-reduce", 4096, 16), C("all-gather", 1 << 20, 16),
             C("reduce-scatter", 1 << 16, 16), C("all-to-all", 8000, 16),
             C("collective-permute", 512, 16), C("all-reduce", 1 << 12, 256)]
    got = thlo.collective_bytes(trace, 256)
    f16, f256 = 15 / 16, 255 / 256
    want = {"all-reduce": int(2 * 4096 * f16) + int(2 * 4096 * f256),
            "all-gather": int((1 << 20) * f16),
            "reduce-scatter": int((1 << 16) * f16),
            "all-to-all": int(8000 * f16), "collective-permute": 512}
    for k, v in want.items():
        assert got[k] == v, k
    assert got["total"] == sum(want.values())
    assert got["counts"] == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 1,
                             "collective-permute": 1}
    assert thlo.collective_bytes(trace, 256, loop_scale=3)[
        "collective-permute"] == 3 * 512
    # over the whole mesh of P = 16: the reference's parser on HLO lines
    P = 16
    whole = [C("all-reduce", 4096, P), C("all-gather", 1 << 20, P),
             C("all-to-all", 8000, P), C("collective-permute", 512, P),
             C("reduce-scatter", 1 << 16, P)]
    hlo = _hlo([
        "  %a = f32[1024]{0} all-reduce(f32[1024]{0} %p), to_apply=%add",
        "  %b = f32[262144]{0} all-gather(f32[16384]{0} %p), dimensions={0}",
        "  %c = s32[2000]{0} all-to-all(s32[2000]{0} %p), dimensions={0}",
        "  %d = bf16[256]{0} collective-permute(bf16[256]{0} %p)",
        "  %e = f32[1024]{0} reduce-scatter(f32[16384]{0} %p), "
        "dimensions={0}"])
    ref = jhlo.collective_bytes(hlo, P)
    port = thlo.collective_bytes(whole, P)
    assert ref["counts"] == port["counts"]
    for k in ("all-reduce", "all-gather", "all-to-all",
              "collective-permute"):
        assert port[k] == ref[k], k
    assert port["reduce-scatter"] == P * ref["reduce-scatter"]
    with pytest.raises(NotImplementedError, match="no HLO"):
        thlo.collective_bytes(hlo, P)


def test_roofline_terms_divide_collectives_by_the_link():
    """Up to 8 cards the collective bytes go over NVLink 4, past that
    over a card's 400 Gb/s NIC."""
    assert thlo.roofline_terms(0.0, 0.0, 450e9, 4)["collective_s"] == 1.0
    assert thlo.roofline_terms(0.0, 0.0, 50e9, 256)["collective_s"] == 1.0
    t = thlo.roofline_terms(989.4e12, 0.0, 100e9, 256, 1.0)
    assert t["dominant"] == "collective" and t["bound_s"] == 2.0


# ------------------------------------------------ the stand-in subprocess

STAND_IN = textwrap.dedent('''
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import registry
    from repro_torch.distributed import collectives as coll
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    torch.set_num_threads(1)
    out = {}
    try:
        make_host_mesh((16, 16), ("data", "model"), backend="fake")
    except ValueError as e:
        out["host_fake"] = str(e)
    try:
        make_production_mesh()
    except RuntimeError as e:
        out["no_group"] = str(e)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        make_production_mesh(multi_pod=False)
    except ValueError as e:
        out["wrong_size"] = str(e)
    mesh = make_production_mesh(multi_pod=True)
    ag = mesh.axis_group(("model",))
    out["model_group"] = [ag.size, ag.backend, dist.get_backend(ag.group)]
    x = torch.empty((4, 8), device="meta")
    with coll.recording() as rec:
        coll.psum_named(x, ag)
        coll.all_gather_tiled(x, ag)
        coll.reduce_scatter_dim(torch.empty((32, 8), device="meta"), ag, 0)
        coll.all_to_all_tiled(torch.empty((16, 8), device="meta"), ag)
        coll.ring_permute(x, ag)
        coll.all_to_all_uneven(x.reshape(-1), ag, [2] * 16, [2] * 16)
    out["record"] = [list(c) for c in rec]
    with coll.recording() as rec2:
        with coll.recording() as rec3:
            coll.psum_named(x, ag)
        coll.psum_named(x, ag)
    out["nested"] = [len(rec2), len(rec3)]
    with torch.no_grad():
        coll.psum_named(x, ag)      # off again: nothing recorded anywhere
    out["after"] = [len(rec), len(rec2), len(rec3)]
    dist.destroy_process_group()
    dryrun._STAND_IN.clear()

    real_load = registry._load

    def smoke(arch, smoke=False):
        family, cfg = real_load(arch, smoke=arch != "mistral-large-123b")
        if arch == "qwen3-moe-235b-a22b":
            cfg = dataclasses.replace(
                cfg, n_heads=16, attn_chunk=1024,
                moe=dataclasses.replace(cfg.moe, n_experts=16))
        return family, cfg

    registry._load = smoke
    dryrun._load = smoke
    cells = [("qwen3-moe-235b-a22b", s)
             for s in ("train_4k", "prefill_32k", "decode_32k")]
    cells += [("mace", "molecule"), ("autoint", "serve_p99"),
              ("sp-async", "graph1")]
    recs = []
    for arch, shape in cells:
        for mp in (False, True):
            recs.append(dryrun.run_cell(arch, shape, mp, None,
                                        flops_pass=not mp))
    recs.append(dryrun.run_cell("mistral-large-123b", "decode_32k", False,
                                None, flops_pass=False))
    for r in recs:
        r.pop("traceback", None)
    out["records"] = recs
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
''')


@pytest.fixture(scope="module")
def stand_in():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", STAND_IN], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_production_mesh_joins_only_its_size(stand_in):
    """``make_production_mesh`` with no group outside torchrun names what
    is missing; on a group of 512 ranks it refuses the single-pod mesh,
    naming both sizes; on the stand-in its subgroups run ``fake`` and the
    steps see ``nccl``; ``make_host_mesh`` never takes ``fake``."""
    assert "unknown communication backend 'fake'" in stand_in["host_fake"]
    assert "no process group to join" in stand_in["no_group"]
    assert "256" in stand_in["wrong_size"] and "512" in stand_in[
        "wrong_size"]
    assert stand_in["model_group"] == [16, "nccl", "fake"]


def test_recording_holds_every_hooked_collective(stand_in):
    """Each hooked helper records its kind, the bytes the formula takes
    and its group's size; ``ring_permute`` is a collective-permute; a
    record nests and is off outside its block."""
    f32 = 4
    assert stand_in["record"] == [
        ["all-reduce", 32 * f32, 16], ["all-gather", 16 * 32 * f32, 16],
        ["reduce-scatter", 32 * 8 * f32, 16],
        ["all-to-all", 16 * 8 * f32, 16],
        ["collective-permute", 32 * f32, 16],
        ["all-to-all", 32 * f32, 16]]
    assert stand_in["nested"] == [1, 1]
    assert stand_in["after"] == [6, 1, 1]


def test_run_cell_on_both_production_meshes(stand_in):
    """A SMOKE cell of each family ends ``ok`` on both meshes with
    non-zero collective bytes, its tag's mesh and FLOPs counted in the
    single-pod pass only; mistral-large-123b ``decode_32k``'s single-pod
    rank holds the reference layout's caches."""
    recs = stand_in["records"]
    assert len(recs) == 13
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        assert r["n_devices"] == (512 if r["multi_pod"] else 256)
        assert r["collectives"]["total"] > 0, (r["arch"], r["shape"])
        assert r["fits"] is True
        if r["arch"] == "sp-async":
            assert r["flops"] is None and r["collectives_note"]
            assert r["collectives"]["counts"]["all-to-all"] == 1
        elif r["multi_pod"] or r["arch"] == "mistral-large-123b":
            assert r["flops"] is None
        else:
            assert r["flops"] > 0
    mistral = recs[-1]
    assert mistral["cache_bytes"] == 5_905_580_032
    assert mistral["cache_bytes_head_layout"] == 11_811_160_064
    qwen_decode = [r for r in recs if r["shape"] == "decode_32k"
                   and r["arch"].startswith("qwen3")]
    for r in qwen_decode:
        assert r["collectives"]["counts"]["reduce-scatter"] > 0
        assert r["cache_bytes"] < r["cache_bytes_head_layout"]
    assert np.isfinite(mistral["roofline"]["bound_s"])
