"""Dry run of every (arch x shape x mesh) cell on the ``meta`` device (the
reference's ``launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # every cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --one-card  # one H100

The production mesh (the reference's default): each cell is built for
the (16, 16) mesh of ("data", "model"), or with ``--multi-pod`` the (2,
16, 16) mesh of ("pod", "data", "model") (``launch/mesh.py:
make_production_mesh``), and its step runs once as rank 0 under
``use_mesh`` on ``meta`` tensors of rank 0's blocks of the arguments
(``configs/registry.py: build_cell``). With no process group, the dry run
starts PyTorch's stand-in for one, a ``fake`` group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``), on which every
collective returns at once; the steps see the ``"nccl"`` backend they
would see on the cards. Per cell the record holds the rank's counted
FLOPs (``FlopCounterMode``: matrix products, convolutions, attention;
not counted where ``flops_pass`` is False, the multi-pod pass, as in the
reference), the rank's argument and output bytes, the collectives the
step issued (``distributed/collectives.py: recording``, summed into wire
bytes by ``launch/hlo_analysis.py: collective_bytes``), the roofline
terms and ``fits`` (the arguments fit in the card's memory). A decode
cell also records its caches' bytes a rank, beside what a rank would hold
if it kept its query heads' KV heads over the whole sequence
(``cache_bytes_head_layout``). Records are tagged ``__singlepod`` /
``__multipod``.

An SSSP cell's round loop runs until the distances converge, which
``meta`` tensors cannot say; its record holds one round's collectives, as
the reference counts its loop body once: the round's exchange and
termination stages (``core/sssp.py``: the pipeline's stages over
``ShmapComm``) run on ``meta`` buffers of the round's shapes (the
payload [1, K, P, C], the frontier [1, K, block]); the local fixpoint,
the send pack and the merge issue no collective. Its counted FLOPs are
null.

``--one-card`` is the sweep on one H100 (``run_one_card``, tags
``__h100``): whole arguments, no collectives.

One JSON a record goes to ``--out``; an error is recorded for its cell
and the sweep goes on, and the script exits 1 at the end if any cell
failed.

The reference lowers and compiles each cell and reads XLA's memory and
cost analyses; the port has no compiler pass to ask, so its memory
figure is the arguments' bytes, and there is no scan/unrolled pair of
passes (the port's layer loop is Python's and issues every layer's
collectives).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs.registry import (ARCHS, LM_SHAPES, _load,
                                          arg_leaves, argument_bytes,
                                          build_cell, list_cells)
from repro_torch.launch.hlo_analysis import (HBM_BYTES, collective_bytes,
                                             roofline_terms)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_out")
SSSP_NOTE = ("the round loop runs until the distances converge, a "
             "data-dependent exit that meta tensors cannot take; counted "
             "FLOPs not measured")
SSSP_ROUND = ("one round's collectives: the exchange and termination "
              "stages over ShmapComm on meta buffers of the round's shapes "
              "(payload [1, K, P, C], frontier [1, K, block], K = 1); the "
              "local fixpoint, send pack and merge issue none")
NO_FLOPS_PASS = "not counted: flops_pass=False (the multi-pod pass)"


def _family(arch: str) -> str:
    return "sssp" if arch in ("sp-async", "sssp") else ARCHS[arch][0]


def measure(cell, flops_pass: bool = True) -> dict:
    """Run ``cell.step_fn`` on its meta arguments, under the FLOP counter
    when ``flops_pass``, recording its collectives: (counted FLOPs or
    None, bytes of the outputs, whether they stayed on meta, the record
    of collectives)."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.collectives import recording
    counter = FlopCounterMode(display=False) if flops_pass else None
    with recording() as trace, (counter or contextlib.nullcontext()):
        out = cell.step_fn(*cell.args_struct)
    return dict(flops=float(counter.get_total_flops()) if counter else None,
                output_bytes=argument_bytes(out),
                output_on_meta=all(t.is_meta for t in arg_leaves(out)),
                trace=trace)


def sssp_round(cell, mesh, ax, cfg=None) -> list:
    """The collectives one round of the cell's ``shmap`` solve issues on
    this rank (``SSSP_ROUND``), recorded."""
    import torch

    from repro_torch.core.sssp import (ShmapComm, SsspConfig,
                                       build_pipeline)
    from repro_torch.distributed.collectives import recording
    sh = cell.args_struct[0]
    cfg = cfg or SsspConfig(max_rounds=64)
    pipe = build_pipeline(sh, cfg)
    comm = ShmapComm(mesh.axis_group(tuple(ax.all)), "meta")
    K, P = 1, sh.n_parts
    width = sh.block if pipe.exchange.dense else sh.recv_idx.shape[-1]
    payload = torch.empty((1, K, P, width), device="meta")
    frontier = torch.empty((1, K, sh.block), dtype=torch.bool,
                           device="meta")
    sends = torch.empty((1, K), dtype=torch.int32, device="meta")

    if pipe.exchange.deferred:
        raise NotImplementedError(
            f"the dry run counts a synchronous exchange's round; "
            f"exchange={cfg.exchange!r} defers its deliveries")

    class Carry:             # what the termination stages read of a carry
        toka2 = streak = None
        msgs_recv = sends

    with recording() as trace:
        pipe.exchange.run(comm, payload)
        pipe.toka(cfg, comm, Carry, frontier, sends, sends, sh)
    return trace


def _cache_bytes(arch: str, shape: str, cell, mesh) -> dict:
    """A decode cell's caches a rank, and what a rank would hold in the
    layout that keeps its query heads' KV heads (``hk``, the most any
    ``model`` rank reads: ``models/transformer.py: _Mesh``) over the
    whole sequence."""
    cfg = _load(arch)[1]
    k = cell.args_struct[2][0]
    m = mesh.shape[mesh.axis_names.index("model")]
    g, Hl = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // m
    hk = max((j * Hl + Hl - 1) // g + 1 - (j * Hl) // g for j in range(m))
    S = LM_SHAPES[shape]["seq"]
    return dict(cache_bytes=argument_bytes(cell.args_struct[2]),
                cache_bytes_head_layout=2 * k.shape[0] * k.shape[1] * S * hk
                * k.shape[4] * k.element_size())


_STAND_IN: dict = {}


def production_mesh(multi_pod: bool):
    """The production mesh on the dry run's stand-in group: a ``fake``
    group of 256 or 512 ranks, this process rank 0, started (or
    restarted at the other size) here; a group the dry run did not start
    is refused, since a real one would move data."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    n = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "the production-mesh dry run starts its own stand-in "
                "process group; run it outside torchrun and any other "
                f"process group (this one runs {dist.get_backend()!r})")
        if dist.get_world_size() != n:
            dist.destroy_process_group()
            _STAND_IN.clear()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        _STAND_IN.clear()
    if multi_pod not in _STAND_IN:
        _STAND_IN[multi_pod] = make_production_mesh(multi_pod=multi_pod)
    return _STAND_IN[multi_pod]


def _recorded(tag: str, out_dir: str | None, force: bool, rec: dict,
              fill) -> dict:
    """``rec`` filled by ``fill(rec)`` (an error recorded in it, the sweep
    going on), its wall added; written to ``out_dir`` as ``tag``.json,
    and read back from there unless ``force``, when ``out_dir`` is
    given."""
    path = out_dir and os.path.join(out_dir, tag + ".json")
    if path and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    t0 = time.time()
    try:
        fill(rec)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[{tag}] ERROR {type(e).__name__}: {e}")
    rec["wall_s"] = round(time.time() - t0, 2)
    if path:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             force: bool = False, flops_pass: bool = True) -> dict:
    """The production-mesh record of one cell (module docstring), written
    to ``out_dir`` and read back from there unless ``force``."""
    from repro_torch.distributed.sharding import mesh_axes
    from repro_torch.launch.mesh import use_mesh
    tag = f"{arch}__{shape}__{'multipod' if multi_pod else 'singlepod'}"

    def fill(rec):
        mesh = production_mesh(multi_pod)
        ax = mesh_axes(multi_pod)
        rec["n_devices"] = mesh.size
        cell = build_cell(arch, shape, mesh, ax)
        if cell.skip:
            rec.update(status="skipped", reason=cell.skip)
            return
        args_b = argument_bytes(cell.args_struct)
        rec.update(kind=cell.kind, note=cell.note,
                   model_flops=cell.model_flops, argument_bytes=args_b,
                   fits=args_b <= HBM_BYTES)
        with use_mesh(mesh):
            if _family(arch) == "sssp":
                trace = sssp_round(cell, mesh, ax)
                rec.update(flops=None, flops_note=SSSP_NOTE,
                           output_bytes=None, collectives_note=SSSP_ROUND)
            else:
                m = measure(cell, flops_pass)
                trace = m.pop("trace")
                if not m.pop("output_on_meta"):
                    raise RuntimeError("the step left the meta device")
                rec.update(m)
                if not flops_pass:
                    rec["flops_note"] = NO_FLOPS_PASS
        rec["collectives"] = collective_bytes(trace, mesh.size)
        if cell.kind == "decode":
            rec.update(_cache_bytes(arch, shape, cell, mesh))
        rec["roofline"] = t = roofline_terms(
            rec["flops"] or 0.0, args_b + (rec["output_bytes"] or 0),
            rec["collectives"]["total"], mesh.size, cell.model_flops)
        rec["useful_ratio"] = t["useful_ratio"] if rec["flops"] else None
        print(f"[{tag}] args/rank={_gb(args_b)} flops={_e(rec['flops'])} "
              f"coll={rec['collectives']['total']:.3e} "
              f"dominant={t['dominant']} useful={_f(rec['useful_ratio'])}"
              f" fits={rec['fits']}"
              + (f" caches/rank={rec['cache_bytes']} B (head layout "
                 f"{rec['cache_bytes_head_layout']} B)"
                 if "cache_bytes" in rec else ""))

    return _recorded(tag, out_dir, force, dict(
        arch=arch, shape=shape, multi_pod=multi_pod, status="ok"), fill)


def run_one_card(arch: str, shape: str, out_dir: str | None = None,
                 force: bool = False) -> dict:
    """The record of one cell on one H100 (``--one-card``): whole
    arguments, no collectives; written to ``out_dir`` (and read back from
    there unless ``force``) when it is given."""
    tag = f"{arch}__{shape}__h100"

    def fill(rec):
        cell = build_cell(arch, shape, None, None)
        if cell.skip:
            rec.update(status="skipped", reason=cell.skip)
            return
        args_b = argument_bytes(cell.args_struct)
        rec.update(kind=cell.kind, note=cell.note,
                   model_flops=cell.model_flops, argument_bytes=args_b,
                   fits=args_b <= HBM_BYTES)
        if _family(arch) == "sssp":
            rec.update(flops=None, flops_note=SSSP_NOTE, useful_ratio=None,
                       roofline=None)
        else:
            m = measure(cell)
            m.pop("trace")
            if not m.pop("output_on_meta"):
                raise RuntimeError("the step left the meta device")
            rec.update(m)
            rec["roofline"] = roofline_terms(
                m["flops"], args_b + m["output_bytes"], 0.0, 1,
                cell.model_flops)
            rec["useful_ratio"] = rec["roofline"]["useful_ratio"]
        print(f"[{tag}] args={_gb(args_b)} flops={_e(rec['flops'])} "
              f"model_flops={cell.model_flops:.3e} "
              f"useful={_f(rec['useful_ratio'])} fits={rec['fits']}")

    return _recorded(tag, out_dir, force, dict(
        arch=arch, shape=shape, n_devices=1, status="ok"), fill)


def _gb(b):
    return f"{b / 2**30:.2f}GiB"


def _e(x):
    return "null" if x is None else f"{x:.3e}"


def _f(x):
    return "null" if x is None else f"{x:.3f}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--one-card", action="store_true",
                   help="the sweep on one H100 (records __h100)")
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        p.error("give --arch and --shape, or --all")
    if args.one_card and (args.multi_pod or args.both_meshes):
        p.error("--one-card takes no production mesh")

    cells = list_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts = {"ok": 0, "skipped": 0, "error": 0}
    try:
        for arch, shape in cells:
            if args.one_card:
                rec = run_one_card(arch, shape, args.out, force=args.force)
                counts[rec["status"]] += 1
                continue
            for mp in meshes:
                # FLOP totals come from the single-pod pass, as in the
                # reference
                rec = run_cell(arch, shape, mp, args.out, force=args.force,
                               flops_pass=not mp)
                counts[rec["status"]] += 1
    finally:
        if _STAND_IN and dist.is_initialized():
            dist.destroy_process_group()
            _STAND_IN.clear()
    print(f"dry-run done: ok={counts['ok']} skipped={counts['skipped']} "
          f"errors={counts['error']}")
    if counts["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
