"""Dry run of every (arch x shape) cell on the ``meta`` device (the
reference's ``launch/dryrun.py``, for one card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all       # every cell

Per cell: the port's step runs once on ``meta`` tensors of the cell's
argument shapes (``configs/registry.py: build_cell``) under
``torch.utils.flop_counter.FlopCounterMode``, so shapes and types flow
through every op and nothing is allocated. The record holds the
arguments' bytes, the counted FLOPs (matrix products, convolutions and
attention: what the counter counts), the reference's ``model_flops``,
their ratio ``useful_ratio``, ``fits`` (the arguments fit in the card's
memory) and the roofline terms on the card's constants
(``launch/hlo_analysis.py``), the memory term from the bytes the step
must move at least (its arguments read once and its outputs written
once). One JSON a cell goes to ``--out``; an error is recorded for its
cell and the sweep goes on, and the script exits 1 at the end if any cell
failed.

The reference lowers and compiles each cell for a 16 x 16 TPU mesh and
reads XLA's memory and cost analyses; the port has no compiler pass to
ask, so its memory figure is the arguments' bytes, and there is no
scan/unrolled pair of passes (the port's layer loop is Python's). The
SSSP cells' round loop runs until the data converge, which ``meta``
tensors cannot say: those cells record their bytes and ``model_flops``
with the counted FLOPs null and a note.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs.registry import (ARCHS, arg_leaves, argument_bytes,
                                          build_cell, list_cells)
from repro_torch.launch.hlo_analysis import HBM_BYTES, roofline_terms

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "dryrun_out")
SSSP_NOTE = ("the round loop runs until the distances converge, a "
             "data-dependent exit that meta tensors cannot take; counted "
             "FLOPs not measured")


def measure(cell) -> dict:
    """Run ``cell.step_fn`` on its meta arguments under the FLOP counter:
    (counted FLOPs, bytes of the outputs)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = cell.step_fn(*cell.args_struct)
    return dict(flops=float(counter.get_total_flops()),
                output_bytes=argument_bytes(out),
                output_on_meta=all(t.is_meta for t in arg_leaves(out)))


def run_cell(arch: str, shape: str, out_dir: str | None = None,
             force: bool = False) -> dict:
    """The dry run's record of one cell, written to ``out_dir`` (and read
    back from there unless ``force``) when ``out_dir`` is given."""
    tag = f"{arch}__{shape}__h100"
    path = out_dir and os.path.join(out_dir, tag + ".json")
    if path and os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    family = "sssp" if arch in ("sp-async", "sssp") else ARCHS[arch][0]
    rec = dict(arch=arch, shape=shape, n_devices=1, status="ok")
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, None, None)
        if cell.skip:
            rec.update(status="skipped", reason=cell.skip)
        else:
            args_b = argument_bytes(cell.args_struct)
            rec.update(kind=cell.kind, note=cell.note,
                       model_flops=cell.model_flops, argument_bytes=args_b,
                       fits=args_b <= HBM_BYTES)
            if family == "sssp":
                rec.update(flops=None, flops_note=SSSP_NOTE,
                           useful_ratio=None, roofline=None)
            else:
                m = measure(cell)
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
    p.add_argument("--force", action="store_true")
    p.add_argument("--out", default=os.path.abspath(OUT_DIR))
    args = p.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        p.error("give --arch and --shape, or --all")

    cells = list_cells() if args.all else [(args.arch, args.shape)]
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for arch, shape in cells:
        counts[run_cell(arch, shape, args.out, force=args.force)["status"]] += 1
    print(f"dry-run done: ok={counts['ok']} skipped={counts['skipped']} "
          f"errors={counts['error']}")
    if counts["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
