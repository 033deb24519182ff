#!/usr/bin/env python3
"""Drive the PyTorch port of SP-Async on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
Phases, each of which exits non-zero on a mismatch:

  build   compile the three CUDA kernels (relax, send, merge) from
          src/repro_torch/kernels/csrc, one nvcc each, in parallel;
  kernel  hold each kernel against its plain PyTorch version on the card,
          bit-equal, on the real layouts of the scale-1e6 graph at
          mid-solve state, and time kernel, plain version and bound;
  parity  solve rmat scale 11 (Trishla on, P=8, K=4) with the all-kernel
          config on the card and on the CPU: distances and every counter
          equal;
  scale   the main path: SsspEngine.solve on preset "scale-1e6" (65,536
          vertices, 955,492 directed edges; P=8) with K=16 and K=1, every
          query certified converged, 4 sources checked against Dijkstra,
          every kernel launched.

The line before last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Build logs go to chiprun_out/.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
ALL_KERNELS = dict(local_solver="pallas", send_backend="pallas",
                   merge_backend="pallas", round="staged", exchange="bucket",
                   toka="toka0")
RTOL, ATOL = 1e-5, 1e-4        # the reference CLI's Dijkstra tolerance
COUNTERS = ("rounds", "relaxations", "msgs_sent", "msgs_recv",
            "pruned_edges", "q_rounds", "q_relaxations", "q_converged")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def timed(torch, fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int):
    """Least time (ms) for the work: bytes over the memory rate vs float32
    operations over the card's peak; returns (ms, what bounds it)."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def compare(torch, name, got, want):
    """Max abs difference between the kernel's and the plain version's
    outputs (equal +inf entries count 0); fails unless they are bit-equal."""
    err = 0.0
    for g, w in zip(got, want):
        diff = torch.where(g == w, 0.0, (g.double() - w.double()).abs())
        err = max(err, float(diff.max()))
        if not torch.equal(g, w):
            fail(f"{name}: kernel differs from its plain version "
                 f"(max abs err {err})")
    return err


def profile_solve(torch, eng, sources, trace_path: Path):
    """Where the time of one K=16 solve goes: device time by kernel name and
    the device's idle share of the solve window, read from a torch.profiler
    trace (kernel events inside the ``solve`` annotation)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("solve"):
            eng.solve(sources)
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    win = next(e for e in events if e.get("name") == "solve"
               and e.get("cat") == "user_annotation")
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and t0 <= e["ts"] < t1)
    by_name, busy, end = {}, 0.0, t0
    for s, f, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (f - s)
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    say(f"profile: K=16 solve window {win['dur'] / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / win['dur']:.3f}, "
        f"{len(kernels)} kernels")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        say(f"  {us / 1e3:9.3f} ms  {name[:90]}")


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found: run from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.core import SsspConfig, SsspEngine, build_shards
    from repro_torch.graph import dijkstra_reference, preset_graph, rmat_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.common import pad_last, take_fill
    from repro_torch.kernels.merge import (merge_scatter_tiled,
                                           merge_scatter_tiled_plain)
    from repro_torch.kernels.relax import (fixpoint_operands,
                                           relax_dst_tiled_fixpoint_batch,
                                           relax_dst_tiled_fixpoint_batch_plain)
    from repro_torch.kernels.send import (send_operands, send_pack_tiled,
                                          send_pack_tiled_plain,
                                          send_payload_bucket)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build ---------------------------------------------------------
    build_s, logs = build.build()
    say(f"build: {build_s:.1f} s for {', '.join(build.KERNELS)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))

    # ---- the scale graph and its shards ---------------------------------
    t0 = time.perf_counter()
    g = preset_graph("scale-1e6")
    sh = build_shards(g, 8, enumerate_triangles=False)
    lb = sh.layout_bytes()
    say(f"scale-1e6: {g.n_vertices} vertices, {g.n_edges} edges, P=8, "
        f"block {sh.block}, S {sh.n_slots}; rx {tuple(sh.rx_src.shape)} "
        f"tx {tuple(sh.tx_src.shape)} mx {tuple(sh.mx_pos.shape)} "
        f"recv_idx {tuple(sh.recv_idx.shape)}; layouts {lb['total_bytes']} B;"
        f" host build {time.perf_counter() - t0:.1f} s")
    cfg = SsspConfig(**ALL_KERNELS)
    eng = SsspEngine.build(sh, cfg)
    dsh = eng.shards
    rng = np.random.default_rng(0)
    deg = np.diff(g.row_ptr.numpy())
    sources = [int(s) for s in rng.choice(np.nonzero(deg)[0], 16,
                                           replace=False)]

    # ---- kernel phase: mid-solve state of the K=16 solve -----------------
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    act = carry.active & ~carry.done[..., None]
    src_t, w_t, dstrel_t, eid_t = dsh.relax_layout
    r_in = fixpoint_operands(carry.dist, act, carry.pruned[:, :dsh.e_loc],
                             eid_t, src_t.shape[1] * dsh.rx_vb)
    r_args = (*r_in[:2], src_t, w_t, dstrel_t, r_in[2])
    r_kw = dict(vb=dsh.rx_vb, n_sweeps=cfg.pallas_sweeps)
    if not bool((r_in[1] > 0).any()):
        fail("kernel phase: the mid-solve frontier is empty")
    r_out = relax_dst_tiled_fixpoint_batch(*r_args, **r_kw)
    r_ref = relax_dst_tiled_fixpoint_batch_plain(*r_args, **r_kw)
    torch.cuda.synchronize()
    rows = {"relax": dict(err=compare(torch, "relax", r_out, r_ref))}

    dist = r_out[0][..., :dsh.block]
    tsrc, tw, tseg, teid = dsh.send_layout
    P = dsh.n_parts
    pruned_t = take_fill(carry.pruned[:, dsh.e_loc:].to(torch.int32),
                         teid.reshape(P, -1), 0).reshape(teid.shape)
    s_args = (*send_operands(dist, carry.last_sent, dsh.slot_valid,
                             tsrc.shape[1], dsh.tx_sb),
              tsrc, tw, tseg, pruned_t)
    s_out = send_pack_tiled(*s_args, sb=dsh.tx_sb)
    s_ref = send_pack_tiled_plain(*s_args, sb=dsh.tx_sb)
    torch.cuda.synchronize()
    rows["send"] = dict(err=compare(torch, "send", s_out, s_ref))

    S = dsh.n_slots
    payload = send_payload_bucket(s_out[0][..., :S], dsh.tx_payload_slot)
    incoming = payload.transpose(0, 2).reshape(P, len(sources), -1).contiguous()
    m_pos, m_rel, m_valid = dsh.merge_layout
    m_args = (pad_last(dist, m_pos.shape[1] * dsh.mx_vb, float("inf")),
              incoming, m_pos, m_rel, m_valid)
    m_out = merge_scatter_tiled(*m_args, vb=dsh.mx_vb)
    m_ref = merge_scatter_tiled_plain(*m_args, vb=dsh.mx_vb)
    torch.cuda.synchronize()
    rows["merge"] = dict(err=compare(torch, "merge", m_out, m_ref))
    say(f"kernel phase: relax, send, merge bit-equal to their plain "
        f"versions (relax frontier {int((r_in[1] > 0).sum())} vertices, "
        f"{int(r_out[2].sum())} relaxations; {int(s_out[2].sum())} sends; "
        f"{int(m_out[2].sum())} receives)")

    # times at these inputs, and the least time the card could take
    rows["relax"]["ms"] = timed(torch, lambda: relax_dst_tiled_fixpoint_batch(
        *r_args, **r_kw), 10)
    rows["relax"]["plain_ms"] = timed(
        torch, lambda: relax_dst_tiled_fixpoint_batch_plain(*r_args, **r_kw), 2)
    rows["relax"]["bound"] = bound(
        nbytes(*r_args, *r_out), 2 * int(r_out[2].sum()))
    rows["relax"]["library_ms"] = None
    rows["send"]["ms"] = timed(
        torch, lambda: send_pack_tiled(*s_args, sb=dsh.tx_sb), 50)
    rows["send"]["plain_ms"] = timed(
        torch, lambda: send_pack_tiled_plain(*s_args, sb=dsh.tx_sb), 2)
    live_cut = int((torch.isfinite(tw) & (pruned_t == 0)).sum())
    rows["send"]["bound"] = bound(nbytes(*s_args, *s_out),
                                  2 * len(sources) * live_cut)
    rows["send"]["library_ms"] = None
    rows["merge"]["ms"] = timed(
        torch, lambda: merge_scatter_tiled(*m_args, vb=dsh.mx_vb), 50)
    rows["merge"]["plain_ms"] = timed(
        torch, lambda: merge_scatter_tiled_plain(*m_args, vb=dsh.mx_vb), 2)
    rows["merge"]["bound"] = bound(nbytes(*m_args, *m_out),
                                   len(sources) * int(m_valid.sum()))
    # the same scatter-min as one PyTorch call, as a yardstick only
    ext = pad_last(m_args[0][..., :dsh.block], dsh.block + 1, float("inf"))
    ridx = dsh.recv_idx.reshape(P, 1, -1).long().clamp(max=dsh.block)
    ridx = ridx.expand(P, len(sources), -1).contiguous()
    rows["merge"]["library_ms"] = timed(
        torch, lambda: ext.scatter_reduce_(-1, ridx, incoming, "amin"), 50)
    for name, r in rows.items():
        say(f"  {name}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.2f} ms "
            f"plain, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")

    # ---- parity phase: card vs CPU through the port ----------------------
    gp = rmat_graph(scale=11)
    shp = build_shards(gp, 8)
    degp = np.diff(gp.row_ptr.numpy())
    srcp = [int(s) for s in rng.choice(np.nonzero(degp)[0], 4, replace=False)]
    on_gpu = SsspEngine.build(shp, cfg).solve(srcp)
    on_cpu = SsspEngine.build(shp, cfg, device="cpu").solve(srcp)
    if not np.array_equal(on_gpu.dist, on_cpu.dist):
        fail("parity: card distances differ from the CPU run")
    for f in COUNTERS:
        a, b = getattr(on_gpu.stats, f), getattr(on_cpu.stats, f)
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            fail(f"parity: {f} differs (card {a}, CPU {b})")
    if on_gpu.status != on_cpu.status or on_gpu.status != "converged":
        fail(f"parity: status card {on_gpu.status}, CPU {on_cpu.status}")
    say(f"parity phase: rmat scale 11 ({gp.n_edges} edges, "
        f"{int(shp.tri_valid.sum())} triangles), P=8 K=4: card == CPU, "
        f"rounds {int(on_gpu.stats.rounds)}, q_relaxations "
        f"{on_gpu.q_relaxations.tolist()}, pruned "
        f"{int(on_gpu.stats.pruned_edges)}")

    # ---- scale phase: the main path --------------------------------------
    eng.solve(sources[:1])          # warm-up: allocator, library loads
    torch.cuda.synchronize()
    build.reset_launches()
    res = eng.solve(sources)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    res1 = eng.solve(sources[:1])
    for name, r in (("K=16", res), ("K=1", res1)):
        if r.status != "converged" or not r.q_converged.all():
            fail(f"scale {name}: status {r.status}")
        if not np.isfinite(r.dist).any() or r.dist.shape[1] != g.n_vertices:
            fail(f"scale {name}: bad distances {r.dist.shape}")
        mteps = int(r.stats.relaxations) / r.wall_s / 1e6
        say(f"scale phase {name}: {r.wall_s:.3f} s wall, "
            f"{int(r.stats.rounds)} rounds, {int(r.stats.relaxations)} "
            f"relaxations, {mteps:.1f} MTEPS")
    for i in range(4):
        ref = dijkstra_reference(g, sources[i])
        if not np.allclose(res.dist[i], ref, rtol=RTOL, atol=ATOL):
            fail(f"scale: source {sources[i]} disagrees with Dijkstra")
    if not np.array_equal(res1.dist[0], res.dist[0]):
        fail("scale: the K=1 solve differs from row 0 of the K=16 solve")
    if min(launches.values()) < 1:
        fail(f"scale: a kernel was not launched on the main path {launches}")
    say(f"scale phase: 16 queries converged, 4 match Dijkstra; launches "
        f"per K=16 solve {launches}")
    profile_solve(torch, eng, sources, out_dir / "chip_smoke_trace.json")

    sources_of = {"relax": ("src/repro_torch/kernels/csrc/relax.cu",
                            "src/repro/kernels/relax/relax.py:337"),
                  "send": ("src/repro_torch/kernels/csrc/send.cu",
                           "src/repro/kernels/send/send.py:103"),
                  "merge": ("src/repro_torch/kernels/csrc/merge.cu",
                            "src/repro/kernels/merge/merge.py:90")}
    table = [{"name": name, "route": "cuda", "source": sources_of[name][0],
              "replaces": sources_of[name][1], "launches": launches[name],
              "max_abs_err": r["err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
             for name, r in rows.items()]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
