"""SP-Async production runner: generate, partition, solve, validate.

    PYTHONPATH=src python -m repro_torch.launch.sssp_run --graph rmat \
        --scale 12 --parts 8 --exchange bucket --toka toka2 --solver delta

Port of the reference's ``launch/sssp_run.py``: the same flags, checks,
printed lines and exit codes, and ``--device`` (default: the card; the
CPU only when asked, ``--device cpu``). Batched query mode: K sources
share one partition and ride one solve through ``SsspEngine`` (the batch
pads to the next K-bucket):

    ... repro_torch.launch.sssp_run --sources 0,17,1999     # explicit batch
    ... repro_torch.launch.sssp_run --num-sources 16 --batch  # sampled

Backends: ``sim`` (all shards stacked on one device, which on one GPU is
the production path) and ``shmap`` (one process a shard, the paper's MPI
setting), started by ``torchrun`` with one process a part and the
communication backend named:

    torchrun --nproc-per-node 4 -m repro_torch.launch.sssp_run \
        --backend shmap --dist-backend gloo --parts 4 ...

``--dist-backend nccl`` needs a card a process; ``gloo`` lets the
processes share one card (or run on the CPU with ``--device cpu``). Rank 0
prints the lines a ``sim`` run prints; the other ranks print nothing.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core import FaultPlan, SsspConfig, SsspEngine, build_shards
from repro_torch.graph import (dijkstra_reference, rmat_graph, road_grid_graph,
                               random_graph)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--graph", choices=["rmat", "road", "random"],
                   default="rmat")
    p.add_argument("--scale", type=int, default=12)
    p.add_argument("--edge-factor", type=int, default=8)
    p.add_argument("--side", type=int, default=64)
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--source", type=int, default=-1)
    p.add_argument("--sources", default=None,
                   help="comma-separated source list; solves the whole "
                        "batch in one multi-query run")
    p.add_argument("--num-sources", type=int, default=0,
                   help="sample this many sources for a batched run")
    p.add_argument("--batch", action="store_true",
                   help="batched query mode; equivalent to --num-sources 8 "
                        "unless --sources/--num-sources pick the batch")
    p.add_argument("--exchange", default="bucket",
                   choices=["bucket", "pmin", "a2a_dense", "async",
                            "async_bucket", "async_ppermute"],
                   help="message exchange: synchronous (bucket/pmin/"
                        "a2a_dense barrier every round) or deferred "
                        "(async/async_bucket buffer the all-to-all, "
                        "async_ppermute streams bidirectional ring hops): "
                        "same distances, more rounds")
    p.add_argument("--async-lag", type=int, default=1,
                   help="in-flight buffer depth for --exchange async/"
                        "async_bucket (rounds between send and delivery; "
                        "async_ppermute's lag is the ring distance)")
    p.add_argument("--toka", default="toka0",
                   choices=["toka0", "toka1", "toka2", "toka3"])
    p.add_argument("--solver", default="bellman",
                   choices=["bellman", "delta", "pallas"],
                   help="local solver; 'pallas' is the relax kernel")
    p.add_argument("--send-backend", default="xla", choices=["xla", "pallas"],
                   help="cut-edge segment-min pack: plain ops or the send "
                        "kernel")
    p.add_argument("--merge-backend", default="xla", choices=["xla", "pallas"],
                   help="incoming scatter-min: plain ops or the merge kernel")
    p.add_argument("--round", default="staged", choices=["staged", "fused"],
                   help="round pipeline shape: 'staged' dispatches "
                        "local/send/exchange/merge separately; 'fused' runs "
                        "merge + relax fixpoint + send pack as one kernel "
                        "(2 dispatches a round, overrides --solver/"
                        "--send-backend/--merge-backend)")
    p.add_argument("--delta", type=float, default=4.0)
    p.add_argument("--no-prune", action="store_true")
    p.add_argument("--backend", default="sim", choices=["sim", "shmap"])
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   help="communication backend of --backend shmap (under "
                        "torchrun, one process a part): nccl needs a card a "
                        "process, gloo shares one card or runs on the CPU")
    p.add_argument("--device", default=None,
                   help="torch device of the solve (default: cuda)")
    p.add_argument("--warm-start", default="none",
                   choices=["none", "landmark"],
                   help="seed every query's distances from the landmark cache "
                        "(triangle-inequality upper bounds; requires "
                        "symmetric/undirected distances) instead of +inf")
    p.add_argument("--landmarks", type=int, default=0,
                   help="precompute this many landmark pivot solves before "
                        "serving (required with --warm-start landmark)")
    p.add_argument("--result-cache", type=int, default=0,
                   help="LRU size for exact-repeat query results "
                        "(0 disables; hits are served with zero rounds)")
    p.add_argument("--fault-drop", type=float, default=0.0,
                   help="message drop probability (fault injection)")
    p.add_argument("--fault-delay", type=float, default=0.0,
                   help="message delay probability (bounded in-carry queue)")
    p.add_argument("--fault-duplicate", type=float, default=0.0,
                   help="message duplication probability")
    p.add_argument("--fault-reorder", type=float, default=0.0,
                   help="message reorder probability (defer one round)")
    p.add_argument("--fault-seed", type=int, default=0,
                   help="seed of the deterministic fault stream")
    p.add_argument("--resend-period", type=int, default=0,
                   help="anti-entropy: retransmit last_sent minima every N "
                        "rounds to heal dropped messages (0 = off; with "
                        "drops and no resend, solves degrade)")
    p.add_argument("--validate", action="store_true")
    args = p.parse_args()
    if args.warm_start == "landmark" and args.landmarks < 1:
        p.error("--warm-start landmark requires --landmarks N (N >= 1)")
    if args.async_lag < 1:
        p.error("--async-lag must be >= 1 (1 = double-buffered)")
    if args.async_lag != 1 and args.exchange not in ("async", "async_bucket"):
        p.error("--async-lag only applies to --exchange async/async_bucket")
    mesh = None
    if args.backend == "shmap":
        if args.dist_backend is None:
            p.error("--backend shmap requires --dist-backend {nccl,gloo}")
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if args.parts != world:
            p.error(f"--parts {args.parts} must equal the world size "
                    f"{world} under --backend shmap (one process a part: "
                    f"torchrun --nproc-per-node {args.parts})")
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh((world,), ("data",), backend=args.dist_backend)
    try:
        _run(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, mesh) -> None:
    """Generate, partition, solve and validate; under shmap every rank
    runs it (each holds the same result) and rank 0 prints."""
    out = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    faults = None
    if (args.fault_drop or args.fault_delay or args.fault_duplicate
            or args.fault_reorder):
        faults = FaultPlan(drop=args.fault_drop, delay=args.fault_delay,
                           duplicate=args.fault_duplicate,
                           reorder=args.fault_reorder, seed=args.fault_seed,
                           resend_period=args.resend_period)

    if args.graph == "rmat":
        g = rmat_graph(scale=args.scale, edge_factor=args.edge_factor, seed=0)
    elif args.graph == "road":
        g = road_grid_graph(side=args.side, seed=0)
    else:
        g = random_graph(n=1 << args.scale,
                         m=(1 << args.scale) * args.edge_factor, seed=0)
    if args.sources:
        sources = [int(s) for s in args.sources.split(",")]
    elif args.batch or args.num_sources:
        k = args.num_sources or 8
        rng = np.random.default_rng(0)
        sources = sorted(int(s) for s in
                         rng.choice(g.n_vertices, size=k, replace=False))
    else:
        sources = [args.source if args.source >= 0 else int(g.src[0])]
    batched = len(sources) > 1
    out(f"graph: {g.n_vertices}v {g.n_edges}e, "
          f"sources={sources if batched else sources[0]}, P={args.parts}")

    t0 = time.time()
    sh = build_shards(g, args.parts, enumerate_triangles=not args.no_prune)
    out(f"partition+preprocess: {time.time() - t0:.2f}s "
          f"(cut edges: {int(sh.inter_edges.sum())}) "
          f"— amortized over {len(sources)} quer"
          f"{'ies' if batched else 'y'}")

    cfg = SsspConfig(exchange=args.exchange, toka=args.toka,
                     local_solver=args.solver, delta=args.delta,
                     send_backend=args.send_backend,
                     merge_backend=args.merge_backend,
                     warm_start=args.warm_start, round=args.round,
                     prune_online=not args.no_prune, faults=faults,
                     async_lag=args.async_lag)
    if mesh is None:
        engine = SsspEngine.build(sh, cfg, result_cache=args.result_cache,
                                  device=args.device)
    else:
        _build_kernels_once(mesh, args.device)
        engine = SsspEngine.build(sh, cfg, "shmap", mesh, ("data",),
                                  result_cache=args.result_cache,
                                  device=args.device)
    if args.landmarks:
        rng = np.random.default_rng(7)
        pivots = sorted(int(s) for s in
                        rng.choice(g.n_vertices, size=args.landmarks,
                                   replace=False))
        t0 = time.time()
        lm = engine.precompute_landmarks(pivots)
        out(f"landmarks: {lm.n_landmarks} pivots solved in "
              f"{time.time() - t0:.2f}s ({lm.nbytes_per_shard} B/shard; "
              f"warm_start={cfg.warm_start})")
    res = engine.solve(sources)
    dists, stats = res.dist, res.stats
    dt = res.wall_s
    mteps = int(stats.relaxations) / dt / 1e6
    qps = len(sources) / dt
    out(f"solve: {dt:.3f}s (compile {res.compile_s:.3f}s, "
          f"bucket K={res.bucket_k})  rounds={int(stats.rounds)} "
          f"relax={int(stats.relaxations)} msgs={int(stats.msgs_sent)} "
          f"pruned={int(stats.pruned_edges)}  MTEPS={mteps:.1f} "
          f"queries/s={qps:.2f}"
          + (" [warm-started]" if res.warm_started else ""))
    out(f"status: {res.status} "
          f"(converged {int(res.q_converged.sum())}/{len(sources)} queries)")
    if args.exchange.startswith("async"):
        out(f"async: overlap={res.overlap_fraction:.2f} "
              f"({int(stats.overlap_rounds)}/{int(stats.rounds)} rounds "
              f"comm/compute overlapped)  "
              f"stale_merges={int(np.asarray(stats.stale_merges).sum())}  "
              f"bytes_moved={int(stats.bytes_moved)}  lag={args.async_lag}")
    if faults is not None:
        out(f"faults: {faults}  stale_merges={int(stats.stale_merges)} "
              f"resends={int(stats.resends)}")
    if args.result_cache:
        rerun = engine.solve(sources)
        out(f"repeat solve: {rerun.wall_s * 1e3:.2f}ms "
              f"cache_hits={rerun.cache_hits}/{len(sources)} "
              f"rounds={int(rerun.stats.rounds)} (exact repeats ride the "
              f"result LRU, zero rounds)")
    if batched:
        qr = np.asarray(stats.q_rounds)
        qx = np.asarray(stats.q_relaxations)
        for k, s in enumerate(sources):
            reach = int(np.isfinite(dists[k]).sum())
            out(f"  query[{k}] source={s}: rounds={int(qr[k])} "
                  f"relax={int(qx[k])} reachable={reach}/{g.n_vertices}")
    else:
        out(f"reachable: {int(np.isfinite(dists[0]).sum())}/{g.n_vertices}")

    if args.validate:
        # unconverged queries fail before the distance check runs: an
        # upper-bound row can happen to match Dijkstra on easy graphs, and
        # "validated" must never describe a degraded solve
        conv = res.q_converged
        if res.status != "converged" or not conv.all():
            bad = [sources[k] for k in np.flatnonzero(~conv)]
            out(f"validation FAILED: status={res.status}, unconverged "
                  f"sources={bad}")
            raise SystemExit(1)
        ok = True
        for k, s in enumerate(sources):
            ref = dijkstra_reference(g, s)
            ok &= np.allclose(dists[k], ref, rtol=1e-5, atol=1e-4)
        out(f"validation vs Dijkstra ({len(sources)} quer"
              f"{'ies' if batched else 'y'}): {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)


def _build_kernels_once(mesh, device) -> None:
    """On the card, rank 0 builds the round's kernels while the other
    ranks wait, so P processes do not start the same nvcc runs."""
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    if resolve_device(device).type != "cuda":
        return
    if mesh.rank == 0:
        from repro_torch.kernels import build
        build.build(build.ROUND)
    dist.barrier()


if __name__ == "__main__":
    main()
