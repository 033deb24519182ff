"""Quickstart: serve SSSP queries with an SP-Async session engine (the
reference's ``examples/quickstart.py``, on the PyTorch port).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the GPU by default; ``--device cpu`` (or ``main("cpu")``) runs it
on the CPU, where every kernel backend takes its plain PyTorch version.

The public surface is ONE session object, ``SsspEngine``: build it once
over a graph (partitioning, static message routing, Trishla triangle
enumeration, the tile layouts of the CUDA kernels, all amortized), then
stream queries at it. The port runs eagerly: nothing is traced and there
is no compile cache. The first batch of a K-bucket (powers of two) pays
the bucket's first-run cost (``compile_s``: the kernels' build and module
load on first use, the allocator's growth), and every later batch of that
bucket, whatever its sources, reuses it.

Eight steps are shown:
  1. build the session (``SsspEngine.build``)
  2. solve query batches: the first batch of a bucket pays its first-run
     cost once, every later batch of that bucket does not
  3. stream ragged arrivals through ``submit``/``drain`` (coalesced into
     bucketed batches; a submission is never split)
  4. the all-kernel phase pipeline as a second session over the SAME
     shards (local relax, send pack and merge scatter each on its CUDA
     kernel), bit-identical to the plain backends; then the fused round
     (``round="fused"``): merge + relax fixpoint + send pack in ONE
     kernel launch, 2 dispatches per round instead of 4, still
     bit-identical (``stats.n_dispatches`` shows it)
  5. warm starts: ``precompute_landmarks`` + ``warm_start="landmark"``
     seed every query with triangle-inequality upper bounds (a repeated
     source converges in about one round), and the result LRU serves
     exact repeats with ZERO rounds, all bit-identical to the cold solves
  6. fault injection: the same solve under ``FaultPlan(drop=0.2)`` with
     anti-entropy resend and the ``toka3`` timeout detector: 20% of the
     messages are dropped, yet the distances come back bit-identical
  7. the asynchronous mode: ``exchange="async"`` defers the exchange so
     round r's relax overlaps round r-1's delivery; rounds go up (every
     merge lands one round late), the distances stay bit-identical, and
     ``overlap_fraction`` / ``stale_merges`` / ``bytes_moved`` measure
     the trade
  8. scale: ``build_shards_stream`` partitions an edge-chunk ITERATOR
     into ragged CSR-chunked layouts whose memory follows the real edge
     counts (``layout_bytes()`` reports bytes/edge against the 16 B/edge
     CSR ideal), and the solve stays bit-identical to the dense layout

The legacy free functions (``solve_sim``, ``solve_sim_batch``,
``solve_shmap``, ``solve_shmap_batch``, ``build_shmap_solver``) still work
as thin wrappers over a cached engine.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import (FaultPlan, SsspConfig, SsspEngine,
                              build_shards, build_shards_stream)
from repro_torch.device import resolve_device
from repro_torch.graph import dijkstra_reference, edge_chunks_of, rmat_graph


def main(device=None):
    """The eight steps on ``device`` (None: the GPU)."""
    dev = resolve_device(device)
    # 1. generate a ParMat-style graph (paper §IV.A: weights U[1,20)) and
    #    build the session: partition into 8 shards (paper §III.A: 1-D
    #    block) plus every static layout queries will reuse.
    g = rmat_graph(scale=10, edge_factor=8, seed=0)
    print(f"graph: {g.n_vertices} vertices, {g.n_edges} edges")
    shards = build_shards(g, n_parts=8)
    cfg = SsspConfig(local_solver="delta", delta=6.0, toka="toka2",
                     prune_online=True)
    engine = SsspEngine.build(shards, cfg, device=dev)   # backend="sim"

    # 2. solve: a single source is a K=1 batch. The first batch of a
    #    bucket pays its first-run cost; later batches of that shape reuse
    #    it.
    source = int(g.src[0])
    res = engine.solve(source)
    ref = dijkstra_reference(g, source)
    ok = np.allclose(res.dist[0], ref, rtol=1e-5, atol=1e-4)
    print(f"single-source distances match Dijkstra: {ok}")
    print(f"rounds={int(res.stats.rounds)} "
          f"relaxations={int(res.stats.relaxations)} "
          f"cold: wall={res.wall_s:.2f}s (first run {res.compile_s:.2f}s) "
          f"bucket K={res.bucket_k}")
    assert ok

    # multi-source: 6 queries pad up to the K=8 bucket; padded rows start
    # converged and never relax, send, or count in any statistic. The
    # [K, P, C] payload still moves in ONE exchange per round.
    rng = np.random.default_rng(1)
    sources = [int(s) for s in rng.choice(g.n_vertices, size=6,
                                          replace=False)]
    batch = engine.solve(sources)
    ok = all(np.allclose(batch.dist[k], dijkstra_reference(g, s), rtol=1e-5,
                         atol=1e-4) for k, s in enumerate(sources))
    print(f"batched distances match Dijkstra ({len(sources)} queries, "
          f"bucket K={batch.bucket_k}): {ok}")
    print(f"per-query rounds={batch.q_rounds.tolist()} "
          f"relaxations={batch.q_relaxations.tolist()}")
    assert ok

    # same bucket, new sources -> no first-run cost again
    warm = engine.solve([int(s) for s in
                         rng.choice(g.n_vertices, size=8, replace=False)])
    print(f"second solve, same bucket: compiled={warm.compiled} "
          f"wall={warm.wall_s:.3f}s "
          f"({batch.wall_s / warm.wall_s:.1f}x that bucket's first solve)")
    assert not warm.compiled
    print(f"first runs by bucket: {engine.trace_counts}")

    # 3. streaming arrivals: submit now, drain coalesces into bucketed
    #    batches (here 1+2+1 queries ride one K=4 batch together).
    h1 = engine.submit(source)
    h2 = engine.submit(sources[:2])
    engine.submit(sources[2])
    engine.drain()
    ok = np.allclose(h1.result().dist[0], ref, rtol=1e-5, atol=1e-4)
    print(f"streamed queries: {ok}; h2 rode bucket "
          f"K={h2.result().bucket_k} with {len(h2.sources)} sources")
    assert ok

    # 4. the all-kernel pipeline as a second session over the SAME shards:
    #    the relax kernel settles each shard, the slot-tiled send kernel
    #    packs the payload, the msg-tiled merge kernel scatters incoming,
    #    over the layouts build_shards precomputed (tx_*/mx_* next to
    #    rx_*). On CPU tensors each runs its plain version. Bit-identical
    #    to the plain send and merge.
    kengine = SsspEngine.build(shards, SsspConfig(
        local_solver="pallas", send_backend="pallas", merge_backend="pallas",
        toka="toka2"), device=dev)
    xengine = SsspEngine.build(shards, SsspConfig(
        local_solver="pallas", toka="toka2"), device=dev)   # plain send/merge
    kres = kengine.solve(sources)
    xres = xengine.solve(sources)
    identical = bool(np.array_equal(kres.dist, xres.dist))
    print(f"kernel send/merge bit-identical to the plain backends: "
          f"{identical}; rounds={int(kres.stats.rounds)}")
    assert identical

    # fused round: the three data-plane phases share one tiling, so
    # ``round="fused"`` runs them as a single kernel launch: the dispatches
    # a round drop from 4 (local/send/exchange/merge) to 2 (fused kernel +
    # exchange). Same messages, same rounds, same bits.
    fused_eng = SsspEngine.build(shards, SsspConfig(round="fused",
                                                    toka="toka2"), device=dev)
    fres = fused_eng.solve(sources)
    assert np.array_equal(fres.dist, xres.dist)
    print(f"fused round bit-identical: dispatches/solve "
          f"{int(xres.stats.n_dispatches)} (staged) -> "
          f"{int(fres.stats.n_dispatches)} (fused) over "
          f"{int(fres.stats.rounds)} rounds")

    # 5. warm starts: solve a few landmark pivots ONCE, then serve. The
    #    warm_init stage seeds each query's distances with the
    #    triangle-inequality bound min_l(land[l, src] + land[l, v]), an
    #    upper bound, so the monotone pipeline reaches the same fixpoint
    #    bit for bit from a closer start. A repeated source's seed IS its
    #    solved fixpoint, so it converges in about one round; an exact
    #    repeat within the result LRU does not solve at all.
    wengine = SsspEngine.build(shards, SsspConfig(
        local_solver="delta", delta=6.0, warm_start="landmark",
        prune_online=True), device=dev)
    pivots = [int(s) for s in rng.choice(g.n_vertices, size=4,
                                         replace=False)]
    lm = wengine.precompute_landmarks(pivots)
    print(f"landmark cache: {lm.n_landmarks} pivots, "
          f"{lm.nbytes_per_shard} B/shard")
    cold = engine.solve(pivots[0])                  # cold reference engine
    warm = wengine.solve(pivots[0])                 # landmark-seeded solve
    assert np.array_equal(cold.dist, warm.dist)
    print(f"repeated source, landmark-seeded: rounds "
          f"{int(cold.stats.rounds)} -> {int(warm.stats.rounds)}, "
          f"bit-identical, warm_started={warm.warm_started}")

    # exact repeats can skip the pipeline entirely: a result LRU keyed by
    # (source, graph_epoch) serves them with zero rounds.
    cache_eng = SsspEngine.build(shards, SsspConfig(
        local_solver="delta", delta=6.0), result_cache=32, device=dev)
    first = cache_eng.solve(sources[:2])
    hit = cache_eng.solve(sources[:2])
    assert hit.cache_hits == 2 and int(hit.stats.rounds) == 0
    assert np.array_equal(hit.dist, first.dist)
    print(f"exact repeat from the result cache: zero rounds, "
          f"{hit.wall_s * 1e3:.2f}ms for {len(first.sources)} queries")

    # 6. fault injection: drop 20% of all exchanged messages, heal them
    #    with anti-entropy resends, terminate with the paper's timeout
    #    heuristic (toka3). The scatter-min merge is monotone and
    #    idempotent, so the faulted run reaches the SAME fixpoint: more
    #    rounds, identical bits. The engine's fixpoint certificate (one
    #    extra relax round) backs status="converged"; with
    #    resend_period=0 the same drops would leave status="degraded" and
    #    the result barred from every cache.
    finj = SsspEngine.build(shards, SsspConfig(
        local_solver="delta", delta=6.0, toka="toka3", prune_online=True,
        faults=FaultPlan(drop=0.2, seed=0, resend_period=4)), device=dev)
    fr = finj.solve(sources)
    assert np.array_equal(fr.dist, batch.dist)
    assert fr.status == "converged"
    print(f"20% message drop, healed: status={fr.status}, distances "
          f"bit-identical to the fault-free solve")
    print(f"  rounds {int(batch.stats.rounds)} -> {int(fr.stats.rounds)}, "
          f"stale_merges={int(fr.stats.stale_merges)}, "
          f"resends={int(fr.stats.resends)} "
          f"(+{int(fr.stats.msgs_sent) - int(batch.stats.msgs_sent)} msgs "
          f"healing overhead)")

    # 7. asynchronous mode (P=8): defer the exchange, so the round never
    #    waits on it. Each merge lands one round late, so rounds go UP; on
    #    a real transport each round then costs about max(compute,
    #    neighbour hop) instead of compute + barrier. The stacked sim here
    #    can only COUNT the overlap. Bit-identical distances, certified.
    async_eng = SsspEngine.build(shards, SsspConfig(
        local_solver="delta", delta=6.0, toka="toka2", prune_online=True,
        exchange="async"), device=dev)
    ar = async_eng.solve(sources)
    assert np.array_equal(ar.dist, batch.dist)
    assert ar.status == "converged"
    print(f"async exchange at P=8: rounds {int(batch.stats.rounds)} -> "
          f"{int(ar.stats.rounds)} (merges lag one round), distances "
          f"bit-identical")
    print(f"  overlap_fraction={ar.overlap_fraction:.2f} "
          f"({int(ar.stats.overlap_rounds)} rounds had payload in flight "
          f"during compute), stale_merges="
          f"{int(np.asarray(ar.stats.stale_merges).sum())}, "
          f"bytes_moved={int(ar.stats.bytes_moved)}: on a real transport "
          f"the barrier-free rounds are the speedup; here they are the "
          f"metric")

    # 8. scale: stream-build ragged CSR-chunked shards from edge chunks.
    #    The iterator is the input, so a 10M-edge R-MAT graph partitions
    #    in chunk-sized memory, and the ragged layouts drop the dense
    #    layout's worst-case padding of every tile while the solve stays
    #    bit-identical. (enumerate_triangles matches the dense session
    #    above so Trishla's online pruning takes identical decisions; it
    #    defaults off for the streaming builder, whose target graphs are
    #    too big for it.)
    rsh = build_shards_stream(edge_chunks_of(g), g.n_vertices, 8,
                              enumerate_triangles=True)
    rlb, dlb = rsh.layout_bytes(), shards.layout_bytes()
    reng = SsspEngine.build(rsh, SsspConfig(local_solver="delta", delta=6.0,
                                            toka="toka2", prune_online=True),
                            device=dev)
    rres = reng.solve(sources)
    assert np.array_equal(rres.dist, batch.dist)
    print(f"ragged stream-built shards: {rlb['bytes_per_edge']:.1f} B/edge "
          f"measured (dense {dlb['bytes_per_edge']:.1f}, CSR ideal "
          f"{rlb['ideal_bytes_per_edge']:.0f}), distances bit-identical")
    return dict(graph=g, source=source, single=res, sources=sources,
                batch=batch)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    main(ap.parse_args().device)
