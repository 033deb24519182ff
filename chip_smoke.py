#!/usr/bin/env python3
"""Drive the PyTorch port of SP-Async, its transformer serving and
training paths (dense and MoE), AutoInt, the GNN zoo and the training
entry point, on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
Phases, each of which exits non-zero on a mismatch:

  build    compile the CUDA kernel sources (relax, send, merge, round; each
           holds a dense kernel and its ragged sibling, relax also the three
           single-query kernels; embedding_bag; flash_attention and
           flash_attention_tc, kernel 12's f32 (3xTF32) and bf16 routes,
           both on the tensor cores) from src/repro_torch/kernels/csrc, one
           nvcc each, in parallel;
  kernel   hold each dense kernel against its plain PyTorch version on the
           card, bit-equal, on the real layouts of the scale-1e6 graph at
           mid-solve state (kernel 1 with the shards' relax live chunks, as
           the engine passes them, and again with its entry point's
           pre-pass; its live chunks and chain steps a sweep printed), and
           time kernel, plain version and bound (kernels 1 and 3 as medians
           of 20 timings of 10 calls, kernel 1's bound the bytes of the rows
           and the live chunks; kernel 1's planted fault, its hazard re-read
           off, must differ, at that state, else on a path inside one tile;
           kernel 5 and its scatter_reduce_ yardstick three ways, three
           times: CUDA events over 10 back-to-back calls as medians, device
           time a launch from a profiler trace, host time a call); the
           fused round kernel 7 at the state after round 2 of a fused solve,
           with bucket messages and again with a dense incoming row (a
           dense exchange's merge mode), as medians of 20 timings of 10
           calls, its live chunks and chain steps a sweep printed, its
           bound the bytes of the rows and the live chunks; in each mode a
           planted fault, its hazard re-read off, must differ (at that
           state, else on a path inside one tile); kernels 3 and 7 (and
           4 and 8 in the kern1e7 and fused phases) again with last_sent
           +inf on every other query, the rows a resend round hands them,
           bit-equal to their plain versions;
  parity   solve rmat scale 11 (Trishla on, P=8, K=4) with the all-kernel
           staged config and with round="fused", each on the card and on
           the CPU: distances and every counter equal; fused == staged but
           for n_dispatches; then local_solver="delta" and toka="toka1"
           (all-kernel) the same way, their distances == the toka0
           solve's; then every other exchange (async_bucket with
           async_lag=2) staged (all-kernel) and fused, and toka2 and toka3
           under bucket, async and a2a_dense (all-kernel staged), card ==
           CPU in distances and every counter (stale_merges and
           overlap_rounds included), distances == the bucket toka0
           solve's; then each plan of the fault matrix (FAULT_PLANS)
           under bucket, a2a_dense and async with toka3, staged and
           fused: card == CPU in distances and every counter
           (stale_merges and resends included; the CPU solves in a pool
           of worker processes while the card solves), distances == the
           fault-free solve's;
  scale    the dense path: SsspEngine.solve on preset "scale-1e6" (65,536
           vertices, 955,492 directed edges; P=8) with K=16 and K=1, every
           query certified converged, 4 sources checked against Dijkstra,
           every staged dense kernel launched; profile of the K=16 solve;
           then the fused K=16 solve of the same sources (the dense fused
           path): equal but for n_dispatches, one round launch a round;
           its profile; then 300 sources (bucket 512: kernels 3-6 split the
           queries into groups) staged and fused, each converged and equal
           in distances and per-query rounds and relaxations to the same
           sources in batches of at most 256, 4 of them against Dijkstra;
  engine   the session engine on the scale-1e6 dense shards: 8 landmark
           pivots precomputed (wall, bytes a shard); the scale phase's 16
           sources solved landmark-warm, staged (kernels 1, 3, 5) and
           fused (kernel 7): bit-equal to the cold solves, converged, 4
           against scipy's Dijkstra, rounds and medians of 5 walls warm
           and cold; kernels 1 and 7 at the warm round-0 state (every
           seeded vertex in the frontier) bit-equal to their plain
           versions, timed, and with a live chunk dropped from their list
           different; the result cache (16 repeats: 16 hits, no round,
           bucket 0; 8 cached + 8 new ride bucket 8, equal to a cold solve
           of the 8); drain of 64 single-source handles (max_bucket 16: 4
           batches of 16, each row equal to a K=1 solve; queries a
           second); warmup(16) > 0 then 0.0; solve_sim_batch and solve_sim
           on one engine (trace counts as the reference's test);
           certify=False reports the detector;
  async    the asynchronous mode on the scale-1e6 dense shards (K=16, the
           scale phase's sources) and, after the fused main path, on the
           scale-1e7 ragged shards (K=16, the main path's sources): the
           all-kernel staged config and round="fused", each under bucket
           (the baseline), async, async_bucket (async_lag=2), pmin,
           a2a_dense and async_ppermute; every solve converged and
           bit-equal in distances to the bucket solve, each fused solve
           equal to the staged solve of its exchange in every counter but
           n_dispatches and overlap_rounds; the dense exchanges' fused
           solves launch the round kernel (7 or 8, dense merge mode) once
           a round and never a merge kernel, their staged solves no merge
           kernel (dense rows merge elementwise); rounds, overlap_rounds,
           stale_merges, bytes_moved, the wall of a second solve and the
           peak device memory printed; then at scale-1e7 toka2 and toka3
           under bucket and async, bit-equal to the toka0 solve, with the
           rounds each detector adds;
  faults   fault injection at the main path's width, after the async
           phase on the scale-1e6 dense shards and on the scale-1e7
           ragged shards (K=16, the same sources): the fault matrix's
           four plans (drop with resend, delay, duplicate, reorder; seed
           0) all-kernel staged under bucket and a2a_dense and fused
           under bucket, and the acceptance matrix's drop and delay plans
           under async with toka3, staged and fused; every solve
           converged and bit-equal in distances to the fault-free solve,
           its launches checked as in the async phase; rounds beside the
           fault-free solve's, stale_merges, resends, the wall, the peak
           device memory and the fault queue's size printed; at scale-1e6
           also a degraded solve (drop 0.6, no resend: status degraded,
           distances at or above the fixpoint and not equal to it) and
           the draws (uniform and randint of [8, 16, 65536] under
           per-shard keys, card == CPU bit for bit); at scale-1e7 the
           injector's time a round under a2a_dense for each plan (plain
           PyTorch, CUDA events, median of 20);
  dist     the multi-process backend (backend="shmap"), after the faults
           phase at each scale: kernels 1, 3, 5, 7 (1e6 dense) and 2, 4,
           6, 8 (1e7 ragged) on a rank's one-shard stack
           (SsspShards.shard), each launched through the round's phase
           function and bit-equal to its plain version; then 8 processes
           spawned on the card (the kernels built before they start),
           one shard each, gloo collectives on CUDA tensors: at scale-1e6
           dense K=16 the all-kernel staged bucket solve and the fused
           one, every other exchange staged, toka2 and toka3, the drop
           plan with resend and the landmark warm start; at scale-1e7
           ragged the staged bucket solve; every rank's result equal to
           the sim engine's on the card bit for bit (distances, every
           counter, status), the path's kernels launched by the ranks;
           the wall of the 8-rank solve beside the sim's and the time a
           round spent in collectives printed (8 ranks time-sliced on one
           card, not a deployment's speed); and, on a one-card machine,
           NCCL at world size 1 (rmat scale 11 as one shard) == sim;
  nolayout after the dist phase at each scale: the same graph's shards
           built with relax_layout=False, comm_layout=False (1e6 by
           build_shards, 1e7 by build_shards_stream), the K=16 sources
           solved under the all-kernel staged config and under
           round="fused": the four fallbacks (local_solver, send, merge,
           round) warn once each, no kernel launches, and both solves ==
           the plain config (bellman, xla, staged) on the layout-full
           shards in distances, every counter and status; bytes per edge
           with and without layouts and the walls printed;
  phases   sim_phase_fns with the pallas backends on the round-2 state of
           the all-kernel staged solve (fused on the fused solve's): local,
           send, merge and fused launch kernels 1/2, 3/4, 5/6 and 7/8,
           each bit-equal to its plain version; local -> send -> exchange
           -> merge == one round of make_round bit for bit; each phase
           timed (CUDA events, median of 10 x 5 calls): the per-phase
           breakdown;
  wrappers the reference's per-shard entry points on shard 0 of that
           state: send_pack_pallas, merge_scatter_pallas,
           relax_fixpoint_batch_pallas (1e6) or
           relax_fixpoint_batch_ragged_pallas (1e7), and
           local_fixpoint_pallas_batch, each launching its kernel and
           bit-equal to its plain version and to row 0 of the stacked
           entry point;
  runner   python -m repro_torch.launch.sssp_run on rmat scale 16 (P=8, 4
           sources, async with toka3, drop 0.2 with resend every 4
           rounds, the three staged kernels), staged and fused, the two
           processes at once: each exits 0 and validates against
           Dijkstra; its lines are echoed;
  ragged   stream-build scale-1e6 ragged (build_shards_stream) and dense
           (build_shards over csr_from_coo of the same chunks) and solve
           both with K=16: distances and every counter equal; 300 sources
           on the ragged shards, checked as in the scale phase;
  kern1e7  the main path's state: stream-build preset "scale-1e7" (524,288
           vertices, 9,879,136 directed edges; P=8, ragged, EB 512, VB 128)
           and hold each ragged kernel against its plain version, bit-equal,
           at the state after round 2 of the K=16 solve (the ragged fused
           round at round 2 of the fused solve); time them (kernels 2, 4
           and 8 as medians of 20 timings of 10 calls; kernel 4 also for
           query 0 alone, K=1, where its rows need no interleave, beside
           K=16; kernels 4 and 6 at K = 450, 512 and 1,000, the K=16 rows
           tiled, where they split the queries into groups, each query
           equal to the K=16 launch's); kernel 8 also with a dense
           incoming row, bit-equal and timed the same way; a planted
           fault, each of kernels 2 and 8 (8 in both modes) with its
           hazard re-read off, must differ from its plain
           version (at that state, else on a path inside one tile);
  main     the staged main path: SsspEngine.solve on the scale-1e7 ragged
           shards with K=16 and K=1, every query certified converged, 2
           sources checked against scipy's Dijkstra, the ragged kernels
           launched and the dense ones not; the median of 5 more K=16
           solves; then 8 landmarks and the K=16 solve landmark-warm
           (kernels 2, 4, 6): bit-equal to the cold solve, converged,
           rounds and walls beside the cold ones;
  fused    this slice's main path: the same solves with round="fused":
           converged, equal to the staged solves in distances and every
           counter but n_dispatches, round_ragged launched once a round,
           merge_ragged never, relax/send_ragged only by rescued rounds,
           no dense kernel; the median of 5 more K=16 solves; profiles of
           the staged and the fused K=16 solves;
  single   the standalone kernel API's single-query relax kernels on
           scale-1e6 as one block (layout [512, 16, 512]): from 2 sources,
           kernel 9 in a residual-frontier loop (relax_fixpoint_pallas,
           n_sweeps=8), kernel 10 with the frontier chased between launches
           (relax_masked_pallas) and kernel 11 until a sweep changes
           nothing (relax_pallas): equal to scipy's Dijkstra and bit-equal
           to each other, kernel 10's relaxations equal to the same loop on
           the CPU (kernels 10 and 11 given the layout's live chunks, as a
           caller that sweeps one layout many times does); each kernel
           bit-equal to its plain version (kernel 9 at n_sweeps=2) at a
           mid-solve state with a 10% Trishla mask (10 and 11 also with
           their entry point's pre-pass; with a live chunk dropped from
           their list, the planted fault, they must differ), timed (kernel
           9 as medians of 20 timings of 10 calls, its live chunks printed,
           its bound the bytes of the rows, the weights and the other
           planes' live chunks; a planted fault, its hazard re-read off,
           must differ; kernels 10 and 11 three ways, three times, with
           the live chunks and with the pre-pass, their bounds over the
           live chunks); relax_jnp timed beside them;
  embag    kernel 13 at the AutoInt configuration's size: a [39e6, 16]
           f32 table made on the card, 10,223,616 one-index bags (sum) and
           2,555,904 four-index bags (mean, f32 and bf16), 5% padding, 5%
           negative indices (wrapping): each
           bit-equal to the plain version, timed beside its bound and
           F.embedding_bag;
  flash    kernel 12 (flash attention) through its entry point against its
           plain version at the prefill shapes of gemma-7b ([4, 16, 2048,
           256]), deepseek-7b ([4, 32, 2048, 128]), mistral-large (GQA
           group 12: q [1, 96, 2048, 128], kv [1, 8, 2048, 128]),
           olmoe-1b-7b ([4, 16, 2048, 128]) and qwen3-moe (GQA group 16: q
           [4, 64, 2048, 128], kv [4, 4, 2048, 128]), causal,
           and at gemma's decode shape (Sq = 1, q_offset = Skv - 1), each in
           bf16 (the bf16 kernel, within 2 bf16 ulps) and f32 (the 3xTF32
           kernel, within 2e-5), each launch counted on its own route, timed
           beside its bounds and F.scaled_dot_product_attention (f32: both
           as medians); two planted faults must fail their checks: the bf16
           kernel with its P_lo products dropped (p rounded to bf16 alone)
           and the f32 kernel with its lo products dropped (1xTF32);
  serve    the transformer's main path: full-width gemma-7b in bf16
           (weights made on the card from a seed), attn_impl="pallas": 4
           prompts of 2048 tokens through make_prefill_step, the caches
           padded by 32, 32 greedy steps of make_serve_step; kernel 12's
           tensor-core kernel launched 28 times in the prefill, and nothing
           else, and no kernel in decode; time to first token, decode
           ms/step and tokens/s, peak memory, profiles of the prefill and of
           4 decode steps (the serve steps write the donated caches in
           place); then the prefill's last logits "pallas" vs "xla"
           (bf16, full width; the same greedy tokens), attention() per
           layer against the xla path on the same q, k, v (2 bf16 ulps; a
           planted fault, the last kv tile dropped, must fail it),
           decode == forward for full-width gemma at
           depth 4 in f32 (2e-3; the run that counts kernel 12's f32 route),
           and the three smoke configs' forward on the card vs the CPU
           (1e-4);
  train    the training path: deepseek-7b at its published widths in
           bf16, attn_impl="chunked", cut to 2 layers and batch 4 x seq
           1024: three make_train_step steps (AdamWConfig()) on one fixed
           batch, the loss finite and falling, then one with
           microbatches=2; ms a step, tokens/s, peak memory; the SMOKE
           config in f32 on the card vs the CPU (loss 1e-4 relative, each
           gradient within 1e-3 of its largest value); a gradient through
           attn_impl="pallas" must raise;
  moe serve the MoE FFN's serving path: olmoe-1b-7b at its published
           widths and full depth, then qwen3-moe-235b-a22b at its published
           widths cut to 4 layers (its whole model's bytes stated from
           params.abstract), bf16, weights made on the card, driven as the
           serve phase drives gemma (4 x 2048 prompts, 32 greedy steps):
           kernel 12's bf16 route once a layer in the prefill and nothing
           else, no kernel in decode; prefill and decode times, tokens/s,
           peak memory and the share of (token, k) assignments capacity
           dropped in each; the prefill's last logits "pallas" vs "xla"
           (the xla run routed as the kernel run) and each layer's
           attention vs "xla" on the same q, k, v; then both MoE SMOKE
           configs in f32, card (kernel 12) vs CPU (plain): logits within
           1e-4 of the largest, the routing (topi, slot_token, pos, keep)
           equal in every layer, the smallest top-k gap printed;
  moe train olmoe-1b-7b at its published widths cut to 2 layers, bf16,
           chunked attention, batch 4 x seq 1024, as the train phase drives
           deepseek; both MoE SMOKE configs' loss and gradients card vs
           CPU;
  recsys   AutoInt at its published widths (39 fields x 1e6 ids x 16,
           624e6 parameters, 2.50 GB in f32), weights made on the card from
           a seed, under the reference's recsys traffic (REC_SHAPES): 3
           AdamW train steps at batch 65,536 (loss finite, ms a step,
           samples/s, peak memory), serving at batch 512 and 262,144
           (latency median and worst of 20, samples/s), retrieval of one
           query against 1e6 candidate vectors, top 100 (ms, the values
           checked against the scores of the indices); no kernel launched
           (AutoInt does its own take and masked sum, as the reference
           does); then the SMOKE config in f32 with bags of 3 ids holding
           the padding sentinel, card vs CPU: serve scores within 1e-4 of
           the largest, the loss within 1e-4 relative, each gradient within
           1e-3 of its largest value, and the retrieval indices equal on
           candidates with duplicated rows (ties);
  gnn      each GNN at its published widths and depth on its cell of
           GNN_SHAPES, weights and batch made on the card from seeds:
           gat-cora and graphcast (depth cut from 16 to GRAPHCAST_LAYERS,
           as memory forces) on minibatch_lg (169,984 nodes, 168,960 random
           edges, 602 features), egnn and mace on molecule (4,096 atoms as
           128 molecules of 32, 8,192 edges inside the molecules): 3 AdamW
           steps each (loss finite, ms a step, peak memory); a profile of a
           graphcast step (device time by kernel, idle share); no kernel
           launched; then every GNN SMOKE config on the launcher's graph,
           card vs CPU (loss 1e-4 relative, gradients 1e-3 of the
           largest), MACE's rotation invariance on the card (the SMOKE
           check of tests/test_arch_smoke.py, and the full-width model on
           the molecule batch within 1e-3 of the largest feature), and
           examples/gnn_products.py (repro_torch.examples.gnn_products) on
           the card;
  launch   python -m repro_torch.launch.train --arch <a> --smoke on the
           card for olmoe-1b-7b, autoint and mace: 6 steps with a
           checkpoint every 2 in a temporary directory, step 6 restored on
           the card bit for bit, then a second run to 10 steps that must
           resume from step 6, its losses within 1e-5 relative of an
           uninterrupted 10-step run's.

The line before last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Build logs and traces go to chiprun_out/.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import statistics
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
CSRC = "src/repro_torch/kernels/csrc"
TPU = "src/repro/kernels"
SOURCES = {                    # kernel -> (CUDA source, TPU kernel replaced)
    "relax": (f"{CSRC}/relax.cu", f"{TPU}/relax/relax.py:337"),
    "send": (f"{CSRC}/send.cu", f"{TPU}/send/send.py:103"),
    "merge": (f"{CSRC}/merge.cu", f"{TPU}/merge/merge.py:90"),
    "relax_ragged": (f"{CSRC}/relax.cu", f"{TPU}/relax/relax.py:456"),
    "send_ragged": (f"{CSRC}/send.cu", f"{TPU}/send/send.py:187"),
    "merge_ragged": (f"{CSRC}/merge.cu", f"{TPU}/merge/merge.py:165"),
    "round": (f"{CSRC}/round.cu", f"{TPU}/round/round.py:219"),
    "round_ragged": (f"{CSRC}/round.cu", f"{TPU}/round/round.py:457"),
    "relax_single": (f"{CSRC}/relax.cu", f"{TPU}/relax/relax.py:239"),
    "relax_masked": (f"{CSRC}/relax.cu", f"{TPU}/relax/relax.py:155"),
    "relax_sweep": (f"{CSRC}/relax.cu", f"{TPU}/relax/relax.py:89"),
    "embedding_bag": (f"{CSRC}/embedding_bag.cu",
                      f"{TPU}/embedding_bag/embedding_bag.py:43"),
    "flash_attention_tc": (f"{CSRC}/flash_attention_tc.cu",
                           f"{TPU}/flash_attention/flash_attention.py:68"),
    "flash_attention": (f"{CSRC}/flash_attention.cu",
                        f"{TPU}/flash_attention/flash_attention.py:68"),
}
AUTOINT = dict(fields=39, vocab=1_000_000, dim=16)  # src/repro/configs/autoint.py:6
SERVE_BULK = 262_144           # src/repro/configs/registry.py:77
TRAIN_BATCH = 65_536           # src/repro/configs/registry.py:75
STAGED = ("relax", "send", "merge")     # the staged round's kernels
MANY_K = (450, 512, 1000)      # kernels 4 and 6 timed at these query counts too
# the async phase's exchange settings: the synchronous baseline first
EXCHANGE_SETTINGS = (("bucket", {}), ("async", {}),
                     ("async_bucket", dict(async_lag=2)), ("pmin", {}),
                     ("a2a_dense", {}), ("async_ppermute", {}))
DENSE_EXCHANGES = ("pmin", "a2a_dense", "async_ppermute")
# The fault plans: tests/test_faults.py's matrix (seed 0), each run staged
# (all-kernel) under bucket and a2a_dense and fused under bucket; and
# tests/test_async_exchange.py's acceptance plans under async with toka3,
# staged and fused. Every solve must equal the fault-free one in distances.
FAULT_PLANS = {"drop": dict(drop=0.3, resend_period=4),
               "delay": dict(delay=0.4), "duplicate": dict(duplicate=0.4),
               "reorder": dict(reorder=0.4)}
ACCEPT_PLANS = {"drop": dict(drop=0.2, seed=11, resend_period=4),
                "delay": dict(delay=0.3, seed=12)}
FAULT_SETTINGS = ([(name, plan, "staged", "bucket", "toka0")
                   for name, plan in FAULT_PLANS.items()]
                  + [(name, plan, "staged", "a2a_dense", "toka0")
                     for name, plan in FAULT_PLANS.items()]
                  + [(name, plan, "fused", "bucket", "toka0")
                     for name, plan in FAULT_PLANS.items()]
                  + [(f"accept {name}", plan, rnd, "async", "toka3")
                     for name, plan in ACCEPT_PLANS.items()
                     for rnd in ("staged", "fused")])
DEGRADED_PLAN = dict(drop=0.6, seed=2)   # no resend: the solve degrades
# The runner on the card: the README's command at scale 16 with a faulted
# asynchronous exchange on the three staged kernels, validated
RUNNER_ARGS = ("--graph", "rmat", "--scale", "16", "--edge-factor", "8",
               "--parts", "8", "--num-sources", "4", "--exchange", "async",
               "--toka", "toka3", "--fault-drop", "0.2", "--resend-period",
               "4", "--solver", "pallas", "--send-backend", "pallas",
               "--merge-backend", "pallas", "--validate")
BF16_OPS_PER_S = 989.4e12      # H100 SXM bf16 dense tensor rate
TF32_OPS_PER_S = 495e12         # H100 SXM TF32 dense tensor rate
# The serve phase: full-width gemma-7b (src/repro/configs/gemma_7b.py), 4
# prompts of 2048 tokens, caches padded by 32, 32 greedy decode steps: a
# cut of the registry's prefill_32k (32 x 32768) and decode_32k (128 x
# 32768) cells, src/repro/configs/registry.py:45-48.
SERVE = dict(arch="gemma-7b", batch=4, prompt=2048, gen=32, seed=15)
# Kernel 12 at the prefill shapes of the dense LM configs: (B, Hq, Hkv, S, D)
FLASH_SHAPES = {"gemma-7b": (4, 16, 16, 2048, 256),
                "deepseek-7b": (4, 32, 32, 2048, 128),
                "mistral-large-123b": (1, 96, 8, 2048, 128),
                "olmoe-1b-7b": (4, 16, 16, 2048, 128),
                "qwen3-moe-235b-a22b": (4, 64, 4, 2048, 128)}
FLASH_F32_TOL = 2e-5           # max abs error, tests/test_kernels.py:63
# In bf16 the kernel and its plain version read the same inputs, compute in
# f32 and round once: they may differ where the two f32 sums, taken in
# another order, round apart. Held to 2 bf16 ulps of |plain| elementwise
# (an ulp of at least 5e-6, for values near 0).
FLASH_BF16_ULPS = 2
DEPTH_CHECK = dict(layers=4, batch=2, seq=256)    # decode == forward, f32
# pallas vs xla prefill at full width in bf16: largest |difference| of the
# last logits over the largest |logit|. Measured 0.00226 on an H100 (the two
# paths round their f32 attention to bf16 at different ulps, 28 layers
# deep); held at about 9x that. It is blind to small faults: the kernel with
# its last kv tile dropped read 0.002823 on an H100, since the attention of a
# random model over 2048 keys moves its residual stream little. The phase
# therefore also holds attention() per layer against the xla path on the same
# q, k, v (FLASH_BF16_ULPS), and fails unless that check sees the dropped tile.
PALLAS_VS_XLA_REL = 0.02


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


def timed_median(torch, fn, reps: int = 10, samples: int = 20):
    """(median, mean) ms per call over ``samples`` timings of ``reps``
    back-to-back calls each, after one warm-up call: CUDA events, as
    ``timed``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times), statistics.fmean(times)


def once(torch, fn):
    """(result, ms) of one call, timed with CUDA events: for the plain
    versions, Python loops over hundreds of chunks, timed on the call that
    the comparison uses."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_bytes(planes, n_live: int) -> int:
    """Bytes of ``n_live`` chunks of the dense layout planes ``planes``
    ([..., EB] each): what a kernel that skips the dead chunks reads."""
    return n_live * sum(a.shape[-1] * a.element_size() for a in planes)


def bound(n_bytes: int, n_ops: int, ops_per_s: float = FP32_OPS_PER_S):
    """Least time (ms) for the work: bytes over the memory rate vs
    operations over the card's peak for their type (float32 unless given);
    returns (ms, what bounds it)."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def resend_rows(torch, last_sent):
    """``last_sent`` with every other query's rows set to +inf: the state
    a resend round hands the send pack for the queries it retransmits."""
    out = last_sent.clone()
    out[:, ::2] = float("inf")
    return out


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


def same_results(a, b, what: str, skip=()):
    """Fail unless two QueryResults agree in distances, every counter but
    those in ``skip``, and status."""
    import numpy as np
    if not np.array_equal(a.dist, b.dist):
        fail(f"{what}: distances differ")
    for f in COUNTERS + ("n_dispatches", "bytes_moved", "stale_merges",
                         "overlap_rounds", "resends"):
        if f in skip:
            continue
        x, y = getattr(a.stats, f), getattr(b.stats, f)
        if not np.array_equal(np.asarray(x), np.asarray(y)):
            fail(f"{what}: {f} differs ({x} vs {y})")
    if a.status != b.status:
        fail(f"{what}: status {a.status} vs {b.status}")


# Kernels a port entry point launches before its main kernel on the same
# stream: send.cu's interleave (kernels 3 and 4) and relax.cu's live-chunk
# pre-pass (kernels 1 and 9 without a list). A profile counts each under
# the main kernel that follows it, so no part of an entry point's work
# drops out of the list.
HELPER_KERNELS = ("interleave_kernel", "live_flags_kernel",
                  "live_list_kernel")


def by_entry_point(kernels):
    """Device time by kernel name from ``kernels``, (start, end, name) in
    stream order, with each helper kernel's time added to the next main
    kernel's entry: {name: [us, launches of the main kernel, {helper:
    us}]}."""
    out, pending = {}, {}
    for s, f, name in kernels:
        helper = next((h for h in HELPER_KERNELS if h in name), None)
        if helper:
            pending[helper] = pending.get(helper, 0.0) + (f - s)
            continue
        row = out.setdefault(name, [0.0, 0, {}])
        row[0] += (f - s) + sum(pending.values())
        row[1] += 1
        for h, us in pending.items():
            row[2][h] = row[2].get(h, 0.0) + us
        pending = {}
    for h, us in pending.items():   # a helper with no main kernel after it
        out.setdefault(h, [0.0, 0, {}])[0] += us
    return out


def profile_run(torch, fn, trace_path: Path, label: str):
    """Where the time of one run of ``fn`` goes: device time by kernel name
    (a port entry point's helper kernels under its main kernel, their share
    printed beside it) and the device's idle share of the run's window,
    read from a torch.profiler trace (kernel events inside the ``run``
    annotation)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("run"):
            fn()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())["traceEvents"]
    win = next(e for e in events if e.get("name") == "run"
               and e.get("cat") == "user_annotation")
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and t0 <= e["ts"] < t1)
    busy, end = 0.0, t0
    for s, f, _ in kernels:
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    say(f"profile {label}: window {win['dur'] / 1e3:.3f} ms, device "
        f"busy {busy / 1e3:.3f} ms, idle share {1 - busy / win['dur']:.3f}, "
        f"{len(kernels)} kernels")
    rows = sorted(by_entry_point(kernels).items(), key=lambda kv: -kv[1][0])
    for name, (us, n, helpers) in rows[:10]:
        extra = "".join(f" (+ {h} {hu / 1e3:.3f} ms)"
                        for h, hu in helpers.items())
        say(f"  {us / 1e3:9.3f} ms  {n:5d}x  {name[:90]}{extra}")


def live_sources(np, rng, g, k, avoid=()):
    """``k`` live sources drawn by ``rng``, none of them in ``avoid``."""
    live = np.nonzero(np.diff(g.row_ptr.numpy()))[0]
    if len(avoid):
        live = np.setdiff1d(live, np.asarray(avoid, live.dtype))
    return [int(s) for s in rng.choice(live, k, replace=False)]


def concat_graph(np, chunks, n):
    """The CSR graph (min-deduplicated, as the stream build dedups) of a
    list of edge chunks."""
    from repro_torch.graph import csr_from_coo
    return csr_from_coo(*(np.concatenate([c[i] for c in chunks])
                          for i in range(3)), n)


def scipy_dijkstra(np, g, sources):
    """Host Dijkstra in float64 over the graph's CSR (scipy's heap, since
    a Python heap takes tens of seconds a source at ten million edges)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    e = g.n_edges
    m = csr_matrix((g.weight[:e].numpy().astype(np.float64),
                    g.dst[:e].numpy(), g.row_ptr.numpy()),
                   shape=(g.n_vertices, g.n_vertices))
    return dijkstra(m, directed=True, indices=list(sources))


def dense_kernel_phase(torch, eng, sources, cfg, out_dir: Path):
    """Dense kernels 1, 3, 5 at the state after round 2 of a solve: each
    bit-equal to its plain version (kernel 1 with the shards' relax live
    chunks, as the engine passes them, and with its entry point's
    pre-pass), then timed beside its bound (kernels 1 and 3 as medians of
    20 x 10 calls; kernel 1's bound over the live chunks it reads); kernel
    1's planted fault, its hazard re-read off, must differ."""
    import numpy as np
    from repro_torch.kernels.common import pad_last, take_fill
    from repro_torch.kernels.merge import (merge_scatter_tiled,
                                           merge_scatter_tiled_plain)
    from repro_torch.kernels.relax import (fixpoint_operands,
                                           relax_dst_tiled_fixpoint_batch,
                                           relax_dst_tiled_fixpoint_batch_plain)
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.send import (send_operands, send_pack_tiled,
                                          send_pack_tiled_plain,
                                          send_payload_bucket)
    dsh = eng.shards
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    act = carry.active & ~carry.done[..., None]
    src_t, w_t, dstrel_t, eid_t = dsh.relax_layout
    r_in = fixpoint_operands(carry.dist, act, carry.pruned[:, :dsh.e_loc],
                             eid_t, src_t.shape[1] * dsh.rx_vb)
    r_args = (*r_in[:2], src_t, w_t, dstrel_t, r_in[2])
    r_kw = dict(vb=dsh.rx_vb, n_sweeps=cfg.pallas_sweeps)
    r_chunks = dsh.relax_chunks
    if not bool((r_in[1] > 0).any()):
        fail("kernel phase: the mid-solve frontier is empty")
    r_out = relax_dst_tiled_fixpoint_batch(*r_args, **r_kw, chunks=r_chunks)
    r_ref, r_plain = once(torch, lambda: relax_dst_tiled_fixpoint_batch_plain(
        *r_args, **r_kw))
    rows = {"relax": dict(err=max(
        compare(torch, "relax", r_out, r_ref),
        compare(torch, "relax (pre-pass)",
                relax_dst_tiled_fixpoint_batch(*r_args, **r_kw), r_ref)),
        plain_ms=r_plain)}
    live_n = r_chunks[1][:, -1].tolist()
    say(f"  relax live chunks: {sum(live_n)} of {r_chunks[0].numel()}; "
        f"chain steps a sweep per shard {live_n} (the whole layout: "
        f"{src_t.shape[1] * src_t.shape[2]} each)")

    dist = r_out[0][..., :dsh.block]
    tsrc, tw, tseg, teid = dsh.send_layout
    P = dsh.n_parts
    pruned_t = take_fill(carry.pruned[:, dsh.e_loc:].to(torch.int32),
                         teid.reshape(P, -1), 0).reshape(teid.shape)
    s_args = (*send_operands(dist, carry.last_sent, dsh.slot_valid,
                             tsrc.shape[1], dsh.tx_sb),
              tsrc, tw, tseg, pruned_t)
    s_out = send_pack_tiled(*s_args, sb=dsh.tx_sb)
    s_ref, s_plain = once(torch, lambda: send_pack_tiled_plain(
        *s_args, sb=dsh.tx_sb))
    rows["send"] = dict(err=compare(torch, "send", s_out, s_ref),
                        plain_ms=s_plain)
    # a resend round: last_sent +inf on half the queries
    rs_args = (*send_operands(dist, resend_rows(torch, carry.last_sent),
                              dsh.slot_valid, tsrc.shape[1], dsh.tx_sb),
               *s_args[3:])
    rs_out = send_pack_tiled(*rs_args, sb=dsh.tx_sb)
    rows["send"]["err"] = max(rows["send"]["err"], compare(
        torch, "send (resend rows)", rs_out,
        send_pack_tiled_plain(*rs_args, sb=dsh.tx_sb)))
    say(f"  send with last_sent +inf on half the queries (a resend round): "
        f"bit-equal, {int(rs_out[2].sum())} sends (else "
        f"{int(s_out[2].sum())})")

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
    r = rows["relax"]
    r["ms"], r["mean_ms"] = timed_median(
        torch, lambda: relax_dst_tiled_fixpoint_batch(*r_args, **r_kw,
                                                      chunks=r_chunks))
    # bytes: the rows, and the live chunks of the four planes with the list
    n_live = sum(live_n)
    r["bound"] = bound(
        nbytes(*r_args[:2], *r_out, r_chunks[1])
        + live_bytes(r_args[2:], n_live) + n_live * r_chunks[0].element_size(),
        2 * int(r_out[2].sum()))
    r["library_ms"] = None
    say(f"  relax: {r['ms']:.4f} ms kernel (median; mean {r['mean_ms']:.4f}); "
        f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}) over the live "
        f"chunks, {bound(nbytes(*r_args, *r_out), 0)[0]:.5f} ms over every "
        f"chunk")
    planted_hazard_fault(
        torch, "relax",
        lambda: (lambda **f: relax_mod._launch_tiled(
            *r_args, **r_kw, chunks=r_chunks, **f), r_ref),
        lambda: path_case(torch, np, r_args[0].device, "dense")[2])
    rows["send"]["ms"], rows["send"]["mean_ms"] = timed_median(
        torch, lambda: send_pack_tiled(*s_args, sb=dsh.tx_sb))
    live_cut = int((torch.isfinite(tw) & (pruned_t == 0)).sum())
    # bounds over the live chunks (those holding an edge or a message:
    # the shards' send and merge lists): the rows and those chunks' planes
    n_mx, n_tx = (int(b[:, -1].sum()) for _, b in (dsh.round_chunks[0],
                                                    dsh.round_chunks[2]))
    rows["send"]["bound"] = bound(
        nbytes(*s_args[:3], *s_out) + live_bytes(s_args[3:], n_tx),
        2 * len(sources) * live_cut)
    rows["send"]["library_ms"] = None
    rows["merge"]["plain_ms"] = timed(
        torch, lambda: merge_scatter_tiled_plain(*m_args, vb=dsh.mx_vb), 2)
    rows["merge"]["bound"] = bound(
        nbytes(*m_args[:2], *m_out) + live_bytes(m_args[2:], n_mx),
        len(sources) * int(m_valid.sum()))
    say(f"  send, merge bounds over the live chunks ({n_tx} of "
        f"{tsrc[..., 0].numel()}, {n_mx} of {m_pos[..., 0].numel()}): "
        f"{rows['send']['bound'][0]:.5f}, {rows['merge']['bound'][0]:.5f} "
        f"ms; over every chunk {bound(nbytes(*s_args, *s_out), 0)[0]:.5f}, "
        f"{bound(nbytes(*m_args, *m_out), 0)[0]:.5f} ms")
    calls = {"kernel 5": lambda: merge_scatter_tiled(*m_args, vb=dsh.mx_vb),
             "scatter_reduce_": merge_library_call(torch, dsh, m_args[0],
                                                   incoming, len(sources))}
    runs = three_way(torch, calls, out_dir)
    for key, name in (("ms", "kernel 5"), ("library_ms", "scatter_reduce_")):
        rows["merge"][key] = statistics.median(r["events"] for r in runs[name])
    return rows


def merge_library_call(torch, dsh, dist_pad, incoming, k):
    """The merge's scatter-min as one PyTorch call, as a yardstick only."""
    from repro_torch.kernels.common import pad_last
    P = dsh.n_parts
    ext = pad_last(dist_pad[..., :dsh.block], dsh.block + 1, float("inf"))
    ridx = dsh.recv_idx.reshape(P, 1, -1).long().clamp(max=dsh.block)
    ridx = ridx.expand(P, k, -1).contiguous()
    return lambda: ext.scatter_reduce_(-1, ridx, incoming, "amin")


def device_ms(torch, fn, n: int, trace_path: Path):
    """Device time by kernel name, from a torch.profiler trace of ``n``
    back-to-back calls: {name: (ms a launch, launches a call)} over the
    trace's kernel and memset events. The trace may miss a few launches of
    a burst of short calls (it held 15-18 of each 20 on an H100), so a
    launch's time is the mean over those it holds. A trace that holds no
    kernel at all (seen on an H100 for a burst of 0.014 ms calls) is
    taken again, up to five times, rather than read as 0 ms."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _attempt in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace_path))
        by_name = {}
        for e in json.loads(trace_path.read_text())["traceEvents"]:
            if e.get("cat") in ("kernel", "gpu_memset"):
                us, count = by_name.get(e["name"], (0.0, 0))
                by_name[e["name"]] = (us + e["dur"], count + 1)
        if by_name:
            return {name: (us / 1e3 / count, count / n)
                    for name, (us, count) in by_name.items()}
    fail(f"the profiler recorded no kernel in five traces ({trace_path})")


def host_ms(torch, fn, n: int) -> float:
    """Host time (ms) of one call over ``n`` back-to-back calls with no
    synchronize between them: the time to issue a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / n


def three_way(torch, calls: dict, out_dir: Path, reps: int = 3):
    """Each call of ``calls`` timed three ways, ``reps`` times in turns:
    CUDA events over 10 back-to-back calls (median of 20 timings, which
    reads the larger of the host's issue time and the device time), device
    time a call from a profiler trace of 20 calls, and host time a call
    (no synchronize); a call's device time is the sum over its kernels of
    the mean time a launch times the launches a call (rounded: each kernel
    here launches once a call). Returns {name: [{events, device, host} per
    rep]}."""
    runs = {name: [] for name in calls}
    for rep in range(reps):
        for name, fn in calls.items():
            events = timed_median(torch, fn)[0]
            kernels = device_ms(torch, fn, 20, out_dir / (
                "chip_smoke_trace_3way_"
                + name.replace(" ", "").replace("_", "") + ".json"))
            host = host_ms(torch, fn, 50)
            runs[name].append(dict(events=events, host=host, device=sum(
                ms * max(1, round(c)) for ms, c in kernels.values())))
            say(f"  {name} run {rep + 1}: events {events:.4f} ms (median of "
                f"20 x 10 calls), device {runs[name][-1]['device']:.4f} ms "
                f"a call (" + ", ".join(
                    f"{n[:48]} {ms:.4f} ms a launch, {c:g} a call"
                    for n, (ms, c) in kernels.items())
                + f"), host {host:.4f} ms a call")
    return runs


def ragged_kernel_phase(torch, eng, sources, cfg):
    """Ragged kernels 2, 4, 6 at the state after round 2 of the main path's
    K=16 solve: each bit-equal to its plain version (timed on that one
    call), then timed beside its bound and, for merge, the library call."""
    from repro_torch.kernels.common import pad_last, take_fill
    import numpy as np
    from repro_torch.kernels.merge import (merge_scatter_ragged,
                                           merge_scatter_ragged_plain)
    from repro_torch.kernels.relax import (
        fixpoint_operands, relax_dst_ragged_fixpoint_batch,
        relax_dst_ragged_fixpoint_batch_plain)
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.send import (send_operands, send_pack_ragged,
                                          send_pack_ragged_plain,
                                          send_payload_bucket)
    dsh = eng.shards
    P, K = dsh.n_parts, len(sources)
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    act = carry.active & ~carry.done[..., None]
    src_r, w_r, rel_r, eid_r, ct_r = dsh.relax_layout
    bp = -(-dsh.block // dsh.rx_vb) * dsh.rx_vb
    r_in = fixpoint_operands(carry.dist, act, carry.pruned[:, :dsh.e_loc],
                             eid_r, bp)
    r_args = (*r_in[:2], ct_r, src_r, w_r, rel_r, r_in[2])
    r_kw = dict(vb=dsh.rx_vb, n_sweeps=cfg.pallas_sweeps)
    if not bool((r_in[1] > 0).any()):
        fail("ragged kernel phase: the mid-solve frontier is empty")
    r_out = relax_dst_ragged_fixpoint_batch(*r_args, **r_kw)
    r_ref, r_plain = once(torch, lambda: relax_dst_ragged_fixpoint_batch_plain(
        *r_args, **r_kw))
    rows = {"relax_ragged": dict(err=compare(torch, "relax_ragged", r_out,
                                             r_ref), plain_ms=r_plain)}

    dist = r_out[0][..., :dsh.block]
    tsrc, tw, tseg, teid, tct = dsh.send_layout
    pruned_t = take_fill(carry.pruned[:, dsh.e_loc:].to(torch.int32),
                         teid.reshape(P, -1), 0).reshape(teid.shape)
    s_args = (*send_operands(dist, carry.last_sent, dsh.slot_valid,
                             dsh.n_stiles, dsh.tx_sb),
              tct, tsrc, tw, tseg, pruned_t)
    s_kw = dict(sb=dsh.tx_sb, bounds=dsh.send_bounds)
    s_out = send_pack_ragged(*s_args, **s_kw)
    s_ref, s_plain = once(torch, lambda: send_pack_ragged_plain(
        *s_args, sb=dsh.tx_sb))
    rows["send_ragged"] = dict(err=compare(torch, "send_ragged", s_out,
                                           s_ref), plain_ms=s_plain)
    # a resend round: last_sent +inf on half the queries
    rs_args = (*send_operands(dist, resend_rows(torch, carry.last_sent),
                              dsh.slot_valid, dsh.n_stiles, dsh.tx_sb),
               *s_args[3:])
    rs_out = send_pack_ragged(*rs_args, **s_kw)
    rows["send_ragged"]["err"] = max(rows["send_ragged"]["err"], compare(
        torch, "send_ragged (resend rows)", rs_out,
        send_pack_ragged_plain(*rs_args, sb=dsh.tx_sb)))
    say(f"  send_ragged with last_sent +inf on half the queries (a resend "
        f"round): bit-equal, {int(rs_out[2].sum())} sends (else "
        f"{int(s_out[2].sum())})")

    payload = send_payload_bucket(s_out[0][..., :dsh.n_slots],
                                  dsh.tx_payload_slot)
    incoming = payload.transpose(0, 2).reshape(P, K, -1).contiguous()
    m_pos, m_rel, m_valid, m_ct = dsh.merge_layout
    m_args = (pad_last(dist, -(-dsh.block // dsh.mx_vb) * dsh.mx_vb,
                       float("inf")), incoming, m_ct, m_pos, m_rel, m_valid)
    m_kw = dict(vb=dsh.mx_vb, bounds=dsh.merge_bounds)
    m_out = merge_scatter_ragged(*m_args, **m_kw)
    m_ref, m_plain = once(torch, lambda: merge_scatter_ragged_plain(
        *m_args, vb=dsh.mx_vb))
    rows["merge_ragged"] = dict(err=compare(torch, "merge_ragged", m_out,
                                            m_ref), plain_ms=m_plain)
    say(f"ragged kernel phase: relax, send, merge bit-equal to their plain "
        f"versions (relax frontier {int((r_in[1] > 0).sum())} vertices, "
        f"{int(r_out[2].sum())} relaxations; {int(s_out[2].sum())} sends; "
        f"{int(m_out[2].sum())} receives)")

    r = rows["relax_ragged"]
    r["ms"], r["mean_ms"] = timed_median(
        torch, lambda: relax_dst_ragged_fixpoint_batch(*r_args, **r_kw))
    r["bound"] = bound(nbytes(*r_args, *r_out), 2 * int(r_out[2].sum()))
    planted_hazard_fault(
        torch, "relax_ragged",
        lambda: (lambda **f: relax_mod._launch_ragged(*r_args, **r_kw, **f),
                 r_ref),
        lambda: path_case(torch, np, r_args[0].device)[0])
    rows["relax_ragged"]["library_ms"] = None
    sr = rows["send_ragged"]
    sr["ms"], sr["mean_ms"] = timed_median(
        torch, lambda: send_pack_ragged(*s_args, **s_kw))
    live_cut = int((torch.isfinite(tw) & (pruned_t == 0)).sum())
    sr["bound"] = bound(nbytes(*s_args, dsh.send_bounds, *s_out),
                        2 * K * live_cut)
    sr["library_ms"] = None
    # the same launch for query 0 alone (no interleave): the interleave's
    # effect at K = 16 beside K = 1
    s1_args = (*(a[:, :1].contiguous() for a in s_args[:2]), *s_args[2:])
    s1_out = send_pack_ragged(*s1_args, **s_kw)
    compare(torch, "send_ragged (K=1)", s1_out,
            send_pack_ragged_plain(*s1_args, sb=dsh.tx_sb))
    ms1, mean1 = timed_median(torch, lambda: send_pack_ragged(*s1_args,
                                                             **s_kw))
    b1 = bound(nbytes(*s1_args, dsh.send_bounds, *s1_out), 2 * live_cut)
    say(f"  send_ragged at K={K}: {sr['ms']:.4f} ms (median; mean "
        f"{sr['mean_ms']:.4f}), bound {sr['bound'][0]:.5f} ms; at K=1 "
        f"(query 0, bit-equal): {ms1:.4f} ms (median; mean {mean1:.4f}), "
        f"bound {b1[0]:.5f} ms; {live_cut} live cut edges")
    # kernel 4 at many queries: the K=16 rows tiled to kq queries (query q
    # repeats query q % 16), so every output of query q must equal the K=16
    # launch's for query q % 16
    for kq in MANY_K:
        reps = -(-kq // K)
        kq_args = (*(a.repeat(1, reps, 1)[:, :kq].contiguous()
                     for a in s_args[:2]), *s_args[2:])
        kq_out = send_pack_ragged(*kq_args, **s_kw)
        q = torch.arange(kq, device=tw.device) % K
        for i, (got, want) in enumerate(zip(kq_out, s_out)):
            if not torch.equal(got, want[:, q]):
                fail(f"send_ragged at K={kq}: output {i} differs from the "
                     f"K={K} launch's")
        ms_k, mean_k = timed_median(
            torch, lambda: send_pack_ragged(*kq_args, **s_kw))
        b_k = bound(nbytes(*kq_args, dsh.send_bounds, *kq_out),
                    2 * kq * live_cut)
        say(f"  send_ragged at K={kq} (the K={K} rows tiled, equal to the "
            f"K={K} launch's per query): {ms_k:.4f} ms (median; mean "
            f"{mean_k:.4f}), bound {b_k[0]:.5f} ms")
        del kq_args, kq_out
    # kernel 6 likewise: the K=16 rows and incoming messages tiled to kq
    for kq in MANY_K:
        reps = -(-kq // K)
        kq_args = (*(a.repeat(1, reps, 1)[:, :kq].contiguous()
                     for a in m_args[:2]), *m_args[2:])
        kq_out = merge_scatter_ragged(*kq_args, **m_kw)
        q = torch.arange(kq, device=tw.device) % K
        for i, (got, want) in enumerate(zip(kq_out, m_out)):
            if not torch.equal(got, want[:, q]):
                fail(f"merge_ragged at K={kq}: output {i} differs from the "
                     f"K={K} launch's")
        ms_k, mean_k = timed_median(
            torch, lambda: merge_scatter_ragged(*kq_args, **m_kw))
        b_k = bound(nbytes(*kq_args, dsh.merge_bounds, *kq_out),
                    kq * int(m_valid.sum()))
        say(f"  merge_ragged at K={kq} (the K={K} rows tiled, equal to the "
            f"K={K} launch's per query): {ms_k:.4f} ms (median; mean "
            f"{mean_k:.4f}), bound {b_k[0]:.5f} ms")
        del kq_args, kq_out
    rows["merge_ragged"]["ms"] = timed(
        torch, lambda: merge_scatter_ragged(*m_args, **m_kw), 50)
    rows["merge_ragged"]["bound"] = bound(
        nbytes(*m_args, dsh.merge_bounds, *m_out), K * int(m_valid.sum()))
    rows["merge_ragged"]["library_ms"] = timed_median(
        torch, merge_library_call(torch, dsh, m_args[0], incoming, K))[0]
    return rows


def planted_hazard_fault(torch, name, case, fallback):
    """Kernel 2, 8, 9 or 7 with its hazard re-read off (every source read
    from its early gather) must differ from its plain version: at the
    phase's state ``case()`` -> (launch(**fault), ref), else, where that
    state shows no hazard, on the path-inside-a-tile case ``fallback()``."""
    for where, make in (("the phase's state", case),
                        ("the path-inside-a-tile layout", fallback)):
        launch, ref = make()
        bad = launch(hazard=False)
        torch.cuda.synchronize()
        diff = [i for i, (g, w) in enumerate(zip(bad, ref))
                if not torch.equal(g, w)]
        k = -1 if name.startswith("relax") else 4     # the relaxations
        if diff:
            say(f"  planted fault ({name}, hazard re-read off) differs from "
                f"the plain version at {where} in outputs {diff}, "
                f"relaxations {int(bad[k].sum())} vs {int(ref[k].sum())}")
            return
    fail(f"{name}: the planted fault (hazard re-read off) equals the plain "
         f"version")


def path_case(torch, np, dev, layout="ragged"):
    """Kernels 2 and 8 (``layout`` "ragged") or 9 and 7 ("dense") on a
    layout where a hazard must show: 128 vertices on 2 shards (VB 32, EB 4),
    a path 0 -> 1 -> ... -> 30 inside vertex tile 0 of shard 0 (hops of
    weight 1, four to a chunk) and a few cut edges; row 0 holds 10 v on the
    path, all in the frontier, so a later chunk reads what an earlier chunk
    of the same tile improved (kernel 9: shard 0's row 0). Returns (relax
    case, round case, kernel 1's case or None for "ragged"), each a
    (launch(**fault), plain result) pair for ``planted_hazard_fault``."""
    from repro_torch.core import build_shards
    from repro_torch.graph import csr_from_coo
    from repro_torch.kernels.relax import (fixpoint_operands,
                                           relax_dst_ragged_fixpoint_batch_plain,
                                           relax_dst_tiled_fixpoint_batch_plain,
                                           relax_dst_tiled_fixpoint_plain)
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.round import (fused_round_operands,
                                           fused_round_ragged_plain,
                                           fused_round_tiled_plain)
    from repro_torch.kernels.round import round as round_mod
    n, k = 128, 3
    src = np.r_[np.arange(30), 30, 5, 70, 100]
    dst = np.r_[np.arange(1, 31), 70, 100, 71, 101]
    sh = build_shards(csr_from_coo(src, dst, np.ones(len(src), np.float32),
                                   n), 2, enumerate_triangles=False,
                      layout=layout, relax_vb=32, relax_eb=4, send_sb=32,
                      send_eb=4, merge_vb=32, merge_eb=4).to(dev)
    P, block = sh.n_parts, sh.block
    dist = torch.full((P, k, block), float("inf"), device=dev)
    dist[:, :, :31] = 10.0 * torch.arange(31, device=dev)
    front = dist < float("inf")
    pruned = torch.zeros((P, sh.e_loc + sh.e_cut), dtype=torch.bool,
                         device=dev)
    lay = sh.relax_layout
    d, f, prn = fixpoint_operands(dist, front, pruned[:, :sh.e_loc], lay[3],
                                  -(-block // 32) * 32)
    r_kw = dict(vb=32, n_sweeps=2)
    if layout == "ragged":
        r_args = (d, f, lay[4], *lay[:3], prn)
        r_launch, r_plain = (relax_mod._launch_ragged,
                             relax_dst_ragged_fixpoint_batch_plain)
        launch, plain = round_mod._launch_ragged, fused_round_ragged_plain
    else:
        r_args = tuple(a[0, 0] for a in (d, f)) + tuple(
            a[0].contiguous() for a in (*lay[:3], prn))
        r_launch, r_plain = (relax_mod._launch_single,
                             relax_dst_tiled_fixpoint_plain)
        launch, plain = round_mod._launch_tiled, fused_round_tiled_plain
    relax = ((lambda **x: r_launch(*r_args, **r_kw, **x)),
             r_plain(*r_args, **r_kw))
    batch = None
    if layout == "dense":
        b_args = (d, f, *lay[:3], prn)
        batch = ((lambda **x: relax_mod._launch_tiled(
            *b_args, **r_kw, chunks=sh.relax_chunks, **x)),
            relax_dst_tiled_fixpoint_batch_plain(*b_args, **r_kw))
    live = torch.ones((P, k), dtype=torch.bool, device=dev)
    last = torch.full((P, k, sh.n_slots), float("inf"), device=dev)
    inc = torch.full((P, k, sh.recv_idx.shape[-1] * P), float("inf"),
                     device=dev)
    ops = fused_round_operands(
        dist, front, live, inc.reshape(P, k, -1), last, sh.slot_valid,
        sh.relax_layout, sh.send_layout, sh.merge_layout,
        pruned[:, :sh.e_loc], pruned[:, sh.e_loc:], vb=32, sb=32,
        dense=False)
    kw = dict(vb=32, sb=32, n_sweeps=2, dense=False)
    chunks = {} if layout == "ragged" else dict(chunks=sh.round_chunks)
    rnd = ((lambda **x: launch(*ops, **kw, **chunks, **x)),
           plain(*ops, **kw))
    return relax, rnd, batch


def tensors(*items):
    """The tensors among ``items``, tuples flattened and None dropped."""
    out = []
    for x in items:
        if isinstance(x, tuple):
            out += tensors(*x)
        elif x is not None:
            out.append(x)
    return out


def round_kernel_phase(torch, np, eng, sources, cfg, name):
    """Kernel 7 (``name`` "round", dense layouts) or 8 ("round_ragged") at
    the state after round 2 of ``eng``'s fused solve: bit-equal to its plain
    version (all six outputs) with the delivered bucket messages, and again
    with a dense [P, K, block] incoming row made from a numpy seed (the
    merge mode of a dense exchange); each plain version timed on the call
    the comparison used, the kernel as medians of 20 x 10 calls (CUDA
    events) beside its bound (kernel 7 with the shards' live chunks, as the
    engine passes them, its bytes those of the rows and of the live chunks
    it reads); in each mode a planted fault, the hazard re-read off, must
    differ. The table's row is the bucket mode's."""
    from repro_torch.kernels.round import (fused_round_operands,
                                           fused_round_ragged,
                                           fused_round_ragged_plain,
                                           fused_round_tiled,
                                           fused_round_tiled_plain)
    from repro_torch.kernels.round import round as round_mod
    kernel, plain = ((fused_round_ragged, fused_round_ragged_plain)
                     if name == "round_ragged"
                     else (fused_round_tiled, fused_round_tiled_plain))
    dsh = eng.shards
    P, K = dsh.n_parts, len(sources)
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    live = ~carry.done
    bucket = carry.incoming.reshape(P, K, -1)
    if not bool(torch.isfinite(bucket).any()):
        fail(f"{name} kernel phase: no message was delivered in round 2")
    rng = np.random.default_rng(7)
    shape = tuple(carry.dist.shape)
    dense_inc = torch.from_numpy(np.where(
        rng.random(shape) < 0.01, rng.uniform(0, 20, shape),
        np.inf).astype(np.float32)).to(carry.dist.device)
    kw = dict(vb=dsh.rx_vb, sb=dsh.tx_sb, n_sweeps=cfg.pallas_sweeps)
    ragged = name == "round_ragged"
    chunks = {} if ragged else dict(chunks=dsh.round_chunks)
    if not ragged:
        counts = [(int(b[:, -1].sum()), i.numel(), b[:, -1].tolist())
                  for i, b in dsh.round_chunks]
        say(f"  round live chunks (merge, relax, send): "
            + ", ".join(f"{a} of {n}" for a, n, _ in counts)
            + f"; chain steps a sweep per shard {counts[1][2]} (the whole "
            f"layout: {dsh.rx_src.shape[1] * dsh.rx_src.shape[2]} each)")
    row, errs = {}, []
    for dense, incoming in ((False, bucket), (True, dense_inc)):
        ops = fused_round_operands(
            carry.dist, carry.active & live[..., None], live, incoming,
            carry.last_sent, dsh.slot_valid, dsh.relax_layout,
            dsh.send_layout, dsh.merge_layout, carry.pruned[:, :dsh.e_loc],
            carry.pruned[:, dsh.e_loc:], vb=dsh.rx_vb, sb=dsh.tx_sb,
            dense=dense)
        out = kernel(*ops, dense=dense, **kw, **chunks)
        ref, plain_ms = once(torch, lambda: plain(*ops, dense=dense, **kw))
        errs.append(compare(torch, name, out, ref))
        ms, mean = timed_median(
            torch, lambda: kernel(*ops, dense=dense, **kw, **chunks))
        # operations: an add and a min per relaxation and per live cut edge
        # and query, a min per delivered message (or row entry) and query
        tx_w, tx_prn = ops[8][1], ops[8][3]
        live_cut = int((torch.isfinite(tx_w) & (tx_prn == 0)).sum())
        merges = (incoming[..., :dsh.block].numel() if dense
                  else K * int(ops[6][2].sum()))
        n_ops = 2 * int(out[4].sum()) + 2 * K * live_cut + merges
        if ragged:
            n_bytes = nbytes(*tensors(*ops), *out)
        else:
            # the rows, and each stage's live chunks with their lists
            n_bytes = nbytes(*ops[:6], *out)
            for lay, (idx, b) in zip(ops[6:], dsh.round_chunks):
                if lay is not None:
                    n_live = int(b[:, -1].sum())
                    n_bytes += (live_bytes(lay, n_live) + nbytes(b)
                                + n_live * idx.element_size())
        b = bound(n_bytes, n_ops)
        say(f"  {name} ({'dense' if dense else 'bucket'} incoming): "
            f"{ms:.4f} ms kernel (median; mean {mean:.4f})"
            f", {plain_ms:.2f} ms plain, bound {b[0]:.5f} "
            f"ms ({b[1]}); {int(torch.isfinite(incoming).sum())} incoming "
            f"values, {int(out[4].sum())} relaxations, "
            f"{int(out[5].sum())} sends, "
            f"residual rows {int((out[1] > 0).any(-1).sum())}")
        if not dense:
            row = dict(ms=ms, mean_ms=mean, plain_ms=plain_ms, bound=b,
                       library_ms=None)
            # a resend round: last_sent +inf on half the queries
            rs_ops = list(ops)
            rs_ops[4] = resend_rows(torch, ops[4])
            rs_out = kernel(*rs_ops, dense=dense, **kw, **chunks)
            errs.append(compare(torch, f"{name} (resend rows)", rs_out,
                                plain(*rs_ops, dense=dense, **kw)))
            say(f"  {name} with last_sent +inf on half the queries (a "
                f"resend round): bit-equal, {int(rs_out[5].sum())} sends "
                f"(else {int(out[5].sum())})")
        fn = round_mod._launch_ragged if ragged else round_mod._launch_tiled
        launch = (lambda **f: fn(*ops, dense=dense, **kw, **chunks, **f))
        planted_hazard_fault(
            torch, f"{name} ({'dense' if dense else 'bucket'} incoming)",
            lambda: (launch, ref),
            lambda: path_case(torch, np, ops[0].device,
                              "ragged" if ragged else "dense")[1])
    row["err"] = max(errs)
    return {name: row}


def async_phase(torch, np, shards, sources, label: str, ragged: bool):
    """The asynchronous mode at the main path's width: the all-kernel
    staged config and the fused round, each under the six exchange
    settings of ``EXCHANGE_SETTINGS`` (``bucket`` first, the baseline).
    Every solve certified converged and bit-equal in distances to the
    bucket solve of its round; each fused solve equal to the staged solve
    of its exchange in every counter but n_dispatches and overlap_rounds
    (defined otherwise). Launches: a staged solve runs the relax and send
    kernels, and the merge kernel only under a bucketed exchange (dense
    rows merge elementwise); a fused solve runs one round kernel a round,
    the relax and send kernels only to rescue, never the merge kernel;
    nothing of the other layout family. Prints rounds, overlap_rounds,
    stale_merges, bytes_moved (an int32 total, which wraps as the
    reference's does), the wall of a second solve and the peak device
    memory of the first. Returns {(round, exchange): result}."""
    from repro_torch.core import SsspConfig, SsspEngine
    from repro_torch.kernels import build
    sfx = "_ragged" if ragged else ""
    out = {}
    for rnd, base_cfg in (("staged", ALL_KERNELS),
                          ("fused", dict(round="fused"))):
        for ex, extra in EXCHANGE_SETTINGS:
            what = f"async {label} {rnd} {ex}"
            eng = SsspEngine.build(shards, SsspConfig(
                **dict(base_cfg, exchange=ex, **extra)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            res = eng.solve(sources)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            got = dict(build.LAUNCHES)
            wall = eng.solve(sources).wall_s
            if res.status != "converged" or not res.q_converged.all():
                fail(f"{what}: status {res.status}")
            if not np.array_equal(res.dist, out.get((rnd, "bucket"),
                                                    res).dist):
                fail(f"{what}: distances differ from the bucket solve")
            if rnd == "fused":
                same_results(res, out["staged", ex], f"{what} vs staged",
                             skip=("n_dispatches", "overlap_rounds"))
            rounds = int(res.stats.rounds)
            mine = {k: got[k + sfx] for k in STAGED + ("round",)}
            other = sum(v for k, v in got.items()
                        if k.endswith("_ragged") != ragged)
            if rnd == "fused":
                ok = (mine["round"] == rounds and not mine["merge"]
                      and mine["relax"] >= mine["send"])
            else:
                ok = (mine["relax"] > 0 and mine["send"] > 0
                      and not mine["round"]
                      and (mine["merge"] > 0) != (ex in DENSE_EXCHANGES))
            if not ok or other:
                fail(f"{what}: launches {got} for {rounds} rounds")
            say(f"{what}: {rounds} rounds, overlap_rounds "
                f"{int(res.stats.overlap_rounds)}, stale_merges "
                f"{int(res.stats.stale_merges)}, bytes_moved "
                f"{int(res.stats.bytes_moved)}, wall {wall:.4f} s (first "
                f"{res.wall_s:.4f} s), peak {peak / 2**30:.3f} GiB; "
                f"launches {mine}")
            out[rnd, ex] = res
            del eng
    say(f"async phase {label}: K={len(sources)}, every exchange staged "
        f"and fused converged, bit-equal to the bucket solve")
    return out


def toka_phase(np, shards, sources, base, label: str):
    """toka2 and toka3 under ``bucket`` and ``async`` (all-kernel staged):
    converged, distances bit-equal to the toka0 solve of the same exchange
    (``base[("staged", exchange)]``), and the rounds each detector adds
    printed."""
    from repro_torch.core import SsspConfig, SsspEngine
    for ex in ("bucket", "async"):
        r0 = base["staged", ex]
        for toka in ("toka2", "toka3"):
            res = SsspEngine.build(shards, SsspConfig(
                **dict(ALL_KERNELS, exchange=ex, toka=toka))).solve(sources)
            if (res.status != "converged" or not res.q_converged.all()
                    or not np.array_equal(res.dist, r0.dist)):
                fail(f"toka {label} {toka} {ex}: status {res.status}, or "
                     f"distances differ from the toka0 solve")
            say(f"toka {label} {toka} under {ex}: {int(res.stats.rounds)} "
                f"rounds, {int(res.stats.rounds) - int(r0.stats.rounds)} "
                f"more than toka0, {res.wall_s:.4f} s wall")


def _fault_config(rnd: str, ex: str, toka: str) -> dict:
    base = ALL_KERNELS if rnd == "staged" else dict(round="fused")
    return dict(base, exchange=ex, toka=toka)


def faults_phase(torch, np, shards, sources, label: str, ragged: bool,
                 base: dict):
    """Fault injection at the main path's width: every setting of
    ``FAULT_SETTINGS`` (the fault matrix's four plans staged under bucket
    and a2a_dense and fused under bucket; the acceptance plans under async
    with toka3, staged and fused). Every solve certified converged and
    bit-equal in distances to the fault-free solve of its round, exchange
    and detector (``base[(round, exchange)]`` for toka0, else solved here).
    Launches as ``async_phase`` checks them. Prints the rounds beside the
    fault-free solve's, stale_merges, resends, the wall, the peak device
    memory and the fault queue's size. Returns {(round, exchange, toka):
    fault-free result}."""
    from repro_torch.core import FaultPlan, SsspConfig, SsspEngine
    from repro_torch.kernels import build
    sfx = "_ragged" if ragged else ""
    P, K = shards.n_parts, len(sources)
    clean = {(rnd, ex, "toka0"): r for (rnd, ex), r in base.items()}
    for name, plan, rnd, ex, toka in FAULT_SETTINGS:
        cfg = _fault_config(rnd, ex, toka)
        key = (rnd, ex, toka)
        if key not in clean:
            clean[key] = SsspEngine.build(shards, SsspConfig(**cfg)).solve(
                sources)
        ref = clean[key]
        fp = FaultPlan(**plan)
        what = (f"faults {label} {name} {rnd} {ex}"
                + ("" if toka == "toka0" else f" {toka}"))
        eng = SsspEngine.build(shards, SsspConfig(**cfg, faults=fp))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        res = eng.solve(sources)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        got = dict(build.LAUNCHES)
        if res.status != "converged" or not res.q_converged.all():
            fail(f"{what}: status {res.status}")
        if not np.array_equal(res.dist, ref.dist):
            fail(f"{what}: distances differ from the fault-free solve")
        rounds = int(res.stats.rounds)
        mine = {k: got[k + sfx] for k in STAGED + ("round",)}
        other = sum(v for k, v in got.items()
                    if k.endswith("_ragged") != ragged)
        if rnd == "fused":
            ok = (mine["round"] == rounds and not mine["merge"]
                  and mine["relax"] >= mine["send"])
        else:
            ok = (mine["relax"] > 0 and mine["send"] > 0
                  and not mine["round"]
                  and (mine["merge"] > 0) != (ex in DENSE_EXCHANGES))
        if not ok or other:
            fail(f"{what}: launches {got} for {rounds} rounds")
        M = shards.block if ex in DENSE_EXCHANGES else P * shards.bucket_cap
        queue = [P, fp.max_delay, K, M]
        say(f"{what}: {rounds} rounds (fault-free {int(ref.stats.rounds)}), "
            f"stale_merges {int(res.stats.stale_merges)}, resends "
            f"{int(res.stats.resends)}, wall {res.wall_s:.4f} s, peak "
            f"{peak / 2**30:.3f} GiB, fault queue {queue} f32 "
            f"{4 * np.prod(queue) / 1e6:.1f} MB; launches {mine}")
        del eng
    say(f"faults phase {label}: K={K}, {len(FAULT_SETTINGS)} faulted "
        f"solves converged, bit-equal to the fault-free solves")
    return clean


def degraded_solve(np, shards, sources, clean, label: str):
    """Heavy drops with no resend (``DEGRADED_PLAN``), all-kernel staged:
    the detector fires over lost improvements and the certificate says
    so. Fails unless the status is ``degraded``, some query is not
    converged, and the distances are at or above the fault-free ones
    everywhere and differ somewhere."""
    from repro_torch.core import FaultPlan, SsspConfig, SsspEngine
    res = SsspEngine.build(shards, SsspConfig(
        **ALL_KERNELS, faults=FaultPlan(**DEGRADED_PLAN))).solve(sources)
    base = clean.dist
    if res.status != "degraded" or res.q_converged.all():
        fail(f"degraded {label}: status {res.status}, q_converged "
             f"{res.q_converged.tolist()}")
    if not (res.dist >= base).all() or np.array_equal(res.dist, base):
        fail(f"degraded {label}: distances below the fixpoint, or equal "
             f"to it")
    say(f"degraded {label} ({DEGRADED_PLAN}, no resend): status degraded, "
        f"{int((~res.q_converged).sum())} of {len(sources)} queries not "
        f"converged, {int((res.dist > base).sum())} distances above the "
        f"fixpoint and none below; {int(res.stats.rounds)} rounds")


def draws_phase(torch):
    """The injector's draws on the card equal the CPU's bit for bit: the
    regime uniforms and the delay slots of a [8, 16, 65536] round (the
    scale-1e7 dense queue's width) under per-shard keys."""
    from repro_torch.core import FaultPlan, prng
    from repro_torch.core.faults import round_keys
    shape = (16, 65536)
    keys = round_keys(FaultPlan(delay=0.4), 7, 8, "cpu")
    got, want = ([prng.uniform(k, shape), prng.randint(s, shape, 0, 3)]
                 for k, s in (prng.split(keys.cuda()), prng.split(keys)))
    for g, w in zip(got, want):
        if not torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)):
            fail("draws: the card's differ from the CPU's")
    say("draws: uniform and randint of [8, 16, 65536] under the per-shard "
        "keys of round 7, card == CPU bit for bit")


def injector_timing(torch, np, shards, sources, card: str):
    """The injector's time a round (``FaultyExchange.deliver``: plain
    PyTorch, the draws included) at the width of ``shards`` under
    a2a_dense, for each plan of the fault matrix, at the state after round
    2 of its faulted solve with a dense incoming row (1% finite) made from
    a numpy seed: CUDA events, median of 20 timings of 2 calls."""
    from repro_torch.core import (FaultPlan, SsspConfig, SsspEngine,
                                  build_pipeline)
    from repro_torch.core.faults import round_keys
    P, K = shards.n_parts, len(sources)
    rng = np.random.default_rng(9)
    for name, plan in FAULT_PLANS.items():
        fp = FaultPlan(**plan)
        eng = SsspEngine.build(shards, SsspConfig(
            **dict(ALL_KERNELS, exchange="a2a_dense"), faults=fp))
        carry = eng.start(sources)
        for _ in range(2):
            carry = eng.round_fn(carry)
        shape = tuple(carry.dist.shape)
        incoming = torch.from_numpy(np.where(
            rng.random(shape) < 0.01, rng.uniform(0, 20, shape),
            np.inf).astype(np.float32)).to(carry.dist.device)
        keys = round_keys(fp, carry.rounds, P, carry.dist.device)
        ex = build_pipeline(eng.shards, eng.cfg).exchange
        ms, mean = timed_median(torch, lambda: ex.deliver(
            eng.shards, carry.dist, incoming, carry.faults, keys), reps=2)
        say(f"injector {name} (a2a_dense, [{P}, {K}, {shape[-1]}] a round, "
            f"queue {list(carry.faults.queue.shape)}): {ms:.4f} ms a round "
            f"(median of 20; mean {mean:.4f}); {card}")
        del eng, carry


@functools.lru_cache(maxsize=1)
def parity_shards():
    """The parity phase's graph and shards: rmat scale 11, P=8, Trishla
    on (one build a process)."""
    from repro_torch.core import build_shards
    from repro_torch.graph import rmat_graph
    gp = rmat_graph(scale=11)
    return gp, build_shards(gp, 8)


def parity_cpu_solve(job):
    """One faulted parity solve on the CPU, in a worker process: ``job`` is
    (name, config, plan, sources); returns (name, QueryResult)."""
    name, cfg, plan, srcs = job
    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    from repro_torch.core import FaultPlan, SsspConfig, SsspEngine
    return name, SsspEngine.build(parity_shards()[1], SsspConfig(
        **cfg, faults=FaultPlan(**plan)), device="cpu").solve(srcs)


def fault_parity(np, shp, srcp, base):
    """Every plan of the fault matrix under bucket, a2a_dense and async
    with toka3, staged (all-kernel) and fused: the card's solve equals the
    CPU's in distances and every counter (stale_merges and resends
    included) and the fault-free solve in distances. The CPU solves run in
    a pool of worker processes while the card solves."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.core import FaultPlan, SsspConfig, SsspEngine
    jobs = [(f"{name} {ex}{' toka3' if ex == 'async' else ''} {rnd}",
             _fault_config(rnd, ex, "toka3" if ex == "async" else "toka0"),
             plan, srcp)
            for name, plan in FAULT_PLANS.items()
            for ex in ("bucket", "a2a_dense", "async")
            for rnd in ("staged", "fused")]
    t0 = time.perf_counter()
    workers = max(1, min(len(jobs), (os.cpu_count() or 2) - 2))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(parity_cpu_solve, job) for job in jobs]
        on_gpu = {name: SsspEngine.build(shp, SsspConfig(
            **cfg, faults=FaultPlan(**plan))).solve(srcs)
            for name, cfg, plan, srcs in jobs}
        on_cpu = dict(f.result() for f in futures)
    for name, _, _, _ in jobs:
        r = on_gpu[name]
        same_results(r, on_cpu[name], f"parity faults {name} (card vs CPU)")
        if r.status != "converged" or not np.array_equal(r.dist, base.dist):
            fail(f"parity faults {name}: status {r.status}, or distances "
                 f"differ from the fault-free solve")
        say(f"parity faults {name}: card == CPU, distances == the "
            f"fault-free solve's, {int(r.stats.rounds)} rounds, "
            f"stale_merges {int(r.stats.stale_merges)}, resends "
            f"{int(r.stats.resends)}")
    say(f"parity faults: {len(jobs)} solves card == CPU in "
        f"{time.perf_counter() - t0:.1f} s ({workers} CPU workers)")


def runner_phase():
    """The port's runner on the card, as a user starts it: ``RUNNER_ARGS``
    staged and with ``--round fused``, the two processes at once. Each must
    exit 0 and validate against Dijkstra; its lines are echoed."""
    t0 = time.perf_counter()
    outs = run_procs({rnd: [sys.executable, "-m", "repro_torch.launch.sssp_run",
                            *RUNNER_ARGS, "--round", rnd]
                      for rnd in ("staged", "fused")})
    for rnd, (rc, out) in outs.items():
        for line in out.splitlines():
            say(f"  runner {rnd} | {line}")
        if rc != 0 or "validation vs Dijkstra (4 queries): OK" not in out:
            fail(f"runner {rnd}: exit {rc}")
    say(f"runner: staged and fused validated on the card "
        f"({time.perf_counter() - t0:.1f} s wall for both)")


def solve_median(eng, sources, what: str, n: int = 5) -> float:
    """The host wall of ``n`` more solves of ``sources``: median, min and
    max, printed; returns the median."""
    walls = [eng.solve(sources).wall_s for _ in range(n)]
    say(f"{what}: median of {n} solves {statistics.median(walls):.4f} s "
        f"(min {min(walls):.4f}, max {max(walls):.4f})")
    return statistics.median(walls)


def many_queries(np, eng, g, what: str, n: int = 300):
    """``n`` sources in one solve (300 ride the bucket of 512: kernels 3-6
    split the queries into groups at the engine's tiles of 128, the fused
    round's rescue too): converged, equal in distances and per-query rounds
    and relaxations to the same sources solved in batches of at most 256,
    and 4 of them equal to scipy's Dijkstra. The sources come from a
    generator of their own, so the other phases draw the sources they drew
    before this check was added."""
    from repro_torch.kernels import build
    sources = live_sources(np, np.random.default_rng(21), g, n)
    build.reset_launches()
    t0 = time.perf_counter()
    res = eng.solve(sources)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    if res.status != "converged" or not res.q_converged.all():
        fail(f"{what} K={n}: status {res.status}")
    parts = [eng.solve(sources[i:i + 256]) for i in range(0, n, 256)]
    if not np.array_equal(np.concatenate([r.dist for r in parts]), res.dist):
        fail(f"{what} K={n}: distances differ from batches of 256")
    for f in ("q_rounds", "q_relaxations"):
        if not np.array_equal(np.concatenate([getattr(r, f) for r in parts]),
                              getattr(res, f)):
            fail(f"{what} K={n}: {f} differs from batches of 256")
    ref = scipy_dijkstra(np, g, sources[:4])
    for i in range(4):
        if not np.allclose(res.dist[i], ref[i], rtol=RTOL, atol=ATOL):
            fail(f"{what} K={n}: source {sources[i]} disagrees with Dijkstra")
    say(f"many queries, {what}: K={n} (bucket {res.bucket_k}) converged in "
        f"{int(res.stats.rounds)} rounds, {wall:.3f} s wall; equal to "
        f"batches of at most 256 in distances, q_rounds and q_relaxations; "
        f"4 match scipy's Dijkstra; launches {launches}")


def check_fused(res_f, res_s, launches, ragged: bool, what: str) -> int:
    """Fail unless the fused solve ``res_f`` converged and equals the
    staged solve ``res_s`` but for n_dispatches (2 vs 4 a round), and its
    launches show the fused path: one fused round a round, no merge, relax
    and send only for rescued rounds (one re-pack each), nothing of the
    other layout family. Returns the rescued rounds."""
    if res_f.status != "converged" or not res_f.q_converged.all():
        fail(f"{what}: status {res_f.status}")
    same_results(res_f, res_s, what, skip=("n_dispatches",))
    rounds = int(res_f.stats.rounds)
    if (int(res_f.stats.n_dispatches) != 2 * rounds
            or int(res_s.stats.n_dispatches) != 4 * int(res_s.stats.rounds)):
        fail(f"{what}: n_dispatches {res_f.stats.n_dispatches} fused, "
             f"{res_s.stats.n_dispatches} staged")
    sfx = "_ragged" if ragged else ""
    rescued = launches["send" + sfx]
    other = sum(v for k, v in launches.items() if k.endswith("_ragged")
                != ragged)
    if (launches["round" + sfx] != rounds or launches["merge" + sfx]
            or launches["relax" + sfx] < rescued or other):
        fail(f"{what}: launches {launches} for {rounds} rounds")
    return rescued


def rounds_of(res) -> str:
    return (f"q_rounds mean {float(res.q_rounds.mean()):.2f} max "
            f"{int(res.q_rounds.max())}, {int(res.stats.rounds)} rounds")


def launched(build, names):
    """The launch counts of ``names`` since the last reset; fails unless
    each is above 0."""
    got = {k: build.LAUNCHES[k] for k in names}
    if min(got.values()) < 1:
        fail(f"a kernel of the path was not launched: {got}")
    return got


def drop_live_chunk(torch, chunks):
    """A planted fault: shard 0's (idx, bounds) list of live chunks with
    the first live chunk of its heaviest tile moved past the live ones,
    so a kernel given the list never reads it."""
    idx, bounds = chunks
    t = int(bounds[0].diff().argmax())
    lo = int(bounds[0, t])
    idx, bounds = idx.clone(), bounds.clone()
    row = idx[0].clone()
    idx[0] = torch.cat([row[:lo], row[lo + 1:], row[lo:lo + 1]])
    bounds[0, t + 1:] -= 1
    return idx, bounds


def warm_state_kernels(torch, np, eng_s, eng_f, sources):
    """Kernels 1 and 7 at the landmark-warm round-0 state, every finitely
    seeded vertex in the frontier: each bit-equal to its plain version,
    timed (medians of 20 x 10 calls), and with a live chunk dropped from
    its list (``drop_live_chunk``) different from it."""
    from repro_torch.core import init_carry
    from repro_torch.kernels.relax import (fixpoint_operands,
                                           relax_dst_tiled_fixpoint_batch,
                                           relax_dst_tiled_fixpoint_batch_plain)
    from repro_torch.kernels.round import (fused_round_operands,
                                           fused_round_tiled,
                                           fused_round_tiled_plain)
    dsh = eng_s.shards
    k = len(sources)
    src = torch.tensor(sources, dtype=torch.int32, device=dsh.device)
    q_valid = torch.ones(k, dtype=torch.bool, device=dsh.device)
    seed = eng_s._warm_stage.seed_stacked(eng_s.landmarks.dist, src, q_valid)
    carry = init_carry(dsh, sources, eng_s.cfg, q_valid=q_valid,
                       seed_dist=seed)
    src_t, w_t, dstrel_t, eid_t = dsh.relax_layout
    r_in = fixpoint_operands(carry.dist, carry.active,
                             carry.pruned[:, :dsh.e_loc], eid_t,
                             src_t.shape[1] * dsh.rx_vb)
    r_args = (*r_in[:2], src_t, w_t, dstrel_t, r_in[2])
    r_kw = dict(vb=dsh.rx_vb, n_sweeps=eng_s.cfg.pallas_sweeps)
    out = relax_dst_tiled_fixpoint_batch(*r_args, **r_kw,
                                         chunks=dsh.relax_chunks)
    ref, plain_ms = once(torch, lambda: relax_dst_tiled_fixpoint_batch_plain(
        *r_args, **r_kw))
    err = compare(torch, "relax (warm round 0)", out, ref)
    ms, _ = timed_median(torch, lambda: relax_dst_tiled_fixpoint_batch(
        *r_args, **r_kw, chunks=dsh.relax_chunks))
    bad = relax_dst_tiled_fixpoint_batch(
        *r_args, **r_kw, chunks=drop_live_chunk(torch, dsh.relax_chunks))
    if all(torch.equal(b, r) for b, r in zip(bad, ref)):
        fail("relax (warm round 0): a dropped live chunk equals the plain "
             "version")
    say(f"  warm round 0, kernel 1: frontier "
        f"{int(carry.active.sum())} of {carry.active.numel()} (query, "
        f"vertex) pairs, {int(out[2].sum())} relaxations, residual rows "
        f"{int((out[1] > 0).any(-1).sum())}; {ms:.4f} ms kernel (median), "
        f"{plain_ms:.2f} ms plain, max abs err {err}; a dropped live chunk "
        f"differs ({int(bad[2].sum())} relaxations)")

    fsh = eng_f.shards
    carry = init_carry(fsh, sources, eng_f.cfg, q_valid=q_valid,
                       seed_dist=seed)
    live = ~carry.done
    ops = fused_round_operands(
        carry.dist, carry.active & live[..., None], live,
        carry.incoming.reshape(*carry.dist.shape[:2], -1), carry.last_sent,
        fsh.slot_valid, fsh.relax_layout, fsh.send_layout, fsh.merge_layout,
        carry.pruned[:, :fsh.e_loc], carry.pruned[:, fsh.e_loc:],
        vb=fsh.rx_vb, sb=fsh.tx_sb, dense=False)
    kw = dict(vb=fsh.rx_vb, sb=fsh.tx_sb, n_sweeps=eng_f.cfg.pallas_sweeps,
              dense=False)
    out = fused_round_tiled(*ops, **kw, chunks=fsh.round_chunks)
    ref, plain_ms = once(torch, lambda: fused_round_tiled_plain(*ops, **kw))
    err = compare(torch, "round (warm round 0)", out, ref)
    ms, _ = timed_median(torch, lambda: fused_round_tiled(
        *ops, **kw, chunks=fsh.round_chunks))
    m_ch, r_ch, s_ch = fsh.round_chunks
    bad = fused_round_tiled(*ops, **kw, chunks=(
        m_ch, drop_live_chunk(torch, r_ch), s_ch))
    if all(torch.equal(b, r) for b, r in zip(bad, ref)):
        fail("round (warm round 0): a dropped live chunk equals the plain "
             "version")
    say(f"  warm round 0, kernel 7: {int(out[4].sum())} relaxations, "
        f"{int(out[5].sum())} sends, residual rows "
        f"{int((out[1] > 0).any(-1).sum())}; {ms:.4f} ms kernel (median), "
        f"{plain_ms:.2f} ms plain, max abs err {err}; a dropped live chunk "
        f"differs ({int(bad[4].sum())} relaxations)")


def engine_phase(torch, np, eng, eng_f, g, sources, res, res_f):
    """The session engine's serving surface on the scale-1e6 dense shards:
    landmark precompute, warm solves against the cold ones (staged and
    fused; kernels 1 and 7 at the warm round-0 state), the result cache,
    ``drain`` of 64 single-source handles, ``warmup``, the legacy wrappers
    and ``certify=False``. ``res``/``res_f``: the cold staged and fused
    K=16 solves of ``sources``."""
    from repro_torch.core import (SsspConfig, SsspEngine, engine_for,
                                  solve_sim, solve_sim_batch)
    from repro_torch.kernels import build
    rng = np.random.default_rng(22)
    sh = eng.shards
    cfg = eng.cfg
    cfg_w = SsspConfig(**ALL_KERNELS, warm_start="landmark")
    # pivots away from the sources, so that no warm source is a cache hit
    piv = live_sources(np, rng, g, 8, avoid=sources)

    # ---- landmarks
    eng_w = SsspEngine.build(sh, cfg_w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm = eng_w.precompute_landmarks(piv)
    torch.cuda.synchronize()
    say(f"engine phase: precompute_landmarks of 8 pivots "
        f"{time.perf_counter() - t0:.4f} s wall, {lm.nbytes_per_shard} B a "
        f"shard ({lm.n_landmarks} x block {sh.block} x 4 B)")

    # ---- warm against cold, staged (kernels 1, 3, 5) and fused (7)
    eng_wf = SsspEngine.build(sh, SsspConfig(round="fused",
                                             warm_start="landmark"))
    eng_wf.precompute_landmarks(piv)
    build.reset_launches()
    res_w = eng_w.solve(sources)
    torch.cuda.synchronize()
    warm_launches = launched(build, STAGED)
    build.reset_launches()
    res_wf = eng_wf.solve(sources)
    torch.cuda.synchronize()
    warm_launches.update(launched(build, ("round",)))
    for what, r, cold, ew, ec in (("staged", res_w, res, eng_w, eng),
                                  ("fused", res_wf, res_f, eng_wf, eng_f)):
        if not r.warm_started or r.status != "converged" or not (
                r.q_converged.all()):
            fail(f"engine warm {what}: status {r.status}, warm_started "
                 f"{r.warm_started}")
        if not np.array_equal(r.dist, cold.dist):
            fail(f"engine warm {what}: distances differ from the cold solve")
        w_med = solve_median(ew, sources, f"  warm {what} K=16")
        c_med = solve_median(ec, sources, f"  cold {what} K=16")
        say(f"  warm {what} K=16: {rounds_of(r)} (cold {rounds_of(cold)}); "
            f"{int(r.stats.relaxations)} relaxations (cold "
            f"{int(cold.stats.relaxations)}); median of 5 walls "
            f"{w_med:.4f} s warm, {c_med:.4f} s cold")
    ref = scipy_dijkstra(np, g, sources[:4])
    for i in range(4):
        if not np.allclose(res_w.dist[i], ref[i], rtol=RTOL, atol=ATOL):
            fail(f"engine warm: source {sources[i]} disagrees with Dijkstra")
    say(f"  warm == cold bit for bit, staged and fused, every query "
        f"converged, 4 match scipy's Dijkstra; launches {warm_launches}")
    warm_state_kernels(torch, np, eng_w, eng_wf, sources)

    # ---- the result cache
    eng_c = SsspEngine.build(sh, cfg_w, result_cache=64)
    eng_c.precompute_landmarks(piv)
    first = eng_c.solve(sources)
    hit = eng_c.solve(sources)
    if (hit.cache_hits != 16 or hit.bucket_k != 0 or hit.q_rounds.any()
            or int(hit.stats.rounds) or not np.array_equal(hit.dist,
                                                           res.dist)
            or not np.array_equal(first.dist, res.dist)):
        fail(f"engine cache: hits {hit.cache_hits}, bucket {hit.bucket_k}, "
             f"q_rounds {hit.q_rounds.tolist()}")
    new8 = live_sources(np, rng, g, 8, avoid=list(sources) + piv)
    mixed = eng_c.solve(sources[:8] + new8)
    cold8 = eng.solve(new8)
    if (mixed.cache_hits != 8 or mixed.bucket_k != 8
            or not np.array_equal(mixed.dist[8:], cold8.dist)
            or not np.array_equal(mixed.dist[:8], res.dist[:8])):
        fail(f"engine cache: mixed batch hits {mixed.cache_hits}, bucket "
             f"{mixed.bucket_k}")
    say(f"  cache: 16 hits in {hit.wall_s:.5f} s wall (0 rounds, bucket 0; "
        f"the filling warm solve {first.wall_s:.4f} s); 8 cached + 8 new "
        f"rode bucket {mixed.bucket_k} in {mixed.wall_s:.4f} s, equal to a "
        f"cold solve of the 8 ({cold8.wall_s:.4f} s)")

    # ---- drain: 64 single-source handles, max_bucket 16
    srcs64 = live_sources(np, rng, g, 64)
    eng_d = SsspEngine.build(sh, cfg, max_bucket=16)
    eng_d.warmup(16)
    served = eng_d.batches_served
    handles = [eng_d.submit(s) for s in srcs64]
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng_d.drain()
    wall = time.perf_counter() - t0
    drain_launches = launched(build, STAGED)
    if (len(out) != 64 or eng_d.batches_served - served != 4
            or eng_d.pending or {r.bucket_k for r in out} != {16}):
        fail(f"engine drain: {len(out)} results, "
             f"{eng_d.batches_served - served} batches, buckets "
             f"{sorted({r.bucket_k for r in out})}")
    for h, s in zip(handles, srcs64):
        one = eng.solve([s])
        r = h.result()
        if not (np.array_equal(r.dist, one.dist)
                and np.array_equal(r.q_rounds, one.q_rounds)
                and np.array_equal(r.q_relaxations, one.q_relaxations)
                and r.status == "converged"):
            fail(f"engine drain: source {s} differs from its own solve")
    say(f"  drain: 64 single-source handles in 4 batches of 16, "
        f"{wall:.4f} s, {64 / wall:.1f} queries/s; each equal to a K=1 "
        f"solve of its source; launches {drain_launches}")

    # ---- warm-up, the wrappers, certify=False
    eng_u = SsspEngine.build(sh, cfg)
    a, b = eng_u.warmup(16), eng_u.warmup(16)
    if not (a > 0 and b == 0.0) or eng_u.trace_counts != {16: 1}:
        fail(f"engine warmup: {a}, then {b}; {eng_u.trace_counts}")
    solve_sim_batch(sh, sources[:2], cfg)
    wrap = engine_for(sh, cfg)
    counts = [dict(wrap.trace_counts)]
    solve_sim_batch(sh, sources[2:4], cfg)
    d1, _ = solve_sim(sh, sources[4], cfg)
    counts.append(dict(wrap.trace_counts))
    solve_sim(sh, sources[5], cfg)
    counts.append(dict(wrap.trace_counts))
    if counts != [{2: 1}, {2: 1, 1: 1}, {2: 1, 1: 1}] or not np.array_equal(
            d1, res.dist[4]) or engine_for(sh, cfg) is not wrap:
        fail(f"engine wrappers: trace counts {counts}")
    nc = SsspEngine.build(sh, cfg, certify=False).solve(sources)
    nc2 = SsspEngine.build(sh, SsspConfig(**ALL_KERNELS, max_rounds=2),
                           certify=False).solve(sources)
    if (not nc.q_converged.all() or nc.status != "converged"
            or not np.array_equal(nc.dist, res.dist)
            or nc2.q_converged.any() or nc2.status != "max_rounds"):
        fail(f"engine certify=False: {nc.status}, {nc2.status}")
    say(f"  warmup(16) {a:.4f} s, then {b}; solve_sim_batch/solve_sim on "
        f"one engine, trace counts {counts[-1]}; certify=False reports the "
        f"detector (converged; max_rounds=2 gives {nc2.status})")


def single_phase(torch, np, g, rng, out_dir: Path):
    """The standalone kernel API's single-query relax kernels (9, 10, 11)
    on the whole graph ``g`` as one block: three single-source solves of
    two sources, checked against scipy's Dijkstra and each other; each
    kernel bit-equal to its plain version at one mid-solve state, timed
    beside its bound. Returns the table rows."""
    from repro_torch.graph import graph_to_numpy
    from repro_torch.kernels import build
    from repro_torch.kernels.common import live_chunks, take_fill
    from repro_torch.kernels.relax import relax as relax_mod
    from repro_torch.kernels.relax import (
        build_dst_tiled_layout, relax_dst_tiled, relax_dst_tiled_fixpoint,
        relax_dst_tiled_fixpoint_plain, relax_dst_tiled_masked,
        relax_dst_tiled_masked_plain, relax_dst_tiled_plain,
        relax_fixpoint_pallas, relax_jnp, relax_masked_pallas, relax_pallas)
    dev = torch.device("cuda")
    vb, eb, inf = 128, 512, float("inf")
    n = g.n_vertices
    edges = graph_to_numpy(g)
    t0 = time.perf_counter()
    src_t, w_t, dr_t, eid_t, bp = build_dst_tiled_layout(
        *edges, n, vb=vb, eb=eb, with_eid=True)
    t_lay = time.perf_counter() - t0
    cpu_lay = (src_t, w_t, dr_t)
    lay = tuple(a.to(dev) for a in cpu_lay)
    eid = eid_t.to(dev)
    m = len(edges[0])
    # Trishla masks: none (the solves), and 10% drawn from a seed (the
    # kernel comparisons)
    pr0 = torch.zeros(eid.shape, dtype=torch.int32, device=dev)
    p10 = torch.from_numpy((np.random.default_rng(14).random(m) < 0.1)
                           .astype(np.int32)).to(dev)
    pr10 = take_fill(p10, eid.reshape(-1), 0).reshape(eid.shape)
    sources = live_sources(np, rng, g, 2)
    kw = dict(vb=vb, eb=eb)
    # the live chunks kernels 10 and 11 walk, derived once for the layout,
    # as a caller that sweeps it many times does
    chunks = live_chunks(lay[1][None] < inf)
    say(f"single phase: scale-1e6 as one block, {n} vertices, {m} edges; "
        f"layout {tuple(src_t.shape)}, block_pad {bp}, host build "
        f"{t_lay:.1f} s; sources {sources}")

    def start(s, device):
        d = torch.full((bp,), inf, device=device)
        f = torch.zeros(bp, device=device)
        d[s], f[s] = 0.0, 1.0
        return d, f

    def solve9(s):
        """Kernel 9 in a residual-frontier loop (tests/test_pallas_solver.py
        :84-98)."""
        d, f = start(s, dev)
        rel = 0
        while bool((f > 0).any()):
            d, f, nr = relax_fixpoint_pallas(d, f, *lay, pr0, n_sweeps=8,
                                             **kw)
            rel += int(nr)
        return d, rel

    def solve10(s, device=dev, layout=lay, pruned=pr0, until=None,
                live=chunks):
        """Kernel 10 with the frontier chased between launches; ``until``
        stops after that many steps."""
        d, f = start(s, device)
        rel = steps = 0
        while bool((f > 0).any()) and steps != until:
            new, nr = relax_masked_pallas(d, f, *layout, pruned, chunks=live,
                                          **kw)
            f, d = (new < d).float(), new
            rel += int(nr)
            steps += 1
        return d, rel, f

    def solve11(s):
        """Kernel 11 until a sweep changes nothing (no count)."""
        d = start(s, dev)[0]
        while True:
            new = relax_pallas(d, *lay, chunks=chunks, **kw)
            if torch.equal(new, d):
                return d, None
            d = new

    ref = scipy_dijkstra(np, g, sources)
    solved, launches, rows = {}, {}, {}
    for name, solve in (("relax_single", solve9), ("relax_masked", solve10),
                        ("relax_sweep", solve11)):
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        solved[name], per = [], []
        for s in sources:
            k0 = build.LAUNCHES[name]
            solved[name].append(solve(s)[:2])
            per.append(build.LAUNCHES[name] - k0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = build.LAUNCHES[name]
        if min(per) < 1 or sum(build.LAUNCHES.values()) != launches[name]:
            fail(f"single {name}: launches {build.LAUNCHES}")
        for i, (d, _) in enumerate(solved[name]):
            if not np.allclose(d[:n].cpu().numpy(), ref[i], rtol=RTOL,
                               atol=ATOL):
                fail(f"single {name}: source {sources[i]} disagrees with "
                     f"Dijkstra")
        rels = [r for _, r in solved[name] if r is not None]
        say(f"  {name} solves: {wall:.3f} s wall for {len(sources)} sources, "
            f"launches per solve {per}"
            + (f", relaxations {rels}" if rels else ""))
    for name in ("relax_masked", "relax_sweep"):
        for (a, _), (b, _) in zip(solved["relax_single"], solved[name]):
            if not torch.equal(a, b):
                fail(f"single: the {name} solve differs from relax_single's")
    t0 = time.perf_counter()
    cpu_rel = [solve10(s, torch.device("cpu"), cpu_lay, pr0.cpu(),
                       live=None)[1] for s in sources]
    if cpu_rel != [r for _, r in solved["relax_masked"]]:
        fail(f"single: relax_masked relaxations {solved['relax_masked']} vs "
             f"{cpu_rel} with the plain version on the CPU")
    say(f"  the three solves bit-equal, equal to scipy's Dijkstra; "
        f"relax_masked relaxations equal to the plain loop on the CPU "
        f"({time.perf_counter() - t0:.1f} s)")

    # each kernel against its plain version at one mid-solve state: three
    # masked steps from the first source, the 10% Trishla mask
    d, _, f = solve10(sources[0], until=3)
    if not bool((f > 0).any()):
        fail("single: the mid-solve frontier is empty")
    args9 = (d, f, *lay, pr10)
    out11 = relax_dst_tiled(d, *lay, vb=vb, chunks=chunks)
    ref11, plain11 = once(torch, lambda: relax_dst_tiled_plain(d, *lay,
                                                               vb=vb))
    out10 = relax_dst_tiled_masked(*args9, vb=vb, chunks=chunks)
    ref10, plain10 = once(torch, lambda: relax_dst_tiled_masked_plain(
        *args9, vb=vb))
    # the same two launches with the entry point's pre-pass, and with a
    # list that drops one live chunk (the planted fault: must differ)
    compare(torch, "relax_sweep (pre-pass)", [relax_dst_tiled(d, *lay,
                                                              vb=vb)], [ref11])
    compare(torch, "relax_masked (pre-pass)",
            relax_dst_tiled_masked(*args9, vb=vb), ref10)
    idx, bounds = chunks
    t = int(bounds[0].diff().argmax())
    lo = int(bounds[0, t])
    bad = (torch.cat([idx[:, :lo], idx[:, lo + 1:], idx[:, lo:lo + 1]], 1),
           bounds.clone())
    bad[1][0, t + 1:] -= 1
    if (torch.equal(relax_dst_tiled(d, *lay, vb=vb, chunks=bad), ref11)
            or all(torch.equal(a, b) for a, b in zip(
                relax_dst_tiled_masked(*args9, vb=vb, chunks=bad), ref10))):
        fail("single: kernels 10 and 11 with a live chunk dropped from "
             "their list equal their plain versions")
    say(f"  relax_sweep, relax_masked: bit-equal with the live chunks and "
        f"with the pre-pass; with chunk {int(idx[0, lo])} (tile {t}, "
        f"{int(bounds[0, t + 1]) - lo} live chunks) dropped from the list "
        f"both differ (the planted fault)")
    out9 = relax_dst_tiled_fixpoint(*args9, vb=vb, n_sweeps=2)
    ref9, plain9 = once(torch, lambda: relax_dst_tiled_fixpoint_plain(
        *args9, vb=vb, n_sweeps=2))
    errs = {"relax_sweep": compare(torch, "relax_sweep", [out11], [ref11]),
            "relax_masked": compare(torch, "relax_masked", out10, ref10),
            "relax_single": compare(torch, "relax_single", out9, ref9)}
    live = int((torch.isfinite(lay[1])).sum())
    n_live = int(chunks[1][0, -1])
    n_all = lay[0].shape[0] * lay[0].shape[1]
    # kernels 10 and 11 timed three ways, with the layout's live chunks (the
    # route of the table's rows) and with the pre-pass; a row's time is the
    # device time a call (median of the three runs), its bound the bytes of
    # the rows, the live chunks' planes and the list (the pre-pass's also
    # the weights in full), or the operations (an add and a min per live
    # edge, per counted relaxation for kernel 10)
    runs = three_way(torch, {
        "kernel 11": lambda: relax_dst_tiled(d, *lay, vb=vb, chunks=chunks),
        "kernel 10": lambda: relax_dst_tiled_masked(*args9, vb=vb,
                                                    chunks=chunks),
        "kernel 11 pre-pass": lambda: relax_dst_tiled(d, *lay, vb=vb),
        "kernel 10 pre-pass": lambda: relax_dst_tiled_masked(*args9, vb=vb)},
        out_dir)
    med = {name: {k: statistics.median(r[k] for r in rs)
                  for k in ("events", "device", "host")}
           for name, rs in runs.items()}
    list_bytes = nbytes(chunks[1]) + n_live * chunks[0].element_size()
    dead_w = (n_all - n_live) * lay[1].shape[-1] * lay[1].element_size()
    for name, key, n_bytes, n_ops, plain_ms in (
            ("kernel 11", "relax_sweep",
             nbytes(d, out11) + live_bytes(lay, n_live) + list_bytes,
             2 * live, plain11),
            ("kernel 10", "relax_masked",
             nbytes(d, f, *out10) + live_bytes((*lay, pr10), n_live)
             + list_bytes, 2 * int(out10[1]), plain10)):
        m, mp = med[name], med[name + " pre-pass"]
        rows[key] = dict(ms=m["device"], plain_ms=plain_ms,
                         bound=bound(n_bytes, n_ops))
        say(f"  {name}: medians of three runs, with the live chunks: events "
            f"{m['events']:.4f} ms, device {m['device']:.4f} ms a call, host "
            f"{m['host']:.4f} ms a call, bound {rows[key]['bound'][0]:.5f} "
            f"ms ({rows[key]['bound'][1]}); with the pre-pass: events "
            f"{mp['events']:.4f} ms, device {mp['device']:.4f} ms a call, "
            f"host {mp['host']:.4f} ms a call, bound "
            f"{bound(n_bytes + dead_w, n_ops)[0]:.5f} ms (the weights read "
            f"in full)")
    say(f"  relax_single live chunks: {n_live} of {n_all} (chain steps a "
        f"sweep: {n_live}, the whole layout {n_all})")
    ms9, mean9 = timed_median(
        torch, lambda: relax_dst_tiled_fixpoint(*args9, vb=vb, n_sweeps=2))
    # the bytes it needs: the rows, the weights in full (which chunks are
    # live) and the other planes over the live chunks
    rows["relax_single"] = dict(
        ms=ms9, mean_ms=mean9, plain_ms=plain9,
        bound=bound(nbytes(d, f, lay[1], *out9)
                    + live_bytes((lay[0], lay[2], pr10), n_live),
                    2 * int(out9[2])))
    planted_hazard_fault(
        torch, "relax_single",
        lambda: ((lambda **f: relax_mod._launch_single(
            *args9, vb=vb, n_sweeps=2, **f)), ref9),
        lambda: path_case(torch, np, dev, "dense")[0])
    ms8 = timed(torch, lambda: relax_dst_tiled_fixpoint(*args9, vb=vb,
                                                        n_sweeps=8), 3)
    flat = [torch.from_numpy(a).to(dev) for a in edges]
    jnp_ms = timed(torch, lambda: relax_jnp(d[:n], *flat), 50)
    say(f"  kernels bit-equal to their plain versions at the state after 3 "
        f"masked steps (frontier {int((f > 0).sum())} vertices; "
        f"relax_masked {int(out10[1])} relaxations; relax_single with "
        f"n_sweeps=2 for the plain version's time, {int(out9[2])} "
        f"relaxations, residual {int((out9[1] > 0).sum())})")
    for name, r in rows.items():
        r.update(err=errs[name], library_ms=None)
        say(f"  {name}: {r['ms']:.4f} ms kernel"
            + (f" (median; mean {r['mean_ms']:.4f})" if "mean_ms" in r
               else "")
            + f", {r['plain_ms']:.2f} ms plain, bound {r['bound'][0]:.5f} ms "
            f"({r['bound'][1]}), {launches[name]} launches for "
            f"{len(sources)} solves")
    say(f"  relax_single with n_sweeps=8: {ms8:.4f} ms; relax_jnp (gather + "
        f"scatter_reduce amin over the {m} flat edges): {jnp_ms:.4f} ms")
    return rows, launches


def embag_phase(torch, np):
    """Kernel 13 at the AutoInt configuration's full size: a [39e6, 16]
    table made on the card from a seeded generator, the serve_bulk batch
    of one-hot bags (sum) and a train batch of 4-index bags (mean, f32 and
    bf16), 5% of the indices the padding sentinel V and 5% negative (in
    [-V, 0), wrapping to row V + i). Each run bit-equal to the plain
    version, timed beside its bound and F.embedding_bag (given the wrapped
    indices)."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import (embedding_bag_p,
                                                   embedding_bag_p_plain)
    dev = torch.device("cuda")
    V, D = AUTOINT["fields"] * AUTOINT["vocab"], AUTOINT["dim"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    table = torch.randn((V, D), generator=gen, device=dev)

    def bags(B, L):
        idx = torch.randint(0, V, (B, L), generator=gen, device=dev,
                            dtype=torch.int32)
        u = torch.rand((B, L), generator=gen, device=dev)
        idx = torch.where(u < 0.05, idx - V, idx)   # [-V, 0): wraps to idx
        return torch.where(u > 0.95, V, idx).to(torch.int32).contiguous()

    runs = (("serve sum", table, bags(SERVE_BULK * AUTOINT["fields"], 1),
             "sum"),)
    multi = bags(TRAIN_BATCH * AUTOINT["fields"], 4)
    runs += (("multi-hot mean f32", table, multi, "mean"),
             ("multi-hot mean bf16", table.to(torch.bfloat16), multi,
              "mean"))
    build.reset_launches()
    outs = [embedding_bag_p(t, i, mode=mode) for _, t, i, mode in runs]
    torch.cuda.synchronize()
    launches = build.LAUNCHES["embedding_bag"]
    if launches != len(runs) or sum(build.LAUNCHES.values()) != launches:
        fail(f"embag: launches {build.LAUNCHES}")
    say(f"embag phase: table [{V}, {D}] f32 on the card, AutoInt "
        f"({AUTOINT['fields']} fields x {AUTOINT['vocab']} vocab)")
    stats = {}
    for (what, t, i, mode), out in zip(runs, outs):
        ref, plain_ms = once(torch, lambda: embedding_bag_p_plain(t, i,
                                                                  mode=mode))
        err = compare(torch, "embedding_bag", [out], [ref])
        ms = timed(torch, lambda: embedding_bag_p(t, i, mode=mode), 20)
        valid = i[(i >= -V) & (i < V)] % V
        rows_read = int(torch.unique(valid).numel())
        b = bound(nbytes(i, out) + rows_read * D * t.element_size(),
                  int(valid.numel()) * D + (out.numel() if mode == "mean"
                                            else 0))
        ext = torch.cat([t, torch.zeros((1, D), dtype=t.dtype, device=dev)])
        il = torch.where(i < 0, i + V, i).long()   # F.embedding_bag: >= 0
        lib_ms = timed(torch, lambda: F.embedding_bag(
            il, ext, mode=mode, padding_idx=V), 20)
        lib = F.embedding_bag(il, ext, mode=mode, padding_idx=V)
        lib_err = float((lib.float() - out.float()).abs().max())
        del ext, il, lib
        say(f"  {what}: bags {tuple(i.shape)}, {int(valid.numel())} valid "
            f"rows ({rows_read} distinct); {ms:.4f} ms kernel, "
            f"{plain_ms:.3f} ms plain, bound {b[0]:.5f} ms ({b[1]}), "
            f"F.embedding_bag {lib_ms:.4f} ms (max abs diff {lib_err:.3g})")
        stats[what] = dict(ms=ms, plain_ms=plain_ms, bound=b,
                           library_ms=lib_ms, err=err)
    # the table's row: the 4-index f32 bags; the error: the largest of all
    row = dict(stats["multi-hot mean f32"],
               err=max(r["err"] for r in stats.values()))
    return {"embedding_bag": row}, {"embedding_bag": launches}


def bf16_ulps(torch, got, want) -> float:
    """Largest elementwise |got - want| in bf16 ulps of |want|, an ulp
    being at least 5e-6 (for values near 0)."""
    w = want.float().abs()
    ulp = torch.exp2(torch.frexp(w)[1].float() - 8)
    ulp = torch.where(w > 0, ulp, 0.0).clamp(min=5e-6)
    return float(((got.float() - want.float()).abs() / ulp).max())


def causal_pairs(Sq: int, Skv: int, q_offset: int) -> int:
    """(query, key) pairs a causal mask with ``q_offset`` leaves valid in one
    head: row i sees keys 0 .. i + q_offset, at most Skv of them."""
    return sum(max(0, min(Skv, i + q_offset + 1)) for i in range(Sq))


def flash_phase(torch):
    """Kernel 12 through its entry point against its plain version on the
    card: the prefill shapes of the three dense LM configs and gemma's
    decode shape (Sq = 1 against the padded cache, q_offset = Skv - 1),
    causal, each in bf16 (the bf16 kernel, 2 bf16 ulps) and f32 (the 3xTF32
    kernel, 2e-5), each launch on its own route; timed beside its bound and
    F.scaled_dot_product_attention (f32: both as medians). Then two planted
    faults at gemma's shape must fail their checks: the bf16 kernel with its
    P_lo products dropped, and the f32 kernel with its lo products dropped
    (one TF32 product). Returns the table rows at gemma's prefill shape:
    bf16 (the main path's) and f32."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        _launch_f32, _launch_tc, flash_attention_p_plain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    runs = [(arch, dt, B, Hq, Hkv, S, S, D, 0)
            for arch, (B, Hq, Hkv, S, D) in FLASH_SHAPES.items()
            for dt in ("bfloat16", "float32")]
    B, H, _, S, D = FLASH_SHAPES[SERVE["arch"]]
    skv = S + SERVE["gen"]
    runs += [(f"{SERVE['arch']} decode", dt, B, H, H, 1, skv, D, skv - 1)
             for dt in ("bfloat16", "float32")]
    route = {"bfloat16": "flash_attention_tc", "float32": "flash_attention"}
    say("flash phase: kernel 12 vs its plain version (block 128, causal)")

    def pad(t, b):
        return F.pad(t, (0, 0, 0, (-t.shape[2]) % b))

    rows = {}
    for name, dt, B, Hq, Hkv, Sq, Skv, D, off in runs:
        dtype = getattr(torch, dt)
        q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((B, Hkv, Skv, D), generator=gen, device=dev)
                .to(dtype) for _ in range(2))
        bq, bk = min(128, Sq), min(128, Skv)
        kw = dict(causal=True, q_offset=off, block_q=bq)
        build.reset_launches()
        out = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        if {n: c for n, c in build.LAUNCHES.items() if c} != {route[dt]: 1}:
            fail(f"flash {name} {dt}: launches {build.LAUNCHES}, want one "
                 f"{route[dt]}")
        ref, plain_ms = once(torch, lambda: flash_attention_p_plain(
            pad(q, bq), pad(k, bk), pad(v, bk), scale=D ** -0.5, causal=True,
            q_offset=off, kv_len=Skv, block_q=bq, block_k=bk)[:, :, :Sq])
        err = float((out.float() - ref.float()).abs().max())
        ulps = bf16_ulps(torch, out, ref) if dt == "bfloat16" else None
        if not (bool(torch.isfinite(out).all()) and (
                err <= FLASH_F32_TOL if ulps is None
                else ulps <= FLASH_BF16_ULPS)):
            fail(f"flash {name} {dt}: kernel vs plain max abs err {err}"
                 f" ({ulps} bf16 ulps)")
        # the same function: top-left causal when Sq == Skv, none in decode
        lib = dict(is_causal=Sq == Skv, enable_gqa=Hq != Hkv)

        def kernel_call():
            return flash_attention(q, k, v, **kw)

        def sdpa_call():
            return F.scaled_dot_product_attention(q, k, v, **lib)

        if dt == "float32":
            ms, lib_ms = (timed_median(torch, fn)[0]
                          for fn in (kernel_call, sdpa_call))
        else:
            ms, lib_ms = (timed(torch, fn, 5) for fn in (kernel_call,
                                                         sdpa_call))
        lib_err = float((sdpa_call().float() - out.float()).abs().max())
        ops = 4 * B * Hq * D * causal_pairs(Sq, Skv, off)
        if dt == "bfloat16":
            b = bound(nbytes(q, k, v, out), ops, BF16_OPS_PER_S)
            bounds = f"bound {b[0]:.5f} ms ({b[1]})"
        else:   # 3xTF32: three TF32 products for each f32 one
            b = bound(nbytes(q, k, v, out), 3 * ops, TF32_OPS_PER_S)
            b_f32 = bound(nbytes(q, k, v, out), ops)
            bounds = (f"bound {b[0]:.5f} ms in 3xTF32 ({b[1]}), "
                      f"{b_f32[0]:.5f} ms on the f32 CUDA cores")
        say(f"  {name} {dt} q {tuple(q.shape)} kv {tuple(k.shape)}, "
            f"{route[dt]}: {ms:.4f} ms kernel"
            + (" (median)" if dt == "float32" else "")
            + f", {plain_ms:.3f} ms plain, {bounds}, {ops / 1e9:.2f} GFLOP, "
            f"SDPA {lib_ms:.4f} ms; max abs err {err:.3g}"
            + (f" ({ulps:.3g} bf16 ulps)" if ulps is not None else "")
            + f" (SDPA vs kernel {lib_err:.3g})")
        if name == SERVE["arch"]:
            rows[route[dt]] = dict(err=err, ms=ms, plain_ms=plain_ms,
                                   bound=b, library_ms=lib_ms)
            # the planted faults: P_lo dropped (p rounded to bf16 alone), or
            # the f32 kernel's lo products dropped (one TF32 product)
            bad = torch.empty_like(q)
            fault = dict(scale=D ** -0.5, causal=True, q_offset=0,
                         kv_len=Skv)
            if dt == "bfloat16":
                _launch_tc(q, k, v, bad, split_p=False, **fault)
                miss = bf16_ulps(torch, bad, ref)
                say(f"  planted fault (P_lo dropped) at {name}: {miss:.4g} "
                    f"bf16 ulps (tolerance {FLASH_BF16_ULPS})")
                caught = miss > FLASH_BF16_ULPS
            else:
                _launch_f32(q, k, v, bad, split=False, **fault)
                miss = float((bad - ref).abs().max())
                say(f"  planted fault (1xTF32, lo products dropped) at "
                    f"{name}: max abs err {miss:.4g} (tolerance "
                    f"{FLASH_F32_TOL})")
                caught = miss > FLASH_F32_TOL
            if not caught:
                fail(f"flash: the {dt} check passes the planted fault "
                     f"({miss})")
            del bad
        del q, k, v, out, ref
    return rows


def _to(tree, device):
    """A tree of tensors (nested dicts, lists, tuples) moved to
    ``device``."""
    from repro_torch.models.params import tree_leaves, tree_unflatten
    return tree_unflatten(tree, [t.to(device) for t in tree_leaves(tree)])


def serve_run(torch, cfg, params, prompts, G: int) -> dict:
    """The serving main path as examples/serve_decode.py drives it: a
    warm-up prefill of 128 tokens, then the prefill of ``prompts`` [B, P]
    (make_prefill_step), the caches padded by ``G`` and ``G`` greedy steps
    of make_serve_step with the caches donated, the launch counters set to
    0 before each part and read after it. Returns the step functions, the
    prefill's last logits, the last step's logits and token, the tokens
    [B, G + 1], the caches, the prefill's and the decode's walls (s), the
    decode steps between CUDA events (ms, sorted), the launches of each
    part and the peak allocated bytes."""
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    P = prompts.shape[1]
    prefill = tf.make_prefill_step(cfg)
    serve = tf.make_serve_step(cfg, donate=True)   # caches written in place
    prefill(params, {"tokens": prompts[:, :128]})   # warm-up: library loads
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    build.reset_launches()
    t0 = time.perf_counter()
    logits, kvs = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    in_prefill = dict(build.LAUNCHES)
    caches = tuple(F.pad(t, (0, 0, 0, 0, 0, G)) for t in kvs)
    del kvs
    tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
    toks = [tok]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(G + 1)]
    build.reset_launches()
    t0 = time.perf_counter()
    marks[0].record()
    for i in range(G):
        last, caches = serve(params, tok, caches, P + i)
        tok = last.argmax(dim=-1)[:, None].to(torch.int32)
        toks.append(tok)
        marks[i + 1].record()
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    return dict(prefill=prefill, serve=serve, logits=logits, last=last,
                tok=tok, out=torch.cat(toks, dim=1), caches=caches,
                ttft=ttft, t_dec=t_dec,
                steps=sorted(a.elapsed_time(b)
                             for a, b in zip(marks, marks[1:])),
                in_prefill=in_prefill, in_decode=dict(build.LAUNCHES),
                peak=torch.cuda.max_memory_allocated())


def check_serve(torch, cfg, r: dict, B: int, P: int, G: int, label: str):
    """Fail unless ``serve_run``'s prefill launched kernel 12's bf16 route
    once a layer and nothing else, its decode launched no kernel, and its
    outputs are finite tokens and caches of the expected shapes; then print
    the times, rates and peak memory."""
    n_fa = r["in_prefill"]["flash_attention_tc"]
    if n_fa != cfg.n_layers or sum(r["in_prefill"].values()) != n_fa:
        fail(f"{label}: prefill launches {r['in_prefill']}, want "
             f"flash_attention_tc {cfg.n_layers} and nothing else")
    if sum(r["in_decode"].values()):
        fail(f"{label}: decode launched kernels {r['in_decode']}")
    out, steps = r["out"], r["steps"]
    if (tuple(out.shape) != (B, G + 1)
            or not bool(torch.isfinite(r["logits"]).all())
            or not bool(torch.isfinite(r["last"]).all())
            or not bool(((out >= 0) & (out < cfg.vocab_size)).all())
            or tuple(r["caches"][0].shape) != (cfg.n_layers, B, P + G,
                                               cfg.n_kv_heads, cfg.hd)):
        fail(f"{label}: bad outputs {tuple(out.shape)} "
             f"{r['caches'][0].shape}")
    say(f"  prefill (time to first token) {r['ttft']:.4f} s, "
        f"{B * P / r['ttft']:.1f} prompt tokens/s; decode "
        f"{1e3 * r['t_dec'] / G:.3f} ms/step, {B * G / r['t_dec']:.1f} "
        f"tokens/s (steps between CUDA events: median {steps[G // 2]:.3f}, "
        f"min {steps[0]:.3f}, max {steps[-1]:.3f} ms); peak allocated "
        f"{r['peak']} B; flash_attention_tc launches {n_fa} in the prefill, "
        f"{sum(r['in_decode'].values())} kernel launches in decode")


def attention_vs_xla(torch, cfg, prefill, params, prompts):
    """The prefill's last logits, and each layer's attention() against the
    xla path on the same q, k, v, in bf16 ulps (a list, one a layer)."""
    from repro_torch.models import transformer as tf
    real_attn = tf.attention
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    ulps = []

    def checked(q, k, v, c, **kw):
        out = real_attn(q, k, v, c, **kw)
        ulps.append(bf16_ulps(torch, out, real_attn(q, k, v, cfg_x, **kw)))
        return out

    tf.attention = checked
    try:
        logits = prefill(params, {"tokens": prompts})[0]
    finally:
        tf.attention = real_attn
    return logits, ulps


def serve_phase(torch, np, out_dir: Path):
    """The transformer's main path: full-width gemma-7b in bf16 with
    attn_impl="pallas", weights made on the card from a seeded generator;
    4 random prompts of 2048 tokens through make_prefill_step, the caches
    padded by 32, then 32 greedy steps of make_serve_step with the caches
    donated, as examples/serve_decode.py drives them. Kernel 12's
    tensor-core kernel must launch once a layer in the prefill, and nothing
    else, and no kernel in decode. Then the checks: the prefill's last
    logits with "pallas" against "xla" at full width in bf16, and each
    layer's attention against "xla" on the same inputs, which must also
    catch a planted fault; full-width gemma at depth 4 in f32, forward over
    256 tokens against a prefill of 252 and 4 decode steps (rtol = atol =
    2e-3), whose forward and prefill must launch kernel 12's f32 route once
    a layer each; the three smoke configs' forward on the card (kernel)
    against the CPU (plain), f32 logits within 1e-4. Returns the launches
    of both routes' runs."""
    import torch.nn.functional as F
    from repro_torch.configs.registry import _load
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    dev = torch.device("cuda")
    cfg = dataclasses.replace(_load(SERVE["arch"])[1], attn_impl="pallas")
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SERVE["seed"])
    t0 = time.perf_counter()
    params = materialize(tf.param_defs(cfg), gen, device=dev,
                         default_dtype=cfg.dtype)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(nbytes(t) for t in (params["embed"], params["final_norm"],
                                      params["unembed"],
                                      *params["layers"].values()))
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                            device=dev, dtype=torch.int32)
    say(f"serve phase: {cfg.name} {cfg.n_params()} params ({w_bytes} B "
        f"bf16) made on the card in {t_init:.1f} s; {B} prompts x {P} "
        f"tokens, {G} greedy steps, attn_impl={cfg.attn_impl}")
    r = serve_run(torch, cfg, params, prompts, G)
    check_serve(torch, cfg, r, B, P, G, "serve")
    prefill, serve = r["prefill"], r["serve"]
    logits, last, caches, tok = r["logits"], r["last"], r["caches"], r["tok"]
    out, n_fa = r["out"], r["in_prefill"]["flash_attention_tc"]
    again = []
    for _ in range(2):      # the spread of the prefill time
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        again.append(time.perf_counter() - t0)
    say(f"  prefill again: {', '.join(f'{t:.4f}' for t in again)} s")
    say(f"  greedy tokens of prompt 0: {out[0, :12].tolist()} ...")
    profile_run(torch, lambda: prefill(params, {"tokens": prompts}),
                out_dir / "chip_smoke_trace_prefill.json",
                f"{cfg.name} prefill {B}x{P}")
    profile_run(torch, lambda: [serve(params, tok, caches, P + G - 1)
                                for _ in range(4)],
                out_dir / "chip_smoke_trace_decode.json",
                f"{cfg.name} 4 decode steps")

    # (b) the kernel path against materialized scores, full width, bf16
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    lx = tf.make_prefill_step(cfg_x)(params, {"tokens": prompts})[0]
    diff = float((logits - lx).abs().max())
    top = float(lx.abs().max())
    agree = float((logits.argmax(-1) == lx.argmax(-1)).float().mean())
    say(f"  pallas vs xla prefill, last logits: max abs diff {diff:.4g}, "
        f"largest |logit| {top:.4g} (ratio {diff / top:.4g}, tolerance "
        f"{PALLAS_VS_XLA_REL}); greedy tokens agree {agree:.2f}")
    if not diff <= PALLAS_VS_XLA_REL * top:
        fail(f"serve: pallas vs xla prefill logits differ by {diff}")
    if agree < 1.0:
        fail(f"serve: pallas vs xla greedy tokens agree {agree:.2f}, not 1")
    # per layer: attention() through kernel 12 against the xla path on the
    # main path's own q, k, v (2 bf16 ulps, as in the flash phase); then the
    # same with a planted fault, the kernel's last kv tile dropped, which
    # this check must catch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    real_p = fa_ops.flash_attention_p

    def short(q, k, v, *, kv_len, block_k, **kw):
        return real_p(q, k, v, kv_len=kv_len - block_k, block_k=block_k,
                      **kw)

    seen = {}
    for name, patch in (("kernel", real_p), ("planted fault", short)):
        fa_ops.flash_attention_p = patch
        try:
            lf, ulps = attention_vs_xla(torch, cfg, prefill, params, prompts)
        finally:
            fa_ops.flash_attention_p = real_p
        seen[name] = (max(ulps), len(ulps))
        say(f"  {name} vs xla attention, per layer on the same q, k, v: "
            f"largest {max(ulps):.4g} bf16 ulps over {len(ulps)} layers "
            f"(tolerance {FLASH_BF16_ULPS}); last logits ratio "
            f"{float((lf - lx).abs().max()) / top:.4g} (tolerance "
            f"{PALLAS_VS_XLA_REL}), greedy tokens agree "
            f"{float((lf.argmax(-1) == lx.argmax(-1)).float().mean()):.2f}")
    top_ulps, n_checked = seen["kernel"]
    if n_checked != cfg.n_layers or not top_ulps <= FLASH_BF16_ULPS:
        fail(f"serve: per-layer attention, kernel vs xla: {seen['kernel']}")
    if not seen["planted fault"][0] > FLASH_BF16_ULPS:
        fail(f"serve: the per-layer check passes a dropped kv tile "
             f"({seen['planted fault']})")
    del params, caches, logits, lx, lf, last, r
    torch.cuda.empty_cache()

    # (a) decode == forward at full width, depth 4, f32
    cfg4 = dataclasses.replace(cfg, n_layers=DEPTH_CHECK["layers"],
                               dtype="float32")
    gen.manual_seed(SERVE["seed"] + 1)
    p4 = materialize(tf.param_defs(cfg4), gen, device=dev,
                     default_dtype=cfg4.dtype)
    Bc, S = DEPTH_CHECK["batch"], DEPTH_CHECK["seq"]
    pre = S - 4
    t4 = torch.randint(0, cfg4.vocab_size, (Bc, S), generator=gen, device=dev,
                       dtype=torch.int32)
    build.reset_launches()
    full, _, _ = tf.forward(p4, t4, cfg4)
    _, kvs = tf.make_prefill_step(cfg4)(p4, {"tokens": t4[:, :pre]})
    n_f32 = build.LAUNCHES["flash_attention"]
    if n_f32 != 2 * cfg4.n_layers or sum(build.LAUNCHES.values()) != n_f32:
        fail(f"serve: depth-4 f32 forward and prefill launches "
             f"{build.LAUNCHES}, want flash_attention {2 * cfg4.n_layers}")
    c4 = tuple(F.pad(t, (0, 0, 0, 0, 0, S - pre)) for t in kvs)
    worst = 0.0
    for i in range(pre, S):
        lg, c4 = tf.make_serve_step(cfg4)(p4, t4[:, i:i + 1], c4, i)
        d = (lg - full[:, i]).abs()
        if bool((d > 2e-3 + 2e-3 * full[:, i].abs()).any()):
            fail(f"serve: depth-4 f32 decode step {i} differs from forward "
                 f"by {float(d.max())}")
        worst = max(worst, float(d.max()))
    say(f"  decode == forward: full-width {cfg.name} at depth "
        f"{cfg4.n_layers}, f32, {Bc} x {S} tokens (prefill {pre} + 4 "
        f"steps): max abs diff {worst:.3g} (rtol = atol = 2e-3); "
        f"flash_attention (f32 route) launches {n_f32}")
    del p4, full, kvs, c4
    torch.cuda.empty_cache()

    # (c) the smoke configs: card (kernel) against CPU (plain), f32
    for arch in ("gemma-7b", "deepseek-7b", "mistral-large-123b"):
        c = dataclasses.replace(_load(arch, smoke=True)[1], attn_impl="pallas")
        pc = materialize(tf.param_defs(c), torch.Generator().manual_seed(0),
                         device="cpu", default_dtype=c.dtype)
        tc = torch.randint(0, c.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
        got = tf.forward(_to(pc, dev), tc.to(dev), c)[0].cpu()
        err = float((got - tf.forward(pc, tc, c)[0]).abs().max())
        if not err <= 1e-4:
            fail(f"serve: {c.name} card vs CPU forward differ by {err}")
        say(f"  {c.name}: card forward (kernel 12, head dim {c.hd}) vs CPU "
            f"(plain): max abs diff {err:.3g} (tolerance 1e-4)")
    return {"flash_attention_tc": n_fa, "flash_attention": n_f32}


# --------------------------------------------------------------------------
# the dist phase: the shmap backend, one gloo rank a shard on one card
# --------------------------------------------------------------------------

DIST_RANKS = 8                 # processes, one shard each, sharing the card
DIST_TIMEOUT = 300             # seconds a collective may wait for its peers
DIST_JOBS_1E6 = (
    ("bucket staged", dict(ALL_KERNELS), False),
    ("bucket fused", dict(round="fused"), False),
    ("async staged", dict(ALL_KERNELS, exchange="async"), False),
    ("async_bucket staged", dict(ALL_KERNELS, exchange="async_bucket",
                                 async_lag=2), False),
    ("pmin staged", dict(ALL_KERNELS, exchange="pmin"), False),
    ("a2a_dense staged", dict(ALL_KERNELS, exchange="a2a_dense"), False),
    ("async_ppermute staged", dict(ALL_KERNELS, exchange="async_ppermute"),
     False),
    ("toka2 bucket staged", dict(ALL_KERNELS, toka="toka2"), False),
    ("toka3 bucket staged", dict(ALL_KERNELS, toka="toka3"), False),
    ("faults drop bucket staged", dict(ALL_KERNELS,
                                       faults=FAULT_PLANS["drop"]), False),
    ("landmark warm staged", dict(ALL_KERNELS, warm_start="landmark"), True),
)
DIST_JOBS_1E7 = (("bucket staged", dict(ALL_KERNELS), False),)
# the solver's kernel wrappers, by the ops module that calls them
ROUND_WRAPPERS = {"relax": ("relax_dst_tiled_fixpoint_batch",
                            "relax_dst_ragged_fixpoint_batch"),
                  "send": ("send_pack_tiled", "send_pack_ragged"),
                  "merge": ("merge_scatter_tiled", "merge_scatter_ragged"),
                  "round": ("fused_round_tiled", "fused_round_ragged")}


def _config(kw: dict):
    from repro_torch.core import FaultPlan, SsspConfig
    kw = dict(kw)
    if "faults" in kw:
        kw["faults"] = FaultPlan(**kw["faults"])
    return SsspConfig(**kw)


def dist_rank(rank, world, backend, init, view, jobs, sources, landmarks,
              queue):
    """One rank of the dist phase, a spawned process: joins the mesh of
    ``world`` processes over ``backend``, builds a shmap engine on its
    shard ``view`` for each job and solves ``sources`` three times: the
    first run (its launches counted), a second (its wall) and a third with
    the collectives timed. Puts (rank, "ok", results) on ``queue``; rank 0's
    results carry the distances, the others a digest of them."""
    try:
        if str(ROOT / "src") not in sys.path:
            sys.path.insert(0, str(ROOT / "src"))
        import hashlib

        import numpy as np
        import torch
        import torch.distributed as tdist
        from repro_torch.core import SsspEngine
        from repro_torch.kernels import build
        from repro_torch.launch.mesh import make_host_mesh
        torch.set_num_threads(1)
        torch.cuda.set_device(0)
        mesh = make_host_mesh((world,), ("data",), backend=backend,
                              init_method=init, rank=rank, world_size=world,
                              timeout=DIST_TIMEOUT)
        out = []
        for name, kw, warm in jobs:
            eng = SsspEngine.build(view, _config(kw), "shmap", mesh,
                                   ("data",))
            if warm:
                eng.precompute_landmarks(landmarks)
            torch.cuda.reset_peak_memory_stats()
            build.reset_launches()
            first = eng.solve(sources)
            launches = {k: v for k, v in build.LAUNCHES.items() if v}
            again = eng.solve(sources)
            eng.comm.timed = True
            timed_run = eng.solve(sources)
            out.append(dict(
                name=name, dist=first.dist if rank == 0 else None,
                digest=hashlib.sha256(first.dist.tobytes()).hexdigest(),
                stats=first.stats, status=first.status,
                warm=first.warm_started, launches=launches,
                first_wall=first.wall_s, wall=again.wall_s,
                coll_s=eng.comm.coll_s, coll_calls=eng.comm.coll_calls,
                timed_wall=timed_run.wall_s,
                repeat_equal=bool(np.array_equal(again.dist, first.dist)
                                  and np.array_equal(timed_run.dist,
                                                     first.dist)),
                peak=torch.cuda.max_memory_allocated()))
            del eng
            torch.cuda.empty_cache()
        queue.put((rank, "ok", out))
        tdist.destroy_process_group()
    except BaseException:
        import traceback
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_dist(views, backend: str, init: str, jobs, sources, landmarks,
             label: str):
    """Spawn one ``dist_rank`` a view and collect every rank's results
    (rank order); fails on a rank's error or a timeout, and stops every
    process it started."""
    import queue as queue_mod

    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(
        r, len(views), backend, init, v, jobs, sources, landmarks, q))
        for r, v in enumerate(views)]
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < len(views):
            try:
                rank, status, res = q.get(timeout=2 * DIST_TIMEOUT)
            except queue_mod.Empty:
                fail(f"dist {label}: no result from ranks "
                     f"{sorted(set(range(len(views))) - set(got))}")
            if status != "ok":
                fail(f"dist {label}: rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(len(views))]


class _Ranked:
    """Rank 0's result of a job, in the shape ``same_results`` reads."""

    def __init__(self, res):
        self.dist, self.stats, self.status = (res["dist"], res["stats"],
                                              res["status"])


def _expected_kernels(kw: dict, ragged: bool):
    from repro_torch.core import phases
    if kw.get("round") == "fused":
        names = ("round",)
    else:
        dense = phases.resolve("exchange",
                               kw.get("exchange", "bucket")).dense
        names = STAGED[:2] if dense else STAGED
    return [n + ("_ragged" if ragged else "") for n in names]


def dist_phase(torch, np, sh, eng, sources, jobs, label: str, ragged: bool,
               landmarks=(), card: str = ""):
    """The shmap backend on the card: ``DIST_RANKS`` gloo ranks (spawned
    processes sharing the card, one shard each, the kernels built before
    they start) solve each job's config over the K sources; every rank's
    result must equal the sim engine's solve on the same card bit for bit
    (distances, every counter, status), every rank the same, each job's
    kernels launched by the ranks. The walls of the P-rank solve and the
    sim's, and the time a round spent in collectives, are printed: 8
    ranks time-sliced on one card, not a deployment's speed."""
    import tempfile
    from repro_torch.core import SsspEngine
    sims = {}
    for name, kw, warm in jobs:
        e = SsspEngine.build(eng.shards, _config(kw))
        if warm:
            e.precompute_landmarks(list(landmarks))
        e.solve(sources)
        sims[name] = e.solve(sources)
        del e
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    views = [sh.shard(r) for r in range(sh.n_parts)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        per_rank = run_dist(views, "gloo", f"file://{tmp}/store", list(jobs),
                            list(sources), list(landmarks), label)
        wall = time.perf_counter() - t0
    for i, (name, kw, warm) in enumerate(jobs):
        r0 = per_rank[0][i]
        what = f"dist {label} {name}"
        sim = sims[name]
        same_results(_Ranked(r0), sim, f"{what} ({len(views)} ranks vs sim)")
        for r, res in enumerate(per_rank):
            x = res[i]
            if (x["digest"] != r0["digest"] or not x["repeat_equal"]
                    or x["status"] != r0["status"]):
                fail(f"{what}: rank {r} disagrees with rank 0 (or with "
                     "itself on a repeat)")
            for f in sim.stats._fields:
                if not np.array_equal(np.asarray(getattr(x["stats"], f)),
                                      np.asarray(getattr(r0["stats"], f))):
                    fail(f"{what}: rank {r}'s {f} differs from rank 0's")
        if r0["status"] != "converged" or r0["warm"] != warm:
            fail(f"{what}: status {r0['status']}, warm {r0['warm']}")
        expect = _expected_kernels(kw, ragged)
        counts = {k: [res[i]["launches"].get(k, 0) for res in per_rank]
                  for k in expect}
        if any(sum(v) < 1 or v[0] < 1 for v in counts.values()):
            fail(f"{what}: a kernel of the path was not launched {counts}")
        rounds = int(r0["stats"].rounds)
        coll = max(res[i]["coll_s"] for res in per_rank)
        calls = r0["coll_calls"]
        say(f"{what}: {len(views)} ranks == sim bit for bit, {rounds} rounds;"
            f" wall {r0['wall']:.4f} s on {len(views)} ranks (first "
            f"{r0['first_wall']:.4f} s) vs {sim.wall_s:.4f} s sim; "
            f"collectives {coll / max(rounds, 1) * 1e3:.3f} ms a round "
            f"({calls / max(rounds, 1):.1f} calls a round; most over ranks, "
            f"timed solve {r0['timed_wall']:.4f} s); peak "
            f"{max(res[i]['peak'] for res in per_rank) / 2**30:.3f} GiB a "
            f"rank; launches a rank {counts}")
    say(f"dist {label}: {len(jobs)} configs on {len(views)} gloo ranks "
        f"(all_reduce, all_to_all_single and all_gather_single on CUDA "
        f"tensors, none staged through the host), every rank == the sim "
        f"engine bit for bit; {wall:.1f} s for the phase. These are "
        f"{len(views)} ranks time-sliced on one card ({card}), not a "
        f"deployment's speed.")


def nccl_world_one(torch, np):
    """NCCL at world size 1 (one card, one rank): the parity graph as one
    shard, the all-kernel staged config, equal to the sim engine on the
    same card bit for bit."""
    import socket
    from repro_torch.core import SsspEngine, build_shards
    from repro_torch.graph import rmat_graph
    g1 = rmat_graph(scale=11)
    sh1 = build_shards(g1, 1)
    srcs = live_sources(np, np.random.default_rng(5), g1, 4)
    job = ("nccl world 1", dict(ALL_KERNELS), False)
    sim = SsspEngine.build(sh1, _config(job[1])).solve(srcs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    res = run_dist([sh1.shard(0)], "nccl", f"tcp://localhost:{port}", [job],
                   srcs, [], "nccl")[0][0]
    same_results(_Ranked(res), sim, "dist nccl world 1 vs sim")
    say(f"dist nccl world 1: rmat scale 11 as one shard, K=4, == sim bit "
        f"for bit, {int(res['stats'].rounds)} rounds, wall {res['wall']:.4f}"
        f" s vs {sim.wall_s:.4f} s sim; launches {res['launches']}")


@contextlib.contextmanager
def plain_round_kernels():
    """Within the block, the solver's kernel wrappers (where the ops
    modules call them) are their plain PyTorch versions, on any device."""
    import importlib
    saved = []
    try:
        for mod, names in ROUND_WRAPPERS.items():
            ops = importlib.import_module(f"repro_torch.kernels.{mod}.ops")
            impl = importlib.import_module(
                f"repro_torch.kernels.{mod}.{mod}")
            for n in names:
                saved.append((ops, n, getattr(ops, n)))
                setattr(ops, n, functools.partial(
                    _drop_schedule, getattr(impl, f"{n}_plain")))
        yield
    finally:
        for ops, n, f in saved:
            setattr(ops, n, f)


def _drop_schedule(plain, *args, chunks=None, bounds=None, **kw):
    return plain(*args, **kw)


def _flat(x):
    if isinstance(x, tuple):
        return [t for y in x for t in _flat(y)]
    return [x]


def one_shard_kernels(torch, eng, sources, cfg, label: str, ragged: bool):
    """Kernels 1, 3, 5, 7 (dense) or 2, 4, 6, 8 (ragged) on a rank's
    one-shard stack (``SsspShards.shard``), at the state after round 2 of
    the sim's solve: each launched through the round's phase function on
    the view, bit-equal to its plain version on the same inputs (the
    wrappers swapped for their plain versions), for the first and the last
    shard with a frontier."""
    from repro_torch.core import sssp as S
    from repro_torch.core.local_solver import _batch_pallas
    from repro_torch.kernels import build
    dsh = eng.shards
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    live = ~carry.done
    act = carry.active & live[..., None]
    payload = S._phase_send_pallas(dsh, carry.dist, carry.pruned,
                                   carry.last_sent)[0]
    incoming = payload.transpose(0, 2).contiguous()
    busy = [r for r in range(dsh.n_parts) if bool(act[r].any())]
    if not busy:
        fail(f"one-shard kernels {label}: no shard has a frontier")
    sfx = "_ragged" if ragged else ""
    seen = {}
    for r in sorted({busy[0], busy[-1]}):
        v = dsh.shard(r)

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
            torch.cuda.synchronize()
            n = build.LAUNCHES[name + sfx]
            if n < 1:
                fail(f"one-shard kernels {label}: {name}{sfx} not launched "
                     f"on shard {r}'s view")
            with plain_round_kernels():
                want = _flat(tuple(call()))
            for g_, w_ in zip(got, want, strict=True):
                if not torch.equal(g_, w_):
                    fail(f"one-shard kernels {label}: {name}{sfx} on shard "
                         f"{r}'s [1, ...] stack differs from its plain "
                         f"version")
            seen[f"{name}{sfx}"] = seen.get(f"{name}{sfx}", 0) + n
    say(f"one-shard kernels {label}: {', '.join(seen)} on the [1, ...] "
        f"stacks of shards {sorted({busy[0], busy[-1]})} at round 2, each "
        f"bit-equal to its plain version; launches {seen}")


# --------------------------------------------------------------------------
# the layout-free shards, the per-phase hook and the per-shard wrappers
# --------------------------------------------------------------------------

FALLBACKS = {                  # warning key -> the words it starts with
    "local_solver.pallas.no_layout": "local_solver='pallas' falling back",
    "send.pallas.no_layout": "send_backend='pallas' falling back",
    "merge.pallas.no_layout": "merge_backend='pallas' falling back",
    "round.fused.no_layout": "round='fused' falling back"}
PHASE_TIMING = dict(reps=5, samples=10)     # sim_phase_fns: events a median


def no_layout_phase(torch, full, bare, sources, label: str, card: str):
    """Shards built with ``relax_layout=False, comm_layout=False``: the
    sources under the all-kernel staged config and under round="fused".
    Every kernel backend falls back to plain ops, each of the four
    fallbacks warning once, no kernel launches, and each solve equals the
    plain config (bellman, xla, staged) on the layout-full shards in
    distances, every counter and status. Prints both shards' bytes per
    edge and the walls (a second solve of each, after a first)."""
    import warnings
    from repro_torch.core import SsspConfig, SsspEngine, phases
    from repro_torch.kernels import build

    def solve_twice(eng):
        eng.solve(sources)
        return eng.solve(sources)

    want = solve_twice(SsspEngine.build(full, SsspConfig()))
    phases._WARNED.difference_update(FALLBACKS)
    walls = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for name, kw in (("all-kernel", ALL_KERNELS),
                         ("fused", dict(round="fused"))):
            eng = SsspEngine.build(bare, SsspConfig(**kw))
            torch.cuda.synchronize()
            build.reset_launches()
            res = solve_twice(eng)
            torch.cuda.synchronize()
            if any(build.LAUNCHES.values()):
                fail(f"no-layout {label} {name}: a kernel was launched "
                     f"{build.LAUNCHES}")
            if res.status != "converged":
                fail(f"no-layout {label} {name}: status {res.status}")
            same_results(res, want, f"no-layout {label} {name} vs the "
                         "plain config on the layout-full shards")
            walls[name] = res.wall_s
    msgs = [str(w.message) for w in caught]
    for key, words in FALLBACKS.items():
        n = sum(m.startswith(words) for m in msgs)
        if n != 1:
            fail(f"no-layout {label}: the {key} fallback warned {n} times")
    lf, lb = full.layout_bytes(), bare.layout_bytes()
    say(f"no-layout {label}: K={len(sources)}, the all-kernel and the fused "
        f"configs fall back (the four warnings once each, no kernel "
        f"launched), both == the plain config on the layout-full shards in "
        f"distances and every counter, {int(want.stats.rounds)} rounds; "
        f"bytes per edge {lb['bytes_per_edge']:.2f} without layouts, "
        f"{lf['bytes_per_edge']:.2f} with ({lb['total_bytes']} vs "
        f"{lf['total_bytes']} B of layouts); walls (second solve) "
        f"{walls['all-kernel']:.4f} s all-kernel config, "
        f"{walls['fused']:.4f} s fused config, {want.wall_s:.4f} s plain "
        f"config on the layout-full shards; {card}")
    return walls


def phase_fns_phase(torch, eng, sources, label: str, ragged: bool,
                    card: str):
    """``sim_phase_fns`` with the pallas backends on the state after round
    2 of the all-kernel staged solve (``fused`` on the fused solve's round
    2 state): local -> send -> exchange -> merge launch kernels 1/2, 3/4
    and 5/6 and compose to one round of ``make_round`` bit for bit;
    ``fused`` launches kernel 7/8; each kernel phase is bit-equal to its
    plain version; each phase timed (CUDA events, median). Returns the
    times."""
    from repro_torch.core import SsspConfig, SsspEngine, sim_phase_fns
    from repro_torch.kernels import build
    sfx = "_ragged" if ragged else ""
    sh = eng.shards
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    eng_f = SsspEngine.build(sh, SsspConfig(round="fused"))
    cf = eng_f.start(sources)
    for _ in range(2):
        cf = eng_f.round_fn(cf)
    fns = sim_phase_fns(sh, eng.cfg)
    fns["fused"] = sim_phase_fns(sh, eng_f.cfg)["fused"]
    act = carry.active & ~carry.done[..., None]
    live = ~cf.done
    torch.cuda.synchronize()
    build.reset_launches()
    local = fns["local"](carry.dist, act, carry.pruned, carry.tri_cursor)
    send = fns["send"](local[0], local[1], carry.last_sent)
    inc = fns["exchange"](send[0])
    merge = fns["merge"](local[0], inc)
    fused = fns["fused"](cf.dist, cf.active & live[..., None], live,
                         cf.incoming, cf.last_sent, cf.pruned)
    torch.cuda.synchronize()
    launches = {k + sfx: build.LAUNCHES[k + sfx] for k in STAGED + ("round",)}
    if min(launches.values()) < 1:
        fail(f"phase fns {label}: a kernel was not launched {launches}")
    nxt = eng.round_fn(carry)
    for name, a, b in (("dist", merge[0], nxt.dist),
                       ("active", merge[1], nxt.active),
                       ("last_sent", send[1], nxt.last_sent),
                       ("pruned", local[1], nxt.pruned),
                       ("tri_cursor", local[2], nxt.tri_cursor)):
        if not torch.equal(a, b):
            fail(f"phase fns {label}: the composed phases' {name} differs "
                 f"from one round of make_round")
    calls = {
        "local": (fns["local"], (carry.dist, act, carry.pruned,
                                 carry.tri_cursor), local),
        "send": (fns["send"], (local[0], local[1], carry.last_sent), send),
        "exchange": (fns["exchange"], (send[0],), inc),
        "merge": (fns["merge"], (local[0], inc), merge),
        "fused": (fns["fused"], (cf.dist, cf.active & live[..., None], live,
                                 cf.incoming, cf.last_sent, cf.pruned),
                  fused)}
    for name in ("local", "send", "merge", "fused"):
        fn, args, got = calls[name]
        with plain_round_kernels():
            want = fn(*args)
        for g_, w_ in zip(_flat(tuple(got)), _flat(tuple(want)),
                          strict=True):
            if not torch.equal(g_, w_):
                fail(f"phase fns {label}: {name} differs from its plain "
                     f"version")
    times = {name: timed_median(torch, functools.partial(fn, *args),
                                **PHASE_TIMING)[0]
             for name, (fn, args, _) in calls.items()}
    staged = sum(times[k] for k in ("local", "send", "exchange", "merge"))
    say(f"phase fns {label}: round-2 state, K={len(sources)}; local -> send "
        f"-> exchange -> merge == one round of make_round bit for bit, each "
        f"kernel phase and fused == its plain version; launches {launches}; "
        f"ms (events, median of {PHASE_TIMING['samples']} x "
        f"{PHASE_TIMING['reps']} calls): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; staged sum {staged:.4f} ms (local "
        f"{times['local'] / staged:.2f}, send {times['send'] / staged:.2f}, "
        f"exchange {times['exchange'] / staged:.2f}, merge "
        f"{times['merge'] / staged:.2f}); {card}")
    return times


def shard_wrappers_phase(torch, eng, sources, label: str, ragged: bool):
    """The reference's per-shard wrappers on shard 0 of the round-2 state:
    ``send_pack_pallas`` (kernel 3/4), ``merge_scatter_pallas`` (5/6),
    ``relax_fixpoint_batch_pallas`` (1, dense) or
    ``relax_fixpoint_batch_ragged_pallas`` (2, ragged) and
    ``local_fixpoint_pallas_batch`` (1/2): each launches its kernel and is
    bit-equal to its plain version and to row 0 of the P-stacked
    entry point on the whole stack."""
    from repro_torch.core import sssp as S
    from repro_torch.core.local_solver import (_batch_pallas,
                                               local_fixpoint_pallas_batch)
    from repro_torch.kernels import build
    from repro_torch.kernels import relax as R
    from repro_torch.kernels.common import take_fill
    from repro_torch.kernels.merge import merge_scatter, merge_scatter_pallas
    from repro_torch.kernels.send import send_pack, send_pack_pallas
    sfx = "_ragged" if ragged else ""
    sh = eng.shards
    carry = eng.start(sources)
    for _ in range(2):
        carry = eng.round_fn(carry)
    act = carry.active & ~carry.done[..., None]
    P, K = carry.dist.shape[:2]
    # operands in each kernel's form, for the whole stack
    tx = sh.send_layout
    tx_pruned = take_fill(carry.pruned[:, sh.e_loc:].to(torch.int32),
                          tx[3].reshape(P, -1), 0).reshape(tx[3].shape)
    incoming = S._phase_send_pallas(sh, carry.dist, carry.pruned,
                                    carry.last_sent)[0].transpose(0, 2)
    incoming = incoming.reshape(P, K, -1).contiguous()
    mx = sh.merge_layout
    rx = sh.relax_layout
    bp = (-(-sh.block // sh.rx_vb) * sh.rx_vb if ragged
          else rx[0].shape[1] * sh.rx_vb)
    d_pad, f_pad, rx_pruned = R.fixpoint_operands(
        carry.dist, act, carry.pruned[:, :sh.e_loc], rx[3], bp)
    n_sweeps = eng.cfg.pallas_sweeps
    rkw = dict(vb=sh.rx_vb, eb=sh.rx_eb, n_sweeps=n_sweeps)
    if ragged:
        relax_name = "relax_fixpoint_batch_ragged_pallas"

        def relax_one():
            return R.relax_fixpoint_batch_ragged_pallas(
                d_pad[0], f_pad[0], rx[4][0], *(a[0] for a in rx[:3]),
                rx_pruned[0], **rkw)

        def relax_all():
            return R.relax_dst_ragged_fixpoint_batch(
                d_pad, f_pad, rx[4], *rx[:3], rx_pruned, vb=sh.rx_vb,
                n_sweeps=n_sweeps)
    else:
        relax_name = "relax_fixpoint_batch_pallas"

        def relax_one():
            return R.relax_fixpoint_batch_pallas(
                d_pad[0], f_pad[0], *(a[0] for a in rx[:3]), rx_pruned[0],
                **rkw)

        def relax_all():
            return R.relax_dst_tiled_fixpoint_batch(
                d_pad, f_pad, *rx[:3], rx_pruned, vb=sh.rx_vb,
                n_sweeps=n_sweeps, chunks=sh.relax_chunks)
    send_ct = (tx[4][0],) if ragged else ()
    merge_ct = (mx[3][0],) if ragged else ()
    pkw = dict(max_iters=eng.cfg.local_iters, delta=eng.cfg.delta,
               relax_layout=rx, relax_vb=sh.rx_vb, pallas_sweeps=n_sweeps)
    cases = {
        "send_pack_pallas": ("send", lambda: send_pack_pallas(
            carry.dist[0], carry.last_sent[0], sh.slot_valid[0],
            *(a[0] for a in tx[:3]), tx_pruned[0], *send_ct, sb=sh.tx_sb,
            eb=sh.tx_eb), lambda: send_pack(
            carry.dist, carry.last_sent, sh.slot_valid, *tx[:3], tx_pruned,
            sb=sh.tx_sb, ctile=tx[4] if ragged else None,
            bounds=sh.send_bounds)),
        "merge_scatter_pallas": ("merge", lambda: merge_scatter_pallas(
            carry.dist[0], incoming[0], *(a[0] for a in mx[:3]), *merge_ct,
            vb=sh.mx_vb, eb=sh.mx_eb), lambda: merge_scatter(
            carry.dist, incoming, *mx[:3], vb=sh.mx_vb,
            ctile=mx[3] if ragged else None, bounds=sh.merge_bounds)),
        relax_name: ("relax", relax_one, relax_all),
        "local_fixpoint_pallas_batch": ("relax", lambda: (
            local_fixpoint_pallas_batch(
                carry.dist[0], act[0], carry.pruned[0, :sh.e_loc],
                tuple(a[0] for a in rx), vb=sh.rx_vb,
                max_iters=eng.cfg.local_iters, sweeps=n_sweeps)),
            lambda: _batch_pallas(
                carry.dist, act, sh.loc_src, sh.loc_dst, sh.loc_w,
                carry.pruned[:, :sh.e_loc], chunks=sh.relax_chunks, **pkw))}
    seen = {}
    for name, (kernel, one, stacked) in cases.items():
        torch.cuda.synchronize()
        build.reset_launches()
        got = _flat(tuple(one()))
        torch.cuda.synchronize()
        n = build.LAUNCHES[kernel + sfx]
        if n < 1:
            fail(f"wrappers {label}: {name} launched no {kernel}{sfx}")
        seen[name] = n
        with plain_round_kernels():
            want = _flat(tuple(one()))
        row0 = [t[0] for t in _flat(tuple(stacked()))]
        for g_, w_, r_ in zip(got, want, row0, strict=True):
            if not (torch.equal(g_, w_) and torch.equal(g_, r_)):
                fail(f"wrappers {label}: {name} differs from its plain "
                     f"version or from row 0 of the stacked entry point")
    say(f"wrappers {label}: {', '.join(seen)} on shard 0 at round 2, each "
        f"bit-equal to its plain version and to row 0 of the stacked entry "
        f"point; launches {seen}")


TRAIN = dict(arch="deepseek-7b", layers=2, batch=4, seq=1024, steps=3,
             seed=16)
# The MoE phases. Serving: the two MoE LM configs at their published
# widths (src/repro/configs/olmoe_1b_7b.py, qwen3_moe_235b_a22b.py) under
# the serve phase's traffic, olmoe at full depth (16 layers, 13.8 GB in
# bf16) and qwen3 cut from 94 layers to 4 (11.2e9 parameters, 22.4 GB; the
# whole model's 235e9 do not fit one card, so its bytes are stated from
# params.abstract). Training: olmoe cut to 2 layers at the train phase's
# batch 4 x seq 1024; qwen3 trains at its SMOKE size only (one layer is
# 3.7e9 parameters, about 150 GB of training state).
MOE_SERVE = (("olmoe-1b-7b", None), ("qwen3-moe-235b-a22b", 4))
MOE_TRAIN = dict(arch="olmoe-1b-7b", layers=2, batch=4, seq=1024, steps=3,
                 seed=17)
MOE_ARCHS = ("olmoe-1b-7b", "qwen3-moe-235b-a22b")
# The launcher: the smoke runs of an LM, AutoInt and a GNN, 6 steps with a
# checkpoint every 2, resumed to 10 steps, against an uninterrupted 10-step
# run. The losses of the resumed steps are held to the uninterrupted run's
# within LAUNCH_REL relative, not bit for bit: the MoE dispatch's backward,
# the embedding's and the GNN's scatters are index_add atomics that sum in
# another order from run to run.
LAUNCH_ARCHS = ("olmoe-1b-7b", "autoint", "mace")
# the runs whose loss must fall over the 10 steps: AutoInt's BCE at batch 8
# on its synthetic labels starts at ln 2 and stays within the batches'
# noise of it over 10 steps
LAUNCH_FALLS = ("olmoe-1b-7b", "mace")
LAUNCH_ARGS = ("--smoke", "--log-every", "1")
LAUNCH_REL = 1e-5
# the launcher's main() in a subprocess, its losses printed in full
LAUNCH_PROG = ("import json, sys; from repro_torch.launch.train import main; "
               "print('losses', json.dumps(main(sys.argv[1:])))")


def train_steps(torch, cfg, full, run: dict, card: str, label: str):
    """``run["steps"]`` make_train_step steps with AdamWConfig() on one
    fixed batch of ``run["batch"]`` x ``run["seq"]`` tokens (weights and
    tokens made on the card from ``run["seed"]``), the loss finite and
    falling, then a step with microbatches=2; no kernel launched; ms a
    step, tokens/s and peak memory printed. ``full`` is the config ``cfg``
    was cut from."""
    import math
    from repro_torch.configs.registry import LM_SHAPES
    from repro_torch.kernels import build
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = torch.device("cuda")
    B, S = run["batch"], run["seq"]
    shape = LM_SHAPES["train_4k"]
    moe = (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_expert "
           f"{cfg.moe.d_expert}" if cfg.moe else "")
    say(f"{label} phase: {full.name} d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads, d_ff {cfg.d_ff}{moe}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"attn_impl={cfg.attn_impl}; cut: depth {full.n_layers} -> "
        f"{cfg.n_layers} layers ({cfg.n_params()} params), batch x seq "
        f"{shape['batch']} x {shape['seq']} -> {B} x {S}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(run["seed"])
    params = materialize(tf.param_defs(cfg), gen, device=dev,
                         default_dtype=cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    opt = adamw_init(params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    losses, walls = [], []
    for mb in [1] * run["steps"] + [2]:
        step = tf.make_train_step(cfg, AdamWConfig(), microbatches=mb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        if not (math.isfinite(loss) and math.isfinite(float(m["grad_norm"]))
                and all(bool(torch.isfinite(p).all())
                        for p in tree_leaves(params))):
            fail(f"{label}: step {len(losses)} (microbatches {mb}) gave a "
                 f"non-finite loss, gradient norm or parameter")
    peak = torch.cuda.max_memory_allocated()
    if not losses[run["steps"] - 1] < losses[0]:
        fail(f"{label}: the loss does not fall over {run['steps']} steps "
             f"{losses}")
    if any(build.LAUNCHES.values()):
        fail(f"{label}: a kernel was launched {build.LAUNCHES}")
    ms = [1e3 * w for w in walls]
    steady = statistics.median(ms[1:run["steps"]])
    say(f"  {run['steps']} steps (AdamWConfig()) on one batch: losses "
        + ", ".join(f"{x:.4f}" for x in losses[:run["steps"]])
        + f"; microbatches=2 step: loss {losses[-1]:.4f}; ms a step "
        + ", ".join(f"{x:.1f}" for x in ms[:run["steps"]])
        + f" (first one with the allocator's growth), microbatches=2 "
        f"{ms[-1]:.1f}; {B * S / steady * 1e3:.0f} tokens/s at the median "
        f"of steps 2-{run['steps']} ({steady:.1f} ms); peak allocated "
        f"{peak} B ({held} B of it the weights, the optimizer state and "
        f"the batch before the first step); {card}")
    del params, opt, m, batch, toks
    torch.cuda.empty_cache()
    return dict(losses=losses, ms=ms, peak=peak)


def smoke_params(torch, arch: str):
    """(config, parameters on the CPU, tokens [4, 41]) of ``arch``'s SMOKE
    config in f32, from seeds."""
    from repro_torch.configs.registry import _load
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    c = _load(arch, smoke=True)[1]
    pc = materialize(tf.param_defs(c), torch.Generator().manual_seed(0),
                     device="cpu", default_dtype=c.dtype)
    tc = torch.randint(0, c.vocab_size, (4, 41),
                       generator=torch.Generator().manual_seed(1),
                       dtype=torch.int32)
    return c, pc, tc


def train_card_vs_cpu(torch, arch: str, label: str):
    """``arch``'s SMOKE config in f32: the loss and every gradient on the
    card against the CPU, 1e-4 relative in the loss, each gradient within
    1e-3 of its largest value."""
    from repro_torch.models import transformer as tf
    c, pc, tc = smoke_params(torch, arch)
    bc = {"tokens": tc[:, :-1], "labels": tc[:, 1:]}
    rel, worst = grads_card_vs_cpu(torch, tf.loss_fn, pc, bc, c,
                                   f"{label}: {c.name}")
    say(f"  {c.name} f32 on the card vs the CPU: loss {rel:.3g} relative "
        f"(tolerance 1e-4), gradients within {worst:.3g} of each one's "
        f"largest value (tolerance 1e-3)")
    return c, pc, bc


def train_phase(torch, card: str):
    """The training path: deepseek-7b at its published widths in bf16,
    attn_impl="chunked", cut to 2 layers, batch 4 x seq 1024 (weights and
    tokens made on the card from seeds): three make_train_step steps with
    AdamWConfig() on one fixed batch, the loss finite and falling, then a
    step with microbatches=2; ms a step, tokens/s and peak memory. Then at
    the SMOKE config in f32 the loss and every gradient on the card against
    the CPU (1e-4 relative in the loss, 1e-3 of each gradient's largest
    value), and a gradient through attn_impl="pallas" must raise."""
    from repro_torch.configs.registry import _load
    from repro_torch.models import transformer as tf
    dev = torch.device("cuda")
    full = _load(TRAIN["arch"])[1]
    cfg = dataclasses.replace(full, n_layers=TRAIN["layers"],
                              attn_impl="chunked")
    out = train_steps(torch, cfg, full, TRAIN, card, "train")
    c, pc, bc = train_card_vs_cpu(torch, TRAIN["arch"], "train")
    cp = dataclasses.replace(c, attn_impl="pallas")
    try:
        tf._value_and_grad(_to(pc, dev), _to(bc, dev), cp)
    except NotImplementedError as e:
        refusal = str(e).split(":")[0]
    else:
        fail("train: a gradient through attn_impl='pallas' did not raise")
    say(f"  a gradient through attn_impl='pallas' on the card raises "
        f"({refusal})")
    return out


@contextlib.contextmanager
def recording(module, name: str, record):
    """``module.name`` wrapped so that each call hands its arguments and
    result to ``record(args, out)``; restored on exit."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        record(args, out)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def capacity_drops(torch, cfg, r: dict, params, prompts, G: int):
    """The share of (token, k) assignments that capacity dropped, in the
    prefill of ``prompts`` and in ``G`` greedy decode steps after it (a
    rerun of serve_run's steps with the routing recorded)."""
    import torch.nn.functional as F
    from repro_torch.models import moe as moe_mod
    P = prompts.shape[1]
    kept = {"prefill": [], "decode": []}
    part = "prefill"

    def record(args, out):
        kept[part].append(torch.stack([out[2].sum(),
                                       torch.tensor(out[2].numel(),
                                                    device=out[2].device)]))

    with recording(moe_mod, "_routing_group", record):
        logits, kvs = r["prefill"](params, {"tokens": prompts})
        caches = tuple(F.pad(t, (0, 0, 0, 0, 0, G)) for t in kvs)
        del kvs
        part = "decode"
        tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
        for i in range(G):
            last, caches = r["serve"](params, tok, caches, P + i)
            tok = last.argmax(dim=-1)[:, None].to(torch.int32)
    del caches
    share = {}
    for name, rows in kept.items():
        n_kept, n_all = (int(x) for x in torch.stack(rows).sum(dim=0))
        share[name] = (1 - n_kept / n_all, n_all - n_kept, n_all)
    return share


def moe_serve_phase(torch, card: str, out_dir: Path):
    """The MoE FFN's serving path: olmoe-1b-7b at its published widths and
    full depth, then qwen3-moe-235b-a22b at its published widths cut to 4
    layers (MOE_SERVE), bf16, attn_impl="pallas", weights made on the card
    from seeds, driven as the serve phase drives gemma (serve_run): kernel
    12's bf16 route once a layer in the prefill and nothing else, no kernel
    in decode; prefill and decode times, tokens/s, peak memory and the
    share of (token, k) assignments capacity dropped in each. Then the
    prefill's last logits with "pallas" against "xla" (the xla run routed
    as the kernel run, so the two differ only in attention's arithmetic;
    the assignments its own top-k would move printed) within
    PALLAS_VS_XLA_REL, and each layer's attention against "xla" on the
    same q, k, v (2 bf16 ulps). Then both SMOKE configs in f32,
    attn_impl="pallas": the forward on the card (kernel 12's f32 route once
    a layer) against the CPU (plain), logits within 1e-4 of the largest
    and the routing (topi, slot_token, pos, keep) equal in every layer,
    with the smallest gap between the k-th and (k+1)-th probability
    printed. Profiles of each prefill and of 4 decode steps go to
    ``out_dir``."""
    from repro_torch.configs.registry import _load
    from repro_torch.kernels import build
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import abstract, materialize, tree_leaves
    dev = torch.device("cuda")
    B, P, G = SERVE["batch"], SERVE["prompt"], SERVE["gen"]
    for i, (arch, depth) in enumerate(MOE_SERVE):
        full = _load(arch)[1]
        cfg = dataclasses.replace(full, n_layers=depth or full.n_layers,
                                  attn_impl="pallas")
        full_bytes = sum(nbytes(t) for t in tree_leaves(
            abstract(tf.param_defs(full), full.dtype)))
        gen = torch.Generator(device=dev)
        gen.manual_seed(SERVE["seed"] + 10 + i)
        t0 = time.perf_counter()
        params = materialize(tf.param_defs(cfg), gen, device=dev,
                             default_dtype=cfg.dtype)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        w_bytes = sum(nbytes(t) for t in tree_leaves(params))
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                                device=dev, dtype=torch.int32)
        m = cfg.moe
        say(f"moe serve phase: {cfg.name} d_model {cfg.d_model}, heads "
            f"{cfg.n_heads} / kv {cfg.n_kv_heads}, head dim {cfg.hd}, "
            f"{m.n_experts} experts top-{m.top_k} d_expert {m.d_expert}, "
            f"vocab {cfg.vocab_size}; depth {full.n_layers} -> "
            f"{cfg.n_layers} layers: {cfg.n_params()} params ({w_bytes} B "
            f"bf16) made on the card in {t_init:.1f} s; the whole model "
            f"{full.n_params()} params, {full.n_active_params()} active a "
            f"token, {full_bytes} B (params.abstract, not allocated); {B} "
            f"prompts x {P} tokens, {G} greedy steps; {card}")
        r = serve_run(torch, cfg, params, prompts, G)
        label = f"moe serve {cfg.name}"
        check_serve(torch, cfg, r, B, P, G, label)
        profile_run(torch, lambda: r["prefill"](params, {"tokens": prompts}),
                    out_dir / f"chip_smoke_trace_{arch}_prefill.json",
                    f"{cfg.name} prefill {B}x{P}")
        profile_run(torch, lambda: [r["serve"](params, r["tok"], r["caches"],
                                               P + G - 1)
                                    for _ in range(4)],
                    out_dir / f"chip_smoke_trace_{arch}_decode.json",
                    f"{cfg.name} 4 decode steps")
        drops = capacity_drops(torch, cfg, r, params, prompts, G)
        Cg = {"prefill": max(int(B * P * m.top_k / m.n_experts
                                 * m.capacity_factor), 1),
              "decode": max(int(B * m.top_k / m.n_experts
                                * m.capacity_factor), 1)}
        say("  capacity drops: " + "; ".join(
            f"{name} {share:.4f} of the (token, k) assignments ({n} of "
            f"{n_all}, capacity {Cg[name]} a group)"
            for name, (share, n, n_all) in drops.items()))

        # pallas vs xla: the kernel run's routing recorded, each layer's
        # attention against xla on the same q, k, v; then the xla prefill
        # routed as the kernel run
        picks = []
        with recording(moe_mod, "top_k",
                       lambda args, out: picks.append(out[1])):
            lf, ulps = attention_vs_xla(torch, cfg, r["prefill"], params,
                                        prompts)
        real_top_k, moved, it = moe_mod.top_k, [], iter(picks)

        def routed_as_kernel(probs, k):
            idx = next(it)
            moved.append((real_top_k(probs, k)[1] != idx).sum())
            return probs.gather(-1, idx.long()), idx

        cfg_x = dataclasses.replace(cfg, attn_impl="xla")
        moe_mod.top_k = routed_as_kernel
        try:
            lx = tf.make_prefill_step(cfg_x)(params, {"tokens": prompts})[0]
        finally:
            moe_mod.top_k = real_top_k
        diff = float((lf - lx).abs().max())
        top = float(lx.abs().max())
        agree = float((lf.argmax(-1) == lx.argmax(-1)).float().mean())
        n_moved = int(torch.stack(moved).sum())
        say(f"  pallas vs xla prefill (xla routed as the kernel run; its own "
            f"top-k would move {n_moved} of {B * P * m.top_k * cfg.n_layers}"
            f" assignments), last logits: max abs diff {diff:.4g}, largest "
            f"|logit| {top:.4g} (ratio {diff / top:.4g}, tolerance "
            f"{PALLAS_VS_XLA_REL}); greedy tokens agree {agree:.2f}; "
            f"kernel vs xla attention per layer on the same q, k, v: "
            f"largest {max(ulps):.4g} bf16 ulps over {len(ulps)} layers "
            f"(tolerance {FLASH_BF16_ULPS})")
        if not (diff <= PALLAS_VS_XLA_REL * top and agree == 1.0):
            fail(f"{label}: pallas vs xla prefill logits differ by {diff} "
                 f"(greedy tokens agree {agree:.2f})")
        if len(ulps) != cfg.n_layers or not max(ulps) <= FLASH_BF16_ULPS:
            fail(f"{label}: per-layer attention, kernel vs xla: "
                 f"{max(ulps)} bf16 ulps over {len(ulps)} layers")
        del params, r, lf, lx, picks, prompts
        torch.cuda.empty_cache()

    # the SMOKE configs: card (kernel 12, f32 route) against CPU (plain)
    for arch in MOE_ARCHS:
        c, pc, tc = smoke_params(torch, arch)
        c = dataclasses.replace(c, attn_impl="pallas")
        tc = tc[:2, :40]
        runs = {}
        for where, dev_ in (("card", dev), ("cpu", torch.device("cpu"))):
            routes, gaps = [], []

            def route(args, out):
                routes.append([t.cpu() for t in (args[0], *out)])

            def gap(args, out):
                s = torch.sort(args[0], dim=-1, descending=True).values
                k = args[1]
                gaps.append(float((s[:, k - 1] - s[:, k]).min()))

            build.reset_launches()
            with recording(moe_mod, "_routing_group", route), \
                    recording(moe_mod, "top_k", gap):
                logits = tf.forward(_to(pc, dev_), tc.to(dev_), c)[0].cpu()
            runs[where] = (logits, routes, min(gaps),
                           build.LAUNCHES["flash_attention"])
        (got, r_card, _, n_f32), (want, r_cpu, min_gap, _) = (
            runs["card"], runs["cpu"])
        err, top = float((got - want).abs().max()), float(want.abs().max())
        same = len(r_card) == len(r_cpu) == c.n_layers and all(
            torch.equal(a, b) for x, y in zip(r_card, r_cpu)
            for a, b in zip(x, y))
        if not (err <= 1e-4 * top and same and n_f32 == c.n_layers):
            fail(f"moe serve: {c.name} card vs CPU forward: max abs diff "
                 f"{err} (largest {top}), routing equal {same}, "
                 f"flash_attention launches {n_f32}")
        say(f"  {c.name}: card forward (kernel 12 f32 route, {n_f32} "
            f"launches) vs CPU (plain): max abs diff {err:.3g} (largest "
            f"|logit| {top:.4g}, tolerance 1e-4 of it); topi, slot_token, "
            f"pos and keep equal in all {c.n_layers} layers; smallest gap "
            f"between the k-th and (k+1)-th probability {min_gap:.3g}")


def moe_train_phase(torch, card: str):
    """The MoE FFN's training path: olmoe-1b-7b at its published widths in
    bf16, attn_impl="chunked", cut to 2 layers, batch 4 x seq 1024
    (MOE_TRAIN), as the train phase drives deepseek; then both MoE SMOKE
    configs in f32, the loss and every gradient on the card against the
    CPU."""
    from repro_torch.configs.registry import _load
    full = _load(MOE_TRAIN["arch"])[1]
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN["layers"],
                              attn_impl="chunked")
    out = train_steps(torch, cfg, full, MOE_TRAIN, card, "moe train")
    for arch in MOE_ARCHS:
        train_card_vs_cpu(torch, arch, "moe train")
    return out


# The recsys phase: AutoInt at its published widths
# (src/repro/configs/autoint.py), under the reference's recsys traffic
# (src/repro/configs/registry.py: REC_SHAPES); nothing is cut. The weights
# and the candidate vectors are made on the card from RECSYS["seed"], the
# ids by the reference's RecsysBatcher draws (zipf ids, field offsets).
RECSYS = dict(steps=3, seed=18, serve_reps=20, top_k=100)
# The gnn phase: each GNN config at its published widths and depth on its
# cell of GNN_SHAPES (src/repro/configs/registry.py), the input and output
# widths adapted to the cell as the reference's _gnn_cell does. GraphCast
# on minibatch_lg keeps about 6 GB of f32 activations a layer for the
# backward (17 tensors of [169,984, 512]), so its 16 layers do not fit the
# card; it is cut to GRAPHCAST_LAYERS, the most that fits (on an H100 80GB
# HBM3, 13 layers peak at 78.7e9 of the card's 85.0e9 bytes; a 14th would
# need 84.6e9).
GNN_CELLS = (("gat-cora", "minibatch_lg"), ("graphcast", "minibatch_lg"),
             ("egnn", "molecule"), ("mace", "molecule"))
GRAPHCAST_LAYERS = 13
GNN_STEPS = 3
GNN_SEED = 19
MOLECULE_ATOMS = 32            # 128 molecules of 32 atoms fill 4,096 nodes


def grads_card_vs_cpu(torch, loss_f, params, batch, cfg, label: str):
    """The loss and every gradient of ``loss_f`` on the card against the
    CPU (``params`` and ``batch`` on the CPU): 1e-4 relative in the loss,
    each gradient within 1e-3 of its largest value (the train phase's
    tolerances). Returns (loss relative difference, worst gradient)."""
    from repro_torch.models.params import tree_leaves, value_and_grad
    dev = torch.device("cuda")
    l_cpu, g_cpu = value_and_grad(loss_f, params, batch, cfg)
    l_gpu, g_gpu = value_and_grad(loss_f, _to(params, dev), _to(batch, dev),
                                  cfg)
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    worst = 0.0
    for a, b in zip(tree_leaves(g_gpu), tree_leaves(g_cpu), strict=True):
        err, top = float((a.cpu() - b).abs().max()), float(b.abs().max())
        worst = max(worst, err / top if top else (0.0 if err == 0 else
                                                   float("inf")))
    if not (rel <= 1e-4 and worst <= 1e-3):
        fail(f"{label}: card vs CPU: loss {rel:.3g} relative, gradients "
             f"{worst:.3g} of their largest value")
    return rel, worst


def _train_run(torch, step, params, opt, batches, label: str):
    """``len(batches)`` train steps, each synchronized and timed on the
    host clock; fails on a non-finite loss, gradient norm or parameter.
    Returns (params, losses, ms a step, peak bytes, bytes held before)."""
    import math
    from repro_torch.models.params import tree_leaves
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        if not (math.isfinite(loss) and math.isfinite(float(m["grad_norm"]))
                and all(bool(torch.isfinite(t).all())
                        for t in tree_leaves(params))):
            fail(f"{label}: step {i + 1} gave a non-finite loss, gradient "
                 f"norm or parameter")
    return params, losses, ms, torch.cuda.max_memory_allocated(), held


def serve_latency(torch, fn, reps: int):
    """(median, worst) ms of ``reps`` calls of ``fn``, each synchronized
    and timed on the host clock, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(walls), max(walls)


def recsys_phase(torch, np, card: str, out_dir: Path):
    """AutoInt at its published widths on the card: train, serve and
    retrieval under REC_SHAPES' traffic, no kernel launched; then the
    SMOKE config card vs CPU (module docstring: recsys); a profile of the
    serve_bulk call."""
    from repro_torch.configs.registry import REC_SHAPES, _load
    from repro_torch.data import RecsysBatcher
    from repro_torch.kernels import build
    from repro_torch.models import autoint as ai
    from repro_torch.models.params import materialize, n_params, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = _load("autoint")[1]
    defs = ai.autoint_param_defs(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(RECSYS["seed"])
    build.reset_launches()
    params = materialize(defs, gen, device=dev)
    say(f"recsys phase: {cfg.name} at its published widths, {cfg.n_sparse} "
        f"fields x {cfg.vocab_per_field} ids x {cfg.embed_dim} (table "
        f"{nbytes(params['table'])} B f32), {cfg.n_attn_layers} attention "
        f"layers of {cfg.n_heads} heads x {cfg.d_attn}, {n_params(defs)} "
        f"parameters ({nbytes(*tree_leaves(params))} B); no cut; {card}")

    def ids(B, seed):
        return RecsysBatcher(B, cfg.n_sparse, cfg.vocab_per_field,
                             cfg.multi_hot, seed=seed, device=dev)

    # ---- train: REC_SHAPES["train_batch"] --------------------------------
    B = REC_SHAPES["train_batch"]["batch"]
    data = ids(B, RECSYS["seed"])
    batches = [next(data) for _ in range(RECSYS["steps"])]
    step = ai.make_autoint_train_step(cfg, AdamWConfig())
    params, losses, ms, peak, held = _train_run(
        torch, step, params, adamw_init(params), batches, "recsys train")
    steady = statistics.median(ms[1:])
    say(f"  train_batch {B}: {RECSYS['steps']} AdamW steps, losses "
        + ", ".join(f"{x:.6f}" for x in losses) + "; ms a step "
        + ", ".join(f"{x:.1f}" for x in ms)
        + f" (the first with the allocator's growth); {B / steady * 1e3:.0f}"
        f" samples/s at the median of steps 2-{RECSYS['steps']} "
        f"({steady:.1f} ms); peak allocated {peak} B ({held} B of it the "
        f"weights, the optimizer state and the batches before the first "
        f"step)")
    del batches, data
    torch.cuda.empty_cache()

    # ---- serve: REC_SHAPES["serve_p99"] and ["serve_bulk"] ----------------
    serve = ai.make_autoint_serve_step(cfg)
    for shape in ("serve_p99", "serve_bulk"):
        B = REC_SHAPES[shape]["batch"]
        batch = {"sparse_idx": next(ids(B, RECSYS["seed"] + 1))[
            "sparse_idx"]}
        torch.cuda.reset_peak_memory_stats()
        med, worst = serve_latency(torch, lambda: serve(params, batch),
                                   RECSYS["serve_reps"])
        scores = serve(params, batch)
        if not (scores.shape == (B,) and bool(torch.isfinite(scores).all())
                and bool(((scores > 0) & (scores < 1)).all())):
            fail(f"recsys {shape}: scores {tuple(scores.shape)} not finite "
                 f"or outside (0, 1)")
        say(f"  {shape} batch {B}: latency median {med:.3f} ms, worst "
            f"{worst:.3f} ms of {RECSYS['serve_reps']}; {B / med * 1e3:.0f} "
            f"samples/s at the median; peak allocated "
            f"{torch.cuda.max_memory_allocated()} B")
        if shape == "serve_bulk":
            profile_run(torch, lambda: serve(params, batch),
                        out_dir / "chip_smoke_trace_autoint_serve.json",
                        f"autoint serve_bulk batch {B}")
        del batch, scores

    # ---- retrieval: REC_SHAPES["retrieval_cand"] -------------------------
    sh = REC_SHAPES["retrieval_cand"]
    cand = torch.randn((sh["n_candidates"], cfg.d_retrieval), generator=gen,
                       device=dev)
    query = {"sparse_idx": next(ids(sh["batch"], RECSYS["seed"] + 2))[
        "sparse_idx"], "cand_vecs": cand}
    retrieve = ai.make_retrieval_step(cfg, RECSYS["top_k"])
    med, worst = serve_latency(torch, lambda: retrieve(params, query),
                               RECSYS["serve_reps"])
    vals, idx = retrieve(params, query)
    q = ai.mlp_apply(params["retr_proj"], ai.autoint_embed(
        params, query, cfg), 1)
    at = (q[0] * cand[idx[0].long()]).sum(-1)
    best = torch.topk(q[0] @ cand.T, RECSYS["top_k"]).values
    if not (idx.shape == (sh["batch"], RECSYS["top_k"])
            and idx.dtype == torch.int32 and bool((vals[:, 1:]
                                                   <= vals[:, :-1]).all())
            and float((at - vals[0]).abs().max()) <= 1e-4 * float(
                vals.abs().max())
            and float((best - vals[0]).abs().max()) <= 1e-4 * float(
                vals.abs().max())):
        fail("recsys retrieval: the top-k is not the best scores in "
             "descending order")
    say(f"  retrieval_cand: 1 query vs {sh['n_candidates']} candidates, top "
        f"{RECSYS['top_k']}: latency median {med:.3f} ms, worst {worst:.3f} "
        f"ms of {RECSYS['serve_reps']}; values == the scores of the indices"
        f" and torch.topk's values")
    if any(build.LAUNCHES.values()):
        fail(f"recsys: a kernel was launched {build.LAUNCHES}")
    del params, cand, query, q
    torch.cuda.empty_cache()

    # ---- SMOKE: card vs CPU ----------------------------------------------
    c = dataclasses.replace(_load("autoint", smoke=True)[1], multi_hot=3)
    pc = materialize(ai.autoint_param_defs(c), torch.Generator().manual_seed(
        0), device="cpu")
    bc = next(RecsysBatcher(64, c.n_sparse, c.vocab_per_field, c.multi_hot,
                            seed=3, device="cpu"))
    bc["sparse_idx"].view(-1)[::5] = c.total_vocab       # padding sentinels
    s_cpu = ai.make_autoint_serve_step(c)(pc, bc)
    s_gpu = ai.make_autoint_serve_step(c)(_to(pc, dev),
                                          _to(bc, dev)).cpu()
    serr = float((s_gpu - s_cpu).abs().max()) / float(s_cpu.abs().max())
    if serr > 1e-4:
        fail(f"recsys smoke: serve scores card vs CPU {serr:.3g}")
    rel, worst = grads_card_vs_cpu(torch, ai.autoint_loss, pc, bc, c,
                                   "recsys smoke")
    base = torch.randn((512, c.d_retrieval), generator=torch.Generator()
                       .manual_seed(4))
    cands = base[torch.randint(0, 512, (4096,), generator=torch.Generator()
                               .manual_seed(5))]             # ties
    rq = {"sparse_idx": bc["sparse_idx"][:2], "cand_vecs": cands}
    v_cpu, i_cpu = ai.make_retrieval_step(c, 100)(pc, rq)
    v_gpu, i_gpu = ai.make_retrieval_step(c, 100)(_to(pc, dev),
                                                  _to(rq, dev))
    ties = int((v_cpu[:, 1:] == v_cpu[:, :-1]).sum())
    if not torch.equal(i_gpu.cpu(), i_cpu) or ties == 0:
        fail(f"recsys smoke: retrieval indices card vs CPU differ "
             f"({ties} ties)")
    say(f"  {c.name} (multi_hot 3, sentinels) f32 on the card vs the CPU: "
        f"serve scores within {serr:.3g} of the largest (tolerance 1e-4), "
        f"loss {rel:.3g} relative (1e-4), gradients within {worst:.3g} of "
        f"each one's largest value (1e-3); retrieval top 100 of 4096 "
        f"candidates with duplicated rows: indices equal ({ties} ties); "
        f"{time.perf_counter() - t_phase:.1f} s for the phase")


def gnn_cell(torch, arch: str, shape_id: str, gen):
    """(config, ParamDef tree, loss, batch on the card) of ``arch`` at its
    published widths on GNN_SHAPES[shape_id], the widths adapted as the
    reference's _gnn_cell does (GraphCast cut to GRAPHCAST_LAYERS): random
    edges over the whole graph as build_gnn makes them, or, on the batched
    molecule shape, edges inside molecules of MOLECULE_ATOMS atoms."""
    from repro_torch.configs.registry import GNN_SHAPES, _load
    from repro_torch.models import gnn
    dev = torch.device("cuda")
    sh = GNN_SHAPES[shape_id]
    N, E, Df = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    cfg = _load(arch)[1]
    if arch == "gat-cora":
        cfg = dataclasses.replace(cfg, d_in=Df, n_classes=sh["n_classes"])
    elif arch == "egnn":
        cfg = dataclasses.replace(cfg, d_in=Df)
    elif arch == "graphcast":
        cfg = dataclasses.replace(cfg, n_layers=GRAPHCAST_LAYERS)
    defs, _ = param_defs_of(arch, cfg)
    if arch == "graphcast":   # inputs follow the shape's d_feat
        defs["node_enc"] = gnn.mlp_defs([Df, cfg.d_hidden, cfg.d_hidden],
                                        ln=True)
    loss = gnn.MODELS[arch][2]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def randint(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if sh["batched"]:
        G = N // MOLECULE_ATOMS
        base = (torch.arange(E, device=dev, dtype=torch.int32)
                // (E // G)) * MOLECULE_ATOMS
        b = dict(edge_src=base + randint(MOLECULE_ATOMS, E),
                 edge_dst=base + randint(MOLECULE_ATOMS, E))
    else:
        b = dict(edge_src=randint(N, E), edge_dst=randint(N, E))
    if arch == "gat-cora":
        b["node_feat"] = randn(N, Df)
        b["labels"] = randint(sh["n_classes"], N)
    elif arch == "egnn":
        b["node_feat"] = randn(N, Df)
        b["coords"] = randn(N, 3)
        b["labels"] = randn(N)
    elif arch == "mace":
        b["node_feat"] = randint(cfg.n_species, N, 1).float()
        b["coords"] = randn(N, 3) * 2
        b["graph_id"] = (torch.arange(N, device=dev, dtype=torch.int32)
                         // MOLECULE_ATOMS)
        b["graph_energy"] = randn(N // MOLECULE_ATOMS)
    else:
        b["node_feat"] = randn(N, Df)
        b["edge_feat"] = randn(E, cfg.d_edge_in)
        b["labels"] = randn(N, cfg.n_vars)
    return cfg, defs, loss, b


def mace_invariance(torch, np, params, batch, cfg):
    """MACE's invariant (l = 0) features (h0, h1) of ``batch`` and of the
    same batch rotated by 0.9 rad about z."""
    from repro_torch.models import gnn
    th = 0.9
    R = torch.tensor([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]],
                     dtype=torch.float32, device=batch["coords"].device)
    with torch.no_grad():
        h0 = gnn.mace_forward(params, batch, cfg)[0]
        h1 = gnn.mace_forward(params, dict(batch, coords=batch["coords"]
                                           @ R.T), cfg)[0]
    return h0, h1


def gnn_phase(torch, np, card: str, out_dir: Path):
    """The GNN zoo on the card: each of GNN_CELLS at its published widths,
    3 AdamW steps, a profile of GraphCast's step, no kernel launched; then
    the SMOKE configs card vs CPU, MACE's rotation invariance and the
    gnn_products example (module docstring: gnn)."""
    from repro_torch.configs.registry import GNN_SHAPES, _load
    from repro_torch.examples import gnn_products
    from repro_torch.kernels import build
    from repro_torch.launch.train import build_gnn
    from repro_torch.models import gnn
    from repro_torch.models.params import materialize, n_params
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    build.reset_launches()
    for arch, shape_id in GNN_CELLS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(GNN_SEED)
        cfg, defs, loss, batch = gnn_cell(torch, arch, shape_id, gen)
        full = _load(arch)[1]
        sh = GNN_SHAPES[shape_id]
        params = materialize(defs, gen, device=dev)
        step = gnn.make_gnn_train_step(loss, cfg, AdamWConfig())
        params, losses, ms, peak, held = _train_run(
            torch, step, params, adamw_init(params), [batch] * GNN_STEPS,
            f"gnn {arch}")
        steady = statistics.median(ms[1:])
        cut = (f"depth cut {full.n_layers} -> {cfg.n_layers} layers"
               if cfg.n_layers != full.n_layers else "no cut")
        say(f"gnn phase {arch} on {shape_id} ({sh['n_nodes']} nodes, "
            f"{sh['n_edges']} edges, {sh['d_feat']} features): "
            f"{n_params(defs)} parameters, {cut}; {GNN_STEPS} AdamW steps "
            f"on one batch: losses " + ", ".join(f"{x:.6f}" for x in losses)
            + "; ms a step " + ", ".join(f"{x:.1f}" for x in ms)
            + f" ({steady:.1f} at the median of steps 2-{GNN_STEPS}); peak "
            f"allocated {peak} B ({held} B before the first step, "
            f"{(peak - held) / max(cfg.n_layers, 1):.0f} B a layer above "
            f"it); {card}")
        if arch == "graphcast":
            free, total = torch.cuda.mem_get_info()
            say(f"  graphcast: the card holds {total} B, {free} B free now; "
                f"peak reserved {torch.cuda.max_memory_reserved()} B; a "
                f"layer more would need about "
                f"{peak + (peak - held) / cfg.n_layers:.4g} B allocated")
            opt = adamw_init(params)
            profile_run(torch, lambda: step(params, opt, batch),
                        out_dir / "chip_smoke_trace_graphcast.json",
                        f"graphcast {cfg.n_layers} layers minibatch_lg, one "
                        f"train step")
            del opt
        if arch == "mace":
            h0, h1 = mace_invariance(torch, np, params, batch, cfg)
            inv = float((h0 - h1).abs().max()) / float(h0.abs().max())
            if inv > 1e-3:
                fail(f"gnn mace: full-width rotation invariance {inv:.3g} "
                     f"of the largest feature")
            say(f"  mace full width on the molecule batch: invariant "
                f"features of the rotated batch within {inv:.3g} of the "
                f"largest (tolerance 1e-3)")
            del h0, h1
        del params, batch, step
        torch.cuda.empty_cache()
    if any(build.LAUNCHES.values()):
        fail(f"gnn: a kernel was launched {build.LAUNCHES}")

    # ---- SMOKE configs card vs CPU on the launcher's graph ---------------
    for arch in ("gat-cora", "egnn", "mace", "graphcast"):
        c = _load(arch, smoke=True)[1]
        pc, _, data = build_gnn(arch, c, AdamWConfig(), "cpu")
        rel, worst = grads_card_vs_cpu(torch, gnn.MODELS[arch][2], pc,
                                       next(data), c, f"gnn smoke {arch}")
        say(f"  {c.name} f32 on the card vs the CPU (256 nodes, 1024 "
            f"edges): loss {rel:.3g} relative (tolerance 1e-4), gradients "
            f"within {worst:.3g} of each one's largest value (1e-3)")

    # ---- MACE's rotation invariance: tests/test_arch_smoke.py's check -----
    c = _load("mace", smoke=True)[1]
    pc = materialize(gnn.mace_param_defs(c), torch.Generator().manual_seed(
        2), device="cpu")
    rng = np.random.default_rng(0)
    n, e = 48, 128
    coords = rng.standard_normal((n, 3)).astype(np.float32) * 2
    bm = {k: torch.as_tensor(v, device=dev) for k, v in dict(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        node_feat=rng.integers(0, 10, (n, 1)).astype(np.float32),
        coords=coords).items()}
    h0, h1 = mace_invariance(torch, np, _to(pc, dev), bm, c)
    if not torch.allclose(h0, h1, rtol=1e-3, atol=1e-4):
        fail("gnn: MACE's invariant features change under a rotation on "
             "the card")
    say(f"  {c.name} on the card: rotation invariance holds (rtol 1e-3, "
        f"atol 1e-4; largest difference "
        f"{float((h0 - h1).abs().max()):.3g})")

    # ---- the example, as a user runs it ---------------------------------
    t0 = time.perf_counter()
    losses = gnn_products.main([])
    if len(losses) != 20 or not np.isfinite(losses).all():
        fail(f"gnn: examples/gnn_products.py losses {losses}")
    say(f"  examples gnn_products on the card: 20 steps, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{time.perf_counter() - t_phase:.1f} s for the phase")


def run_procs(cmds: dict, timeout: float = 600) -> dict:
    """Run each command of ``cmds`` ({name: argv}) from the checkout with
    the port on its path, all at once; {name: (exit code, output)}. Every
    process is waited for, and killed if it outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        outs = {name: p.communicate(timeout=timeout)[0]
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {name: (procs[name].returncode, out) for name, out in outs.items()}


def param_defs_of(arch: str, cfg):
    """(ParamDef tree, default dtype) of ``arch``'s config ``cfg``."""
    import torch
    from repro_torch.configs.registry import ARCHS
    family = ARCHS[arch][0]
    if family == "lm":
        from repro_torch.models import transformer as tf
        return tf.param_defs(cfg), cfg.dtype
    if family == "recsys":
        from repro_torch.models import autoint as ai
        return ai.autoint_param_defs(cfg), torch.float32
    from repro_torch.models import gnn
    return gnn.MODELS[arch][0](cfg), torch.float32


def train_launch_phase(torch, np):
    """The training entry point as a user starts it: ``python -m
    repro_torch.launch.train --arch <a>`` (LAUNCH_ARGS) on the card for
    each of LAUNCH_ARCHS, 6 steps with a checkpoint every 2 in a temporary
    directory, and beside it an uninterrupted 10-step run (all six
    processes at once); the checkpoint of step 6 restored on the card
    (onto params.abstract's meta tensors) equal to the files bit for bit;
    then the launcher again with --steps 10 on that directory (the three
    at once): it must print the resume from step 6, and its losses for
    steps 7-10 must be within LAUNCH_REL relative of the uninterrupted
    run's."""
    import tempfile
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.configs.registry import _load
    from repro_torch.models.params import abstract, tree_leaves
    from repro_torch.optim import AdamWState

    def losses_of(name, rc, out, printed: bool):
        for line in out.splitlines():
            say(f"  launch {name} | {line}")
        if rc != 0:
            fail(f"train launch {name}: exit {rc}")
        if printed:
            return [float(x.split("loss=")[1].split()[0])
                    for x in out.splitlines() if x.startswith("step ")]
        return json.loads(out.splitlines()[-1].removeprefix("losses "))

    def argv(arch):
        return ("--arch", arch, *LAUNCH_ARGS)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = {a: os.path.join(tmp, f"ckpt-{a}") for a in LAUNCH_ARCHS}
        cmds = {}
        for a in LAUNCH_ARCHS:
            cmds[a, "first"] = [sys.executable, "-m",
                                "repro_torch.launch.train", *argv(a),
                                "--steps", "6", "--ckpt-dir", ckpt[a],
                                "--ckpt-every", "2"]
            cmds[a, "whole"] = [sys.executable, "-c", LAUNCH_PROG, *argv(a),
                                "--steps", "10"]
        outs = run_procs(cmds)
        first, whole, n_leaves = {}, {}, {}
        for a in LAUNCH_ARCHS:
            first[a] = losses_of(f"{a} first", *outs[a, "first"],
                                 printed=True)
            whole[a] = losses_of(f"{a} whole", *outs[a, "whole"],
                                 printed=False)
            if latest_step(ckpt[a]) != 6 or sorted(os.listdir(ckpt[a])) != [
                    f"step_{s:08d}" for s in (2, 4, 6)]:
                fail(f"train launch {a}: checkpoints "
                     f"{sorted(os.listdir(ckpt[a]))}")
            defs, dtype = param_defs_of(a, _load(a, smoke=True)[1])
            target = (abstract(defs, dtype), AdamWState(
                step=torch.empty((), dtype=torch.int32, device="meta"),
                m=abstract(defs), v=abstract(defs)))
            restored = restore_checkpoint(ckpt[a], 6, target, device=dev)
            leaves = tree_leaves(restored)
            n_leaves[a] = len(leaves)
            for i, leaf in enumerate(leaves):
                want = np.load(os.path.join(ckpt[a], "step_00000006",
                                            f"leaf_{i:05d}.npy"))
                if (leaf.device.type != dev.type
                        or leaf.cpu().numpy().tobytes() != want.tobytes()):
                    fail(f"train launch {a}: restored leaf {i} differs from "
                         f"the saved one")
            if int(restored[1].step) != 6:
                fail(f"train launch {a}: restored step "
                     f"{int(restored[1].step)}")
            del restored, leaves
        outs = run_procs({a: [sys.executable, "-c", LAUNCH_PROG, *argv(a),
                              "--steps", "10", "--ckpt-dir", ckpt[a],
                              "--ckpt-every", "2"] for a in LAUNCH_ARCHS})
        resumed = {}
        for a in LAUNCH_ARCHS:
            resumed[a] = losses_of(f"{a} resumed", *outs[a], printed=False)
            if outs[a][1].splitlines()[0] != "resumed from step 6":
                fail(f"train launch {a}: the second run did not resume from "
                     f"step 6")
    for a in LAUNCH_ARCHS:
        r, w, f = resumed[a], whole[a], first[a]
        worst = max(abs(x - y) / abs(y) for x, y in zip(r, w[6:]))
        printed = max(abs(x - y) for x, y in zip(f, w[:6]))
        if not (len(r) == 4 and len(w) == 10 and worst <= LAUNCH_REL
                and printed <= 5e-5 + LAUNCH_REL * max(w)
                and (w[-1] < w[0] or a not in LAUNCH_FALLS)):
            fail(f"train launch {a}: resumed losses {r} vs the "
                 f"uninterrupted run's {w[6:]} ({worst:.3g} relative), the "
                 f"first run's {f} vs {w[:6]}")
        say(f"train launch: {' '.join(argv(a))} on the card: 6 steps with "
            f"checkpoints at 2, 4, 6; step 6 restored on the card from "
            f"params.abstract, {n_leaves[a]} leaves equal to the files bit "
            f"for bit; resumed from step 6 to 10: losses "
            + ", ".join(f"{x:.6f}" for x in r)
            + " vs the uninterrupted run's "
            + ", ".join(f"{x:.6f}" for x in w[6:])
            + f" (largest difference {worst:.3g} relative, tolerance "
            f"{LAUNCH_REL}); the first run's printed losses within "
            f"{printed:.2g} of the uninterrupted run's")
    say(f"train launch: {time.perf_counter() - t0:.1f} s wall for the "
        f"{3 * len(LAUNCH_ARCHS)} runs")


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("src/repro_torch not found: run from the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from repro_torch.core import (SsspConfig, SsspEngine, build_shards,
                                  build_shards_stream)
    from repro_torch.graph import (dijkstra_reference, preset_edge_stream,
                                   preset_graph, rmat_graph)
    from repro_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- build ---------------------------------------------------------
    build_s, logs = build.build()
    say(f"build: {build_s:.1f} s for {', '.join(build.KERNELS)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))

    # ---- the scale-1e6 graph and its dense shards -----------------------
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
    rng = np.random.default_rng(0)
    sources = live_sources(np, rng, g, 16)

    # ---- kernel phase: dense kernels at mid-solve state ------------------
    rows = dense_kernel_phase(torch, eng, sources, cfg, out_dir)
    for name, r in rows.items():
        say(f"  {name}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.2f} ms "
            f"plain, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
    cfg_f = SsspConfig(round="fused")
    eng_f = SsspEngine.build(eng.shards, cfg_f)
    rows.update(round_kernel_phase(torch, np, eng_f, sources, cfg_f, "round"))

    # ---- parity phase: card vs CPU through the port ----------------------
    gp, shp = parity_shards()
    srcp = live_sources(np, rng, gp, 4)
    on_gpu = SsspEngine.build(shp, cfg).solve(srcp)
    on_cpu = SsspEngine.build(shp, cfg, device="cpu").solve(srcp)
    same_results(on_gpu, on_cpu, "parity (card vs CPU)")
    if on_gpu.status != "converged":
        fail(f"parity: status {on_gpu.status}")
    build.reset_launches()
    fused_gpu = SsspEngine.build(shp, cfg_f).solve(srcp)
    rescued = check_fused(fused_gpu, on_gpu, dict(build.LAUNCHES), False,
                          "parity (fused vs staged, card)")
    fused_cpu = SsspEngine.build(shp, cfg_f, device="cpu").solve(srcp)
    same_results(fused_gpu, fused_cpu, "parity (fused, card vs CPU)")
    # the delta local solver (plain ops) and toka1 (on the staged kernels)
    for name, extra in (("delta", dict(local_solver="delta")),
                        ("toka1", dict(ALL_KERNELS, toka="toka1"))):
        c = SsspConfig(**extra)
        r_gpu = SsspEngine.build(shp, c).solve(srcp)
        same_results(r_gpu, SsspEngine.build(shp, c, device="cpu").solve(
            srcp), f"parity {name} (card vs CPU)")
        if r_gpu.status != "converged" or not np.array_equal(r_gpu.dist,
                                                             on_gpu.dist):
            fail(f"parity {name}: status {r_gpu.status}, or distances "
                 f"differ from the toka0 solve")
        say(f"parity {name}: card == CPU, distances == the toka0 solve's, "
            f"{int(r_gpu.stats.rounds)} rounds, q_relaxations "
            f"{r_gpu.q_relaxations.tolist()}")
    # every exchange (toka0), staged and fused; toka2 and toka3 under a
    # bucketed, a deferred and a dense exchange
    cases = [(f"{ex} {rnd}", dict(base, exchange=ex, **extra))
             for ex, extra in EXCHANGE_SETTINGS[1:]
             for rnd, base in (("staged", ALL_KERNELS),
                               ("fused", dict(round="fused")))]
    cases += [(f"{toka} {ex}", dict(ALL_KERNELS, exchange=ex, toka=toka))
              for toka in ("toka2", "toka3")
              for ex in ("bucket", "async", "a2a_dense")]
    for name, extra in cases:
        c = SsspConfig(**extra)
        r_gpu = SsspEngine.build(shp, c).solve(srcp)
        same_results(r_gpu, SsspEngine.build(shp, c, device="cpu").solve(
            srcp), f"parity {name} (card vs CPU)")
        if r_gpu.status != "converged" or not np.array_equal(r_gpu.dist,
                                                             on_gpu.dist):
            fail(f"parity {name}: status {r_gpu.status}, or distances "
                 f"differ from the bucket toka0 solve")
        say(f"parity {name}: card == CPU, distances == the bucket toka0 "
            f"solve's, {int(r_gpu.stats.rounds)} rounds, overlap_rounds "
            f"{int(r_gpu.stats.overlap_rounds)}, stale_merges "
            f"{int(r_gpu.stats.stale_merges)}")
    say(f"parity phase: rmat scale 11 ({gp.n_edges} edges, "
        f"{int(shp.tri_valid.sum())} triangles), P=8 K=4: card == CPU "
        f"staged and fused, fused == staged but n_dispatches "
        f"({int(fused_gpu.stats.n_dispatches)} vs "
        f"{int(on_gpu.stats.n_dispatches)}), rounds "
        f"{int(on_gpu.stats.rounds)}, rescued {rescued}, q_relaxations "
        f"{on_gpu.q_relaxations.tolist()}, pruned "
        f"{int(on_gpu.stats.pruned_edges)}")
    fault_parity(np, shp, srcp, on_gpu)

    # ---- scale phase: the dense path -------------------------------------
    eng.solve(sources[:1])          # warm-up: allocator, library loads
    torch.cuda.synchronize()
    build.reset_launches()
    res = eng.solve(sources)
    torch.cuda.synchronize()
    launches = {k: build.LAUNCHES[k] for k in STAGED}
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
        fail(f"scale: a dense kernel was not launched {launches}")
    say(f"scale phase: 16 queries converged, 4 match Dijkstra; launches "
        f"per K=16 solve {launches}")
    profile_run(torch, lambda: eng.solve(sources),
                out_dir / "chip_smoke_trace.json", "scale-1e6 dense K=16")
    build.reset_launches()
    res_f = eng_f.solve(sources)
    torch.cuda.synchronize()
    launches["round"] = build.LAUNCHES["round"]
    rescued = check_fused(res_f, res, dict(build.LAUNCHES), False,
                          "scale fused")
    say(f"scale phase fused K=16: {res_f.wall_s:.3f} s wall, "
        f"{int(res_f.stats.rounds)} rounds ({rescued} rescued), equal to "
        f"staged but n_dispatches; launches {dict(build.LAUNCHES)}")
    profile_run(torch, lambda: eng_f.solve(sources),
                out_dir / "chip_smoke_trace_fused.json",
                "scale-1e6 dense fused K=16")
    many_queries(np, eng, g, "scale-1e6 staged dense")
    many_queries(np, eng_f, g, "scale-1e6 fused dense")

    # ---- engine phase: warm start, result cache, drain, wrappers ---------
    engine_phase(torch, np, eng, eng_f, g, sources, res, res_f)

    # ---- async phase: every exchange at scale-1e6 dense (kernels 1, 3, 5, 7)
    del eng_f, res1, res_f
    torch.cuda.empty_cache()
    out6 = async_phase(torch, np, eng.shards, sources, "1e6 dense",
                       ragged=False)
    # ---- faults at scale-1e6 dense, the degraded solve, the draws -------
    clean6 = faults_phase(torch, np, eng.shards, sources, "1e6 dense",
                          False, out6)
    degraded_solve(np, eng.shards, sources,
                   clean6["staged", "bucket", "toka0"], "1e6 dense")
    draws_phase(torch)
    # ---- dist phase at scale-1e6 dense: 8 ranks, one shard each ----------
    one_shard_kernels(torch, eng, sources, cfg, "1e6 dense", False)
    dist_phase(torch, np, sh, eng, sources, DIST_JOBS_1E6, "1e6 dense",
               False, landmarks=live_sources(
                   np, np.random.default_rng(22), g, 8, avoid=sources),
               card=card)
    if torch.cuda.device_count() == 1:
        nccl_world_one(torch, np)
    # ---- layout-free shards, the phase hook, the per-shard wrappers -------
    bare6 = build_shards(g, 8, enumerate_triangles=False,
                         relax_layout=False, comm_layout=False)
    no_layout_phase(torch, eng.shards, bare6, sources, "1e6 dense", card)
    phase_fns_phase(torch, eng, sources, "1e6 dense", False, card)
    shard_wrappers_phase(torch, eng, sources, "1e6 dense", False)
    del eng, sh, res, out6, clean6, bare6
    torch.cuda.empty_cache()

    # ---- ragged vs dense at scale-1e6, from one stream --------------------
    n6, stream6 = preset_edge_stream("scale-1e6")
    chunks6 = list(stream6)
    t0 = time.perf_counter()
    rag6 = build_shards_stream(chunks6, n6, 8)
    t_rag = time.perf_counter() - t0
    g6 = concat_graph(np, chunks6, n6)
    den6 = build_shards(g6, 8, enumerate_triangles=False)
    src6 = live_sources(np, rng, g6, 16)
    results = {}
    for name, shards in (("ragged", rag6), ("dense", den6)):
        build.reset_launches()
        results[name] = SsspEngine.build(shards, cfg).solve(src6)
        fam = [k + ("_ragged" if name == "ragged" else "") for k in STAGED]
        if min(build.LAUNCHES[k] for k in fam) < 1 or sum(
                build.LAUNCHES.values()) != sum(build.LAUNCHES[k]
                                                for k in fam):
            fail(f"ragged vs dense: the {name} solve ran the wrong kernels "
                 f"{build.LAUNCHES}")
    same_results(results["ragged"], results["dense"],
                 "ragged vs dense (scale-1e6 stream)")
    rr = results["ragged"]
    if rr.status != "converged":
        fail(f"ragged vs dense: status {rr.status}")
    lr, ld = rag6.layout_bytes(), den6.layout_bytes()
    say(f"ragged phase: scale-1e6 stream ({g6.n_edges} edges), ragged "
        f"stream build {t_rag:.1f} s, rx {tuple(rag6.rx_src.shape)} vs dense "
        f"{tuple(den6.rx_src.shape)}, layouts {lr['total_bytes']} B vs "
        f"{ld['total_bytes']} B; K=16 ragged == dense: rounds "
        f"{int(rr.stats.rounds)}, relaxations {int(rr.stats.relaxations)}, "
        f"wall {rr.wall_s:.3f} s ragged, {results['dense'].wall_s:.3f} s "
        f"dense")
    many_queries(np, SsspEngine.build(rag6, cfg), g6,
                 "scale-1e6 staged ragged")
    del rag6, den6, results, rr, chunks6, g6

    # ---- scale-1e7: stream build, ragged kernels, the main path -----------
    t0 = time.perf_counter()
    n7, stream7 = preset_edge_stream("scale-1e7")
    chunks7 = list(stream7)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    sh7 = build_shards_stream(chunks7, n7, 8)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    bare7 = build_shards_stream(chunks7, n7, 8, relax_layout=False,
                                comm_layout=False)
    t_bare = time.perf_counter() - t0
    g7 = concat_graph(np, chunks7, n7)
    del chunks7
    lb7 = sh7.layout_bytes()
    say(f"scale-1e7: {n7} vertices, {g7.n_edges} edges, P=8, block "
        f"{sh7.block}, S {sh7.n_slots}; rx {tuple(sh7.rx_src.shape)} tx "
        f"{tuple(sh7.tx_src.shape)} mx {tuple(sh7.mx_pos.shape)} recv_idx "
        f"{tuple(sh7.recv_idx.shape)}; host: stream {t_gen:.1f} s, "
        f"build_shards_stream {t_build:.1f} s ({t_bare:.1f} s without "
        f"layouts); layouts {lb7['total_bytes']} B "
        f"ragged vs {lb7['dense_bytes']} B dense, "
        f"{lb7['bytes_per_edge']:.2f} B/edge (ideal "
        f"{lb7['ideal_bytes_per_edge']:.0f})")
    eng7 = SsspEngine.build(sh7, cfg)
    src7 = live_sources(np, rng, g7, 16)
    rows.update(ragged_kernel_phase(torch, eng7, src7, cfg))
    for name in ("relax_ragged", "send_ragged", "merge_ragged"):
        r = rows[name]
        say(f"  {name}: {r['ms']:.4f} ms kernel, {r['plain_ms']:.2f} ms "
            f"plain, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})"
            + (f", library {r['library_ms']:.4f} ms" if r["library_ms"]
               else ""))

    torch.cuda.synchronize()
    build.reset_launches()
    res = eng7.solve(src7)
    torch.cuda.synchronize()
    ragged_in_main = {k: v for k, v in build.LAUNCHES.items()
                      if k.endswith("_ragged")}
    dense_in_main = {k: build.LAUNCHES[k] for k in build.ROUND}
    launches.update(ragged_in_main)
    res1 = eng7.solve(src7[:1])
    for name, r in (("K=16", res), ("K=1", res1)):
        if r.status != "converged" or not r.q_converged.all():
            fail(f"main {name}: status {r.status}")
        if not np.isfinite(r.dist).any() or r.dist.shape[1] != n7:
            fail(f"main {name}: bad distances {r.dist.shape}")
        mteps = int(r.stats.relaxations) / r.wall_s / 1e6
        say(f"main path {name}: {r.wall_s:.3f} s wall, "
            f"{int(r.stats.rounds)} rounds, {int(r.stats.relaxations)} "
            f"relaxations, {mteps:.1f} MTEPS")
    if not np.array_equal(res1.dist[0], res.dist[0]):
        fail("main: the K=1 solve differs from row 0 of the K=16 solve")
    t0 = time.perf_counter()
    ref = scipy_dijkstra(np, g7, src7[:2])
    for i in range(2):
        if not np.allclose(res.dist[i], ref[i], rtol=RTOL, atol=ATOL):
            fail(f"main: source {src7[i]} disagrees with Dijkstra")
    if (min(ragged_in_main[f"{k}_ragged"] for k in STAGED) < 1
            or ragged_in_main["round_ragged"]
            or max(dense_in_main.values()) > 0):
        fail(f"main: launches ragged {ragged_in_main}, dense "
             f"{dense_in_main}")
    say(f"main path: 16 queries converged, 2 match scipy Dijkstra "
        f"({time.perf_counter() - t0:.1f} s); launches per K=16 solve "
        f"ragged {ragged_in_main}, dense {dense_in_main}")
    solve_median(eng7, src7, "main path K=16")

    # ---- landmark-warm against cold on the ragged shards (kernels 2, 4, 6)
    eng7w = SsspEngine.build(eng7.shards, SsspConfig(**ALL_KERNELS,
                                                     warm_start="landmark"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng7w.precompute_landmarks(
        live_sources(np, np.random.default_rng(23), g7, 8, avoid=src7))
    torch.cuda.synchronize()
    t_land = time.perf_counter() - t0
    build.reset_launches()
    res7w = eng7w.solve(src7)
    torch.cuda.synchronize()
    warm7 = launched(build, [f"{k}_ragged" for k in STAGED])
    if any(build.LAUNCHES[k] for k in build.ROUND):
        fail(f"warm 1e7: a dense kernel was launched {build.LAUNCHES}")
    if (not res7w.warm_started or res7w.status != "converged"
            or not res7w.q_converged.all()
            or not np.array_equal(res7w.dist, res.dist)):
        fail(f"warm 1e7: status {res7w.status}, or distances differ from "
             f"the cold solve")
    say(f"warm 1e7 K=16 (8 landmarks, precompute {t_land:.4f} s): "
        f"{rounds_of(res7w)} (cold {rounds_of(res)}); "
        f"{int(res7w.stats.relaxations)} relaxations (cold "
        f"{int(res.stats.relaxations)}); {res7w.wall_s:.4f} s "
        f"wall (cold {res.wall_s:.4f} s); median of 5 walls "
        f"{solve_median(eng7w, src7, '  warm 1e7 K=16'):.4f} s warm, "
        f"{solve_median(eng7, src7, '  cold 1e7 K=16'):.4f} s cold; == cold "
        f"bit for bit, "
        f"converged; launches {warm7}")
    del eng7w, res7w

    # ---- fused: round="fused" on the same shards and sources --------------
    eng7f = SsspEngine.build(eng7.shards, cfg_f)
    rows.update(round_kernel_phase(torch, np, eng7f, src7, cfg_f,
                                   "round_ragged"))
    torch.cuda.synchronize()
    build.reset_launches()
    resf = eng7f.solve(src7)
    torch.cuda.synchronize()
    fused_launches = dict(build.LAUNCHES)
    launches["round_ragged"] = fused_launches["round_ragged"]
    rescued = check_fused(resf, res, fused_launches, True, "fused K=16")
    build.reset_launches()
    resf1 = eng7f.solve(src7[:1])
    rescued1 = check_fused(resf1, res1, dict(build.LAUNCHES), True,
                           "fused K=1")
    for name, r, n in (("K=16", resf, rescued), ("K=1", resf1, rescued1)):
        mteps = int(r.stats.relaxations) / r.wall_s / 1e6
        say(f"fused path {name}: {r.wall_s:.3f} s wall, "
            f"{int(r.stats.rounds)} rounds ({n} rescued), "
            f"{int(r.stats.relaxations)} relaxations, {mteps:.1f} MTEPS")
    say(f"fused path: 16 queries converged, equal to the staged solves but "
        f"n_dispatches; launches per K=16 solve {fused_launches}")
    solve_median(eng7f, src7, "fused path K=16")
    profile_run(torch, lambda: eng7.solve(src7),
                out_dir / "chip_smoke_trace_1e7.json",
                "scale-1e7 ragged staged K=16")
    profile_run(torch, lambda: eng7f.solve(src7),
                out_dir / "chip_smoke_trace_1e7_fused.json",
                "scale-1e7 ragged fused K=16")
    del eng7f, res1, resf, resf1
    torch.cuda.empty_cache()

    # ---- async phase: every exchange at scale-1e7 ragged (2, 4, 6, 8) -----
    out7 = async_phase(torch, np, eng7.shards, src7, "1e7 ragged",
                       ragged=True)
    if not np.array_equal(out7["staged", "bucket"].dist, res.dist):
        fail("async 1e7: the bucket solve differs from the main path's")
    toka_phase(np, eng7.shards, src7, out7, "1e7 ragged")
    # ---- faults at scale-1e7 ragged, the injector's time a round ----------
    faults_phase(torch, np, eng7.shards, src7, "1e7 ragged", True, out7)
    injector_timing(torch, np, eng7.shards, src7, card)
    # ---- dist phase at scale-1e7 ragged: 8 ranks, one shard each ---------
    one_shard_kernels(torch, eng7, src7, cfg, "1e7 ragged", True)
    dist_phase(torch, np, sh7, eng7, src7, DIST_JOBS_1E7, "1e7 ragged", True,
               card=card)
    # ---- layout-free shards, the phase hook, the per-shard wrappers -------
    no_layout_phase(torch, eng7.shards, bare7, src7, "1e7 ragged", card)
    phase_fns_phase(torch, eng7, src7, "1e7 ragged", True, card)
    shard_wrappers_phase(torch, eng7, src7, "1e7 ragged", True)
    del eng7, sh7, g7, res, out7, bare7
    torch.cuda.empty_cache()

    # ---- the runner, as a user starts it ------------------------------------
    runner_phase()

    # ---- the standalone kernel API: kernels 9, 10, 11 and 13 ---------------
    for phase in (lambda: single_phase(torch, np, g, rng, out_dir),
                  lambda: embag_phase(torch, np)):
        new_rows, new_launches = phase()
        rows.update(new_rows)
        launches.update(new_launches)
        torch.cuda.empty_cache()

    # ---- the transformer serving path: kernel 12, then gemma-7b ------------
    rows.update(flash_phase(torch))
    torch.cuda.empty_cache()
    launches.update(serve_phase(torch, np, out_dir))
    torch.cuda.empty_cache()

    # ---- the transformer's training path: deepseek-7b at depth 2 ----------
    train_phase(torch, card)
    torch.cuda.empty_cache()

    # ---- the MoE FFN: olmoe-1b-7b and qwen3-moe serving and training, and
    # the training entry point with a resume ---------------------------------
    moe_serve_phase(torch, card, out_dir)
    torch.cuda.empty_cache()
    moe_train_phase(torch, card)
    torch.cuda.empty_cache()

    # ---- AutoInt and the GNN zoo at their published widths ----------------
    recsys_phase(torch, np, card, out_dir)
    torch.cuda.empty_cache()
    gnn_phase(torch, np, card, out_dir)
    torch.cuda.empty_cache()
    train_launch_phase(torch, np)
    say(f"total: {time.perf_counter() - t_start:.1f} s after the card query")

    table = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
              "replaces": SOURCES[name][1], "launches": launches[name],
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
