#!/usr/bin/env python3
"""Drive the PyTorch port of SP-Async, its transformer serving and
training paths (dense and MoE), AutoInt, the GNN zoo and the training
entry point, on one NVIDIA GPU and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py mesh     # the build, dist nccl, cards and mesh
    python3 chip_smoke.py cards    # the build and the cards part alone

Run from the root of a checkout; it needs one CUDA device and ``nvcc``.
With two cards or more the dist nccl phase runs (SSSP over NCCL, a rank
a card) and the mesh phase its NCCL part (with four, mistral-large-123b
at full depth) and the cards part (every kernel and entry point on a
card that is not current), which the run alone on four cards is for.
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
           entry point; then the fused round's (fused_round_wrappers):
           fused_round_pallas with bucket and with dense incoming
           (kernel 7 at 1e6, 8 at 1e7), fused_round_rescue (the relax
           and send kernels) and the oracle fused_round_ref, each
           bit-equal to its plain twin and to row 0 of its stacked body,
           the rescued round equal to the oracle;
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
  nccl     with two cards or more (before the mesh phase), the shmap
           backend over NCCL, one spawned rank a card, P = 4 with four
           cards (2 with two): scale-1e6 dense re-partitioned at P, K=16,
           the 11 configs of the dist phase's scale-1e6 jobs; scale-1e7
           ragged at P (staged and fused bucket, async_ppermute), the
           staged bucket solve traced on rank 0 (idle share, device time
           of the NCCL, relax, send and merge kernels, the host's reads
           and all-reduces a round); R-MAT 22, edge factor 16 (about 128M
           directed edges, ragged, built in a process of its own beside
           the other jobs, each rank loading its saved view), staged
           bucket: every rank on its own card with its shards and nothing
           on another card, equal to the sim engine on one card over the
           same P shards bit for bit (distances, every counter, status),
           each job's kernels launched by every rank; walls (second
           solve, first solve with NCCL's set-up) beside the sim's,
           collectives a round and their ms, each card's peak printed;
           then torchrun --nproc-per-node P of the runner with --backend
           shmap --dist-backend nccl on rmat scale 16, K=16, bucket and
           async_ppermute with toka2, each exiting 0 validated, rank 0's
           lines equal to a --backend sim run's but the walls. With one
           card a line says it did not run;
  cards    with two cards or more, in this process with card 0 current
           throughout (never torch.cuda.set_device): kernels 1-13 at the
           kernel phases' shapes, their operands made on card 0 and
           placed on the last card, each bit-equal to its plain version
           there (kernel 12 within its tolerances), its launch counted,
           card 0's allocation still (before, peak and after); the host
           time a call of kernels 10 and 11 there (the guard sets the
           card) and on card 0; the scale-1e7 ragged engine staged and
           fused on cuda:1 and the scale-1e6 dense all-kernel engine on
           cuda:2, each equal to the same engine on cuda:0 bit for bit,
           walls side by side; engine_for, submit and drain on cuda:1;
           the runner (RUNNER_ARGS) with --device cuda:1; gemma-7b at
           full width, 2 layers, bf16, examples/serve_decode.py's
           generate (4 x 2048, 4 decode steps) on cuda:3 against cuda:0
           (tokens equal, prefill logits within 2 bf16 ulps, kernel 12
           launched once a layer); AutoInt's serve step at batch 512 on
           cuda:1 bit-equal to cuda:0's; the training launcher with
           --device cuda:1 against cuda:0; each of these allocating
           nothing on card 0; then one host thread a card, each solving
           a K=16 batch on its card's engine and running kernels 10 and
           11 there, at once, equal to the serial runs, twice (batches
           rotated); and each kernel family with one operand on cuda:0
           raising ValueError before any launch. With one card a line
           says it did not run;
  mesh     the LMs under a (data, model) mesh of processes, in f32 (the
           ranks and one process differ by the order of f32 sums alone;
           in bf16 each run's own roundings would flip near ties): four
           gloo ranks sharing the card, each holding its shards of the
           weights (made on the card from the seed): mistral-large-123b
           at its published widths cut to 4 layers, 4 x 2048 prompts and
           16 greedy steps on (1, 4), and cut to 2 layers with one step
           on (2, 2) (FSDP gathers every weight every step through gloo);
           qwen3-moe-235b-a22b at its published widths cut to 4 layers
           (32 experts a rank), 4 x 512 prompts and 8 steps on (1, 4)
           under both MoE impls; olmoe-1b-7b cut to 2 layers, one AdamW
           step on 4 x 512 tokens on (2, 2); each against the
           one-process run on the same weights: greedy tokens exact, the
           last logits within 1e-4 of the largest, each token's experts
           exact but at near ties (1e-4 of a probability) and what those
           reach, the loss and gradient norm within 1e-5, the gradients
           (AdamW's first moments) within 1e-4 of each leaf's largest,
           the stepped parameters within 2 lr + 1 ulp; and
           mistral-large in bf16, 2 layers, 4 x 2048 and 8 steps on (1,
           4), its logits within 3e-2 of the largest and its greedy
           tokens exact where one process's top-2 gap exceeds twice
           that, a row's later logits held while its tokens agree; every
           rank's prefill launches kernel 12 (its route for the type) once a
           layer (at q [4, 24, 2048, 128], kv [4, 2, 2048, 128] on (1,
           4); the flash phase holds the kernel against its plain
           version at that shape), its decode none; the KV caches in the
           reference's layout, a rank's block of the sequence over model
           with every KV head (grown for decode by grow_caches), their
           bytes a rank printed beside the KV-heads layout's (a rank's
           query heads' KV heads over the whole sequence); TTFT and decode
           ms a step printed. With two cards or more the same over NCCL,
           one rank a card (with four, mistral-large at full depth in
           bf16 on (1, 4), its TTFT and decode ms a step beside the
           KV-heads layout's);
           with one, a line says it did not run. Then MESH_WIDE, a
           model axis wider than the KV heads: qwen3-moe-235b-a22b (4 KV
           heads) cut to 2 layers on (1, 8), 8 gloo ranks sharing the
           card, 4 x 512 prompts and 8 greedy steps in f32, against one
           process as above. In the same spawn, AutoInt and the GNN
           zoo at their published widths (MESH_MODELS, f32): AutoInt's
           train step at 65,536 and serving at 512 on (2, 2), the table
           over model and the batch over data, and retrieval of one
           query over 1e6 candidates on (1, 4); gat-cora and graphcast
           (cut to 2 layers: gloo moves its whole-graph gathers through
           the host) on minibatch_lg, egnn and mace on molecule (bonded:
           no self-loops, EGNN's coordinates at 0.3, where both stay well
           inside f32), one train step and the forward on (2, 2), node
           and edge rows over (data, model); each against one process on
           the card: one process's loss and gradient norm finite, the
           ranks' within 1e-5, first moments, gradients and outputs
           within 1e-4 of the largest, stepped parameters within 2 lr +
           1 ulp, retrieval's indices equal but at adjacent scores
           within 1e-5; each job's wall and peak a rank printed;
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
           uninterrupted 10-step run's;
  weights  materialize of the full-width AutoInt config from the threefry
           key prng.key(0) on the card (the reference's weights, drawn in
           slices of DRAW_SLICE elements): every leaf but the 624e6-entry
           table equal to the CPU's materialize within 4 ulp, the table
           on MATERIALIZE_SLICE entries at an offset drawn on the CPU
           alone (uniform bits exact, weights within 4 ulp); time, peak
           memory, and the transients a slice leaves against a whole
           draw's; no kernel launched;
  dryrun   python -m repro_torch.launch.dryrun --all --both-meshes (the
           registry's 44 cells on the production meshes (16, 16) and (2,
           16, 16), rank 0 on the dry run's stand-in process group) and
           --all --one-card (every cell on one H100), both on meta
           tensors, host work with no card, started after the build at
           nice 19 so that they run beside the card's phases; each must
           exit 0: the production sweep with its 88 records ok but the
           reference's 10 long_500k skips, collective bytes in every LM,
           GNN and AutoInt record, mistral-large-123b decode_32k's caches
           at 5,905,580,032 B a rank, and its LM table printed; the
           one-card sweep with every cell recorded (counted FLOPs for the
           LM, GNN and recsys cells, the SSSP cells' note) and its table
           of cells; then the AutoInt train_batch and
           gat-cora full_graph_sm cells built for real on the card, the
           bytes allocated within 1% of the dry run's argument_bytes, and
           one step of each with a finite loss.

The line before last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``. Build logs and traces go to chiprun_out/.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
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
                # a rank's heads on a model axis of 4 (the mesh phase)
                "mistral-large-123b model=4 rank": (4, 24, 2, 2048, 128),
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


def one_ax():
    """The LM steps' mesh axes on one process (the reference's (1, 1)
    host mesh)."""
    from repro_torch.distributed.sharding import MeshAxes
    return MeshAxes(data=("data",))


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
    guard_cost(torch, {"kernel 3": lambda: send_pack_tiled(*s_args,
                                                           sb=dsh.tx_sb),
                       "kernel 5": calls["kernel 5"]})
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


@contextlib.contextmanager
def unguarded_launches(guard_only: bool = False):
    """The wrappers' launch path without the device guard, for timing it:
    each launch as the wrappers made it before ``build.call`` (the stream
    of the operands' card, the call, the check; no current-card compare).
    With ``guard_only`` that is all that goes; without it, the rest of the
    parent's path comes back too: each query calls its library (no kept
    values) and no same-card check."""
    import importlib
    from repro_torch.kernels import build
    mods = [] if guard_only else [
        importlib.import_module(f"repro_torch.kernels.{m}.{m}")
        for m in ("relax", "send", "merge", "round", "flash_attention",
                  "embedding_bag")]
    guarded = build.call

    def call(lib, symbol, device, *args, launch=None):
        if launch is None:
            return (guarded(lib, symbol, device, *args) if guard_only
                    else getattr(lib, symbol)(*args))
        code = getattr(lib, symbol)(*args, build.current_stream(device))
        build.check(lib, launch, code)
        return code

    def same_card(name, first, *operands):
        while isinstance(first, (tuple, list)):
            first = first[0]
        return first.device

    saved = [(build, "call", build.call)] + [(m, "same_card", m.same_card)
                                             for m in mods]
    build.call = call
    for m in mods:
        m.same_card = same_card
    try:
        yield
    finally:
        for obj, name, val in saved:
            setattr(obj, name, val)


def guard_turns(torch, ways) -> list[str]:
    """Host time a call of each way of ``ways`` = [(name, fn, ctx)], in
    CARDS_GUARD_TURNS["reps"] turns of CARDS_GUARD_TURNS["calls"] calls a
    way under ``ctx()``, no synchronize among a turn's calls, the ways'
    order rotated a turn, so that a slow spell of the shared host falls
    on every way alike. The last way is the baseline. Returns a phrase a
    way: the median over the turns, and for the others the share over the
    baseline's median and the median over the turns of the difference
    from the baseline in the same turn."""
    n_calls, n = CARDS_GUARD_TURNS["calls"], len(ways)
    times = [[] for _ in ways]
    for turn in range(CARDS_GUARD_TURNS["reps"]):
        for i in ((j + turn) % n for j in range(n)):
            _, fn, ctx = ways[i]
            with ctx():
                fn()
                cards_sync(torch)
                t0 = time.perf_counter()
                for _ in range(n_calls):
                    fn()
                times[i].append(1e3 * (time.perf_counter() - t0) / n_calls)
                cards_sync(torch)
    base = statistics.median(times[-1])
    out = []
    for (name, _, _), t in zip(ways, times):
        m = statistics.median(t)
        out.append(f"{name} {m:.4f} ms" + ("" if t is times[-1] else (
            f" ({100 * (m / base - 1):+.1f}%, paired "
            f"{1e3 * statistics.median(a - b for a, b in zip(t, times[-1])):+.2f}"
            f" us)")))
    return out


def guard_cost(torch, calls: dict):
    """Host time a call of each of ``calls`` on the current card three
    ways (``guard_turns``): as the wrappers are (the device guard compares
    the cards and enters nothing; the same-card check; kept query values),
    without the device guard, and on the parent's path
    (``unguarded_launches()``, the baseline)."""
    for name, fn in calls.items():
        say(f"  {name}: host a call, medians of {CARDS_GUARD_TURNS['reps']} "
            f"turns of {CARDS_GUARD_TURNS['calls']} calls: " + ", ".join(
                guard_turns(torch, [
                    ("as is", fn, contextlib.nullcontext),
                    ("no device guard", fn,
                     lambda: unguarded_launches(guard_only=True)),
                    ("parent's path", fn, unguarded_launches)])))


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
    calls = {
        "kernel 11": lambda: relax_dst_tiled(d, *lay, vb=vb, chunks=chunks),
        "kernel 10": lambda: relax_dst_tiled_masked(*args9, vb=vb,
                                                    chunks=chunks),
        "kernel 11 pre-pass": lambda: relax_dst_tiled(d, *lay, vb=vb),
        "kernel 10 pre-pass": lambda: relax_dst_tiled_masked(*args9, vb=vb)}
    runs = three_way(torch, calls, out_dir)
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
    # the launch path's host time with the guard and without it, in turns
    guard_cost(torch, {k: fn for k, fn in calls.items()
                       if "pre-pass" not in k})
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
    prefill = tf.make_prefill_step(cfg, one_ax())
    serve = tf.make_serve_step(cfg, one_ax(), donate=True)   # written in place
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
    params = materialize(tf.param_defs(cfg, one_ax()), gen, device=dev,
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
    lx = tf.make_prefill_step(cfg_x, one_ax())(params, {"tokens": prompts})[0]
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
    p4 = materialize(tf.param_defs(cfg4, one_ax()), gen, device=dev,
                     default_dtype=cfg4.dtype)
    Bc, S = DEPTH_CHECK["batch"], DEPTH_CHECK["seq"]
    pre = S - 4
    t4 = torch.randint(0, cfg4.vocab_size, (Bc, S), generator=gen, device=dev,
                       dtype=torch.int32)
    build.reset_launches()
    full, _, _ = tf.forward(p4, t4, cfg4, one_ax())
    _, kvs = tf.make_prefill_step(cfg4, one_ax())(p4, {"tokens": t4[:, :pre]})
    n_f32 = build.LAUNCHES["flash_attention"]
    if n_f32 != 2 * cfg4.n_layers or sum(build.LAUNCHES.values()) != n_f32:
        fail(f"serve: depth-4 f32 forward and prefill launches "
             f"{build.LAUNCHES}, want flash_attention {2 * cfg4.n_layers}")
    c4 = tuple(F.pad(t, (0, 0, 0, 0, 0, S - pre)) for t in kvs)
    worst = 0.0
    for i in range(pre, S):
        lg, c4 = tf.make_serve_step(cfg4, one_ax())(p4, t4[:, i:i + 1], c4, i)
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
        pc = materialize(tf.param_defs(c, one_ax()),
                         torch.Generator().manual_seed(0),
                         device="cpu", default_dtype=c.dtype)
        tc = torch.randint(0, c.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(1))
        got = tf.forward(_to(pc, dev), tc.to(dev), c, one_ax())[0].cpu()
        err = float((got - tf.forward(pc, tc, c, one_ax())[0]).abs().max())
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
              queue, trace=None):
    """One rank of the dist phase, a spawned process: joins the mesh of
    ``world`` processes over ``backend`` (gloo: every rank on card 0;
    nccl: rank r on card r), builds a shmap engine on its shard ``view``
    (a one-shard ``SsspShards``, or the path of one the parent saved) for
    each job and solves ``sources`` three times: the first run (its
    launches counted), a second (its wall) and a third with the
    collectives timed. With ``trace`` (a job's name) every rank solves that
    job a fourth time, rank 0 under torch.profiler (``trace`` = (name,
    path)). Puts (rank, "ok", results) on ``queue``; rank 0's results carry
    the distances, the others a digest of them; each carries the rank's
    current card, its shards' card and the bytes it holds on any other
    card."""
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
        torch.cuda.set_device(rank if backend == "nccl" else 0)
        mesh = make_host_mesh((world,), ("data",), backend=backend,
                              init_method=init, rank=rank, world_size=world,
                              timeout=DIST_TIMEOUT)
        if isinstance(view, str):
            view = torch.load(view, weights_only=False)
        own = torch.cuda.current_device()
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
            eng.comm.timed = False
            prof = None
            if trace is not None and trace[0] == name:
                prof = traced_solve(torch, eng, sources, trace[1], rank == 0)
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
                peak=torch.cuda.max_memory_allocated(), device=own,
                shard_device=eng.shards.device.index,
                elsewhere=sum(torch.cuda.memory_allocated(d)
                              for d in range(torch.cuda.device_count())
                              if d != own),
                profile=prof))
            del eng
            torch.cuda.empty_cache()
        queue.put((rank, "ok", out))
        tdist.destroy_process_group()
    except BaseException:
        import traceback
        queue.put((rank, "error", traceback.format_exc()))
        raise


def traced_solve(torch, eng, sources, path: str, record: bool):
    """One more solve of ``sources`` on a shmap rank (every rank calls it:
    it makes the solve's collectives); with ``record`` under
    torch.profiler, its trace written to ``path`` and summarized
    (``nccl_profile``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if record else contextlib.nullcontext())
    with ctx as prof:
        with record_function("run"):
            res = eng.solve(sources)
            torch.cuda.synchronize()
    if not record:
        return None
    prof.export_chrome_trace(path)
    return dict(nccl_profile(json.loads(Path(path).read_text())
                             ["traceEvents"]),
                rounds=int(res.stats.rounds))


# the kernels of a shmap rank's round, by the name their device events carry
NCCL_KINDS = (("nccl", ("nccl",)), ("relax", ("relax", "live_")),
              ("send", ("send", "interleave")), ("merge", ("merge",)))


def nccl_profile(events) -> dict:
    """A rank's traced solve (chrome-trace ``events``, the ``run``
    annotation its window): the window, the device's busy time and idle
    share, device time by kind (NCCL_KINDS, the rest "other"), and the host
    time in the round's vote: the ``_local_scalar_dense`` waits (the host
    reading a device value: ``bool(done.all())`` once a round, after the
    detector's all-reduce) and the CPU time of issuing the all-reduces
    (the ``c10d::allreduce_`` ops)."""
    win = next(e for e in events if e.get("name") == "run"
               and e.get("cat") == "user_annotation")
    t0, t1 = win["ts"], win["ts"] + win["dur"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel" and t0 <= e["ts"] < t1)
    busy, end = 0.0, t0
    for s, f, _ in kernels:
        busy += max(0.0, f - max(s, end))
        end = max(end, f)
    by_kind = {k: 0.0 for k, _ in NCCL_KINDS}
    by_kind["other"] = 0.0
    for s, f, name in kernels:
        low = name.lower()
        kind = next((k for k, keys in NCCL_KINDS
                     if any(x in low for x in keys)), "other")
        by_kind[kind] += f - s
    cpu = [e for e in events if e.get("cat") == "cpu_op"
           and t0 <= e["ts"] < t1]
    reads = [e["dur"] for e in cpu if e["name"] == "aten::_local_scalar_dense"]
    calls = [e["dur"] for e in cpu if e["name"] == "c10d::allreduce_"]
    return dict(window_ms=win["dur"] / 1e3, busy_ms=busy / 1e3,
                idle=1 - busy / win["dur"], kernels=len(kernels),
                by_kind_ms={k: v / 1e3 for k, v in by_kind.items()},
                reads=len(reads), read_ms=sum(reads) / 1e3,
                allreduces=len(calls), allreduce_ms=sum(calls) / 1e3)


def run_dist(views, backend: str, init: str, jobs, sources, landmarks,
             label: str, trace=None):
    """Spawn one ``dist_rank`` a view and collect every rank's results
    (rank order); fails on a rank's error or a timeout, and stops every
    process it started."""
    import queue as queue_mod

    import torch.multiprocessing as tmp
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=dist_rank, args=(
        r, len(views), backend, init, v, jobs, sources, landmarks, q, trace))
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


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_phase(torch, np, sh, dsh, sources, jobs, label: str, ragged: bool,
               landmarks=(), card: str = "", backend: str = "gloo",
               views=None, trace=None):
    """The shmap backend on the card. Under gloo, ``DIST_RANKS`` ranks
    (spawned processes sharing card 0); under nccl, one rank a card. One
    shard each (``views``, by default ``sh``'s; a view may be the path of
    one saved), the kernels built before they start; the ranks solve each
    job's config over the K sources; every rank's result must equal the
    sim engine's solve on card 0 over the same shards (``dsh``) bit for
    bit (distances, every counter, status), every rank the same, each
    job's kernels launched by every rank; under nccl, every rank on a
    card of its own, its shards there and nothing on another card. The
    walls of the P-rank solve and the sim's, the time a round spent in
    collectives and each rank's peak are printed (gloo: ranks
    time-sliced on one card, not a deployment's speed). Returns every
    rank's results."""
    import tempfile
    from repro_torch.core import SsspEngine
    sims = {}
    for name, kw, warm in jobs:
        e = SsspEngine.build(dsh, _config(kw))
        if warm:
            e.precompute_landmarks(list(landmarks))
        e.solve(sources)
        sims[name] = e.solve(sources)
        del e
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if views is None:
        views = [sh.shard(r) for r in range(sh.n_parts)]
    n = len(views)
    with tempfile.TemporaryDirectory() as tmp:
        init = (f"tcp://localhost:{free_port()}" if backend == "nccl"
                else f"file://{tmp}/store")
        t0 = time.perf_counter()
        per_rank = run_dist(views, backend, init, list(jobs), list(sources),
                            list(landmarks), f"{backend} {label}", trace)
        wall = time.perf_counter() - t0
    nccl = backend == "nccl"
    for i, (name, kw, warm) in enumerate(jobs):
        r0 = per_rank[0][i]
        what = f"dist {'nccl ' if nccl else ''}{label} {name}"
        sim = sims[name]
        same_results(_Ranked(r0), sim, f"{what} ({n} ranks vs sim)")
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
            if nccl and (x["device"] != r or x["elsewhere"]
                         or x["shard_device"] != r):
                fail(f"{what}: rank {r} runs on card {x['device']}, its "
                     f"shards on card {x['shard_device']}, "
                     f"{x['elsewhere']} B on other cards")
        if r0["status"] != "converged" or r0["warm"] != warm:
            fail(f"{what}: status {r0['status']}, warm {r0['warm']}")
        expect = _expected_kernels(kw, ragged)
        counts = {k: [res[i]["launches"].get(k, 0) for res in per_rank]
                  for k in expect}
        if any(min(v) < 1 for v in counts.values()):
            fail(f"{what}: a kernel of the path was not launched on every "
                 f"rank {counts}")
        rounds = int(r0["stats"].rounds)
        coll = max(res[i]["coll_s"] for res in per_rank)
        calls = r0["coll_calls"]
        peaks = ", ".join(f"{res[i]['peak'] / 2**30:.3f}" for res in per_rank)
        say(f"{what}: {n} ranks"
            + (f" on cards {[res[i]['device'] for res in per_rank]}"
               if nccl else "")
            + f" == sim bit for bit, {rounds} rounds; wall {r0['wall']:.4f} s"
            f" on {n} {'cards' if nccl else 'ranks'} (second solve; slowest "
            f"rank {max(res[i]['wall'] for res in per_rank):.4f} s) vs "
            f"{sim.wall_s:.4f} s sim on one card; first solve "
            f"{r0['first_wall']:.4f} s; collectives "
            f"{coll / max(rounds, 1) * 1e3:.3f} ms a round ("
            f"{calls / max(rounds, 1):.1f} calls a round; most over ranks, "
            f"timed solve {r0['timed_wall']:.4f} s); peak GiB a rank "
            f"[{peaks}]; launches a rank {counts}")
    if nccl:
        say(f"dist nccl {label}: {len(jobs)} configs on {n} NCCL ranks, one "
            f"a card, every rank == the sim engine on one card bit for bit;"
            f" {wall:.1f} s for the part ({card} each)")
    else:
        say(f"dist {label}: {len(jobs)} configs on {n} gloo ranks "
            f"(all_reduce, all_to_all_single and all_gather_single on CUDA "
            f"tensors, none staged through the host), every rank == the sim "
            f"engine bit for bit; {wall:.1f} s for the phase. These are "
            f"{n} ranks time-sliced on one card ({card}), not a "
            f"deployment's speed.")
    return per_rank


def nccl_world_one(torch, np):
    """NCCL at world size 1 (one card, one rank): the parity graph as one
    shard, the all-kernel staged config, equal to the sim engine on the
    same card bit for bit."""
    from repro_torch.core import SsspEngine, build_shards
    from repro_torch.graph import rmat_graph
    g1 = rmat_graph(scale=11)
    sh1 = build_shards(g1, 1)
    srcs = live_sources(np, np.random.default_rng(5), g1, 4)
    job = ("nccl world 1", dict(ALL_KERNELS), False)
    sim = SsspEngine.build(sh1, _config(job[1])).solve(srcs)
    res = run_dist([sh1.shard(0)], "nccl", f"tcp://localhost:{free_port()}",
                   [job], srcs, [], "nccl")[0][0]
    same_results(_Ranked(res), sim, "dist nccl world 1 vs sim")
    say(f"dist nccl world 1: rmat scale 11 as one shard, K=4, == sim bit "
        f"for bit, {int(res['stats'].rounds)} rounds, wall {res['wall']:.4f}"
        f" s vs {sim.wall_s:.4f} s sim; launches {res['launches']}")


# --------------------------------------------------------------------------
# the dist phase over NCCL: one rank a card, with two cards or more
# --------------------------------------------------------------------------

DIST_NCCL_JOBS_1E7 = (
    ("bucket staged", dict(ALL_KERNELS), False),
    ("bucket fused", dict(round="fused"), False),
    ("async_ppermute staged", dict(ALL_KERNELS, exchange="async_ppermute"),
     False),
)
# an R-MAT graph past the bench's scale-1e7: 4,194,304 vertices, about
# 128M directed edges, ragged; its views built beside the other jobs
DIST_BIG = dict(scale=22, edge_factor=16, seed=800)
DIST_BIG_JOBS = (("bucket staged", dict(ALL_KERNELS), False),)
DIST_BIG_WAIT = 600            # seconds the phase waits for that build
DIST_K = 16
# the runner under torchrun over NCCL, and as a sim run on one card
RUNNER_NCCL_ARGS = ("--graph", "rmat", "--scale", "16", "--num-sources",
                    "16", "--validate")
RUNNER_NCCL_RUNS = {"bucket": ("--exchange", "bucket"),
                    "async_ppermute toka2": ("--exchange", "async_ppermute",
                                             "--toka", "toka2")}
RUNNER_WALLS = re.compile(r"\d+\.\d+s\b|MTEPS=[\d.]+|queries/s=[\d.]+")


def live_of_chunks(np, chunks, n: int, rng, k: int):
    """``k`` sources drawn by ``rng`` among the vertices with an out-edge
    in the edge ``chunks``, sorted."""
    deg = np.zeros(n, np.int64)
    for c in chunks:
        deg += np.bincount(c[0], minlength=n)
    return sorted(int(s) for s in rng.choice(np.flatnonzero(deg), k,
                                             replace=False))


def big_build(out: str, parts: str, scale: str, edge_factor: str,
              seed: str):
    """An R-MAT graph (``rmat_edge_stream``) streamed and built ragged at
    ``parts`` shards (``build_shards_stream``), each rank's view saved to
    ``out/view<r>.pt`` and its facts to ``out/meta.json``: run in a
    process of its own, beside the other NCCL jobs (``start_big_build``)."""
    import numpy as np
    import torch
    from repro_torch.core import build_shards_stream
    from repro_torch.graph import rmat_edge_stream
    torch.set_num_threads(4)
    parts, scale, seed = int(parts), int(scale), int(seed)
    n = 1 << scale
    t0 = time.perf_counter()
    chunks = list(rmat_edge_stream(scale, int(edge_factor), seed))
    t_stream = time.perf_counter() - t0
    sources = live_of_chunks(np, chunks, n, np.random.default_rng(seed),
                             DIST_K)
    t0 = time.perf_counter()
    sh = build_shards_stream(chunks, n, parts)
    t_build = time.perf_counter() - t0
    del chunks
    lb = sh.layout_bytes()
    t0 = time.perf_counter()
    for r in range(parts):
        torch.save(sh.shard(r), f"{out}/view{r}.pt")
    Path(out, "meta.json").write_text(json.dumps(dict(
        n=n, n_edges=lb["n_edges"], layout_bytes=lb["total_bytes"],
        bytes_per_edge=lb["bytes_per_edge"], block=sh.block,
        rx=list(sh.rx_src.shape), sources=sources, t_stream=t_stream,
        t_build=t_build, t_save=time.perf_counter() - t0)))


def start_big_build(parts: int):
    """``big_build`` of DIST_BIG started now in a process of its own (no
    card visible); returns (the process, its directory, a function that
    stops it and removes the directory, also called at exit)."""
    import atexit
    import shutil
    import tempfile
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_big_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    log = open(out / "log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.big_build(*sys.argv[1:])", str(out), str(parts),
         *(str(DIST_BIG[k]) for k in ("scale", "edge_factor", "seed"))],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(out, ignore_errors=True)
    atexit.register(stop)
    return proc, out, stop


def stack_views(views):
    """The full stack of one-shard views (rank order): each array's rows
    end to end, as ``build_shards`` lays them."""
    import torch
    arrays = {k: torch.cat([v.arrays()[k] for v in views])
              for k in views[0].arrays()}
    return dataclasses.replace(views[0], **arrays, shard_id=None,
                               inter_total=None)


def dist_nccl_phase(torch, np, card: str, out_dir: Path):
    """The shmap backend over NCCL, one rank a card, P = 4 with four cards
    (2 with two; with one it says so and returns): at scale-1e6 dense
    (re-partitioned at P) the 11 jobs of DIST_JOBS_1E6, at scale-1e7
    ragged those of DIST_NCCL_JOBS_1E7 (the first traced on rank 0), on
    the DIST_BIG graph (built beside the others) DIST_BIG_JOBS: every rank
    == the sim engine on one card over the same P shards bit for bit
    (``dist_phase``); then the runner under torchrun over NCCL
    (``nccl_runner``)."""
    from repro_torch.core import build_shards, build_shards_stream
    from repro_torch.graph import preset_edge_stream, preset_graph
    n = torch.cuda.device_count()
    if n < 2:
        say(f"dist nccl: not run: {n} CUDA device on this machine; NCCL "
            f"takes one rank a card")
        return
    P = 4 if n >= 4 else 2
    t_phase = time.perf_counter()
    big, big_dir, big_stop = start_big_build(P)
    try:
        # ---- scale-1e6 dense at P -----------------------------------------
        t0 = time.perf_counter()
        g = preset_graph("scale-1e6")
        sh = build_shards(g, P, enumerate_triangles=False)
        say(f"dist nccl: scale-1e6 ({g.n_vertices} vertices, {g.n_edges} "
            f"edges) at P={P}, block {sh.block}, K={DIST_K}; host build "
            f"{time.perf_counter() - t0:.1f} s")
        sources = live_sources(np, np.random.default_rng(0), g, DIST_K)
        landmarks = live_sources(np, np.random.default_rng(22), g, 8,
                                 avoid=sources)
        dist_phase(torch, np, sh, sh.to("cuda"), sources, DIST_JOBS_1E6,
                   "1e6 dense", False, landmarks=landmarks, card=card,
                   backend="nccl")
        del g, sh
        torch.cuda.empty_cache()
        # ---- scale-1e7 ragged at P, the staged bucket solve traced ---------
        t0 = time.perf_counter()
        n7, stream7 = preset_edge_stream("scale-1e7")
        chunks7 = list(stream7)
        sh7 = build_shards_stream(chunks7, n7, P)
        src7 = live_of_chunks(np, chunks7, n7, np.random.default_rng(7),
                              DIST_K)
        del chunks7
        say(f"dist nccl: scale-1e7 ragged at P={P}, block {sh7.block}, rx "
            f"{tuple(sh7.rx_src.shape)}, K={DIST_K}; host stream and build "
            f"{time.perf_counter() - t0:.1f} s")
        trace = (DIST_NCCL_JOBS_1E7[0][0],
                 str(out_dir / "chip_smoke_trace_nccl_1e7.json"))
        per_rank = dist_phase(torch, np, sh7, sh7.to("cuda"), src7,
                              DIST_NCCL_JOBS_1E7, "1e7 ragged", True,
                              card=card, backend="nccl", trace=trace)
        say_nccl_profile(per_rank[0][0]["profile"],
                         f"scale-1e7 ragged {trace[0]}, rank 0 of {P}", card)
        del sh7
        torch.cuda.empty_cache()
        # ---- the runner under torchrun -------------------------------------
        nccl_runner(P, card)
        # ---- the big graph --------------------------------------------------
        try:
            rc = big.wait(timeout=DIST_BIG_WAIT)
        except subprocess.TimeoutExpired:
            fail(f"dist nccl: the R-MAT {DIST_BIG['scale']} build outlived "
                 f"{DIST_BIG_WAIT} s")
        if rc != 0:
            fail(f"dist nccl: the R-MAT {DIST_BIG['scale']} build exited "
                 f"{rc}:\n{(big_dir / 'log').read_text()[-4000:]}")
        meta = json.loads((big_dir / "meta.json").read_text())
        paths = [str(big_dir / f"view{r}.pt") for r in range(P)]
        t0 = time.perf_counter()
        dsh = stack_views([torch.load(x, weights_only=False)
                           for x in paths]).to("cuda")
        t_load = time.perf_counter() - t0
        say(f"dist nccl: R-MAT {DIST_BIG['scale']}, edge factor "
            f"{DIST_BIG['edge_factor']}, seed {DIST_BIG['seed']}: "
            f"{meta['n']} vertices, {meta['n_edges']} edges, ragged at "
            f"P={P}, block {meta['block']}, rx {tuple(meta['rx'])}; layouts "
            f"{meta['layout_bytes']} B, {meta['bytes_per_edge']:.2f} B/edge;"
            f" host: stream {meta['t_stream']:.1f} s, build_shards_stream "
            f"{meta['t_build']:.1f} s, views saved {meta['t_save']:.1f} s "
            f"(beside the jobs above), loaded and stacked on the card "
            f"{t_load:.1f} s")
        dist_phase(torch, np, None, dsh, meta["sources"], DIST_BIG_JOBS,
                   f"rmat {DIST_BIG['scale']} ragged", True, card=card,
                   backend="nccl", views=paths)
        del dsh
        torch.cuda.empty_cache()
    finally:
        big_stop()
    say(f"dist nccl: {P} ranks, one a card, {len(DIST_JOBS_1E6)} + "
        f"{len(DIST_NCCL_JOBS_1E7)} + {len(DIST_BIG_JOBS)} jobs and the "
        f"runner's {len(RUNNER_NCCL_RUNS)}; "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")


def say_nccl_profile(prof: dict, label: str, card: str):
    """Print ``nccl_profile``'s summary of a rank's traced solve."""
    rounds = max(prof["rounds"], 1)
    kinds = ", ".join(f"{k} {v:.3f} ms" for k, v in
                      prof["by_kind_ms"].items())
    say(f"profile nccl {label}: window {prof['window_ms']:.3f} ms, device "
        f"busy {prof['busy_ms']:.3f} ms, idle share {prof['idle']:.3f}, "
        f"{prof['kernels']} kernels, {prof['rounds']} rounds; device time "
        f"by kind: {kinds}; the host's reads of device values "
        f"{prof['reads']} ({prof['read_ms'] / rounds:.3f} ms a round, the "
        f"round's vote read among them), issuing the all-reduces "
        f"{prof['allreduces']} ({prof['allreduce_ms'] / rounds:.3f} ms a "
        f"round); {card}")


def nccl_runner(P: int, card: str):
    """``torchrun --nproc-per-node P -m repro_torch.launch.sssp_run
    --backend shmap --dist-backend nccl`` on RUNNER_NCCL_ARGS, once for each
    of RUNNER_NCCL_RUNS, beside a ``--backend sim`` run of the same flags
    on one card: each exits 0 with its validation passed, and rank 0's
    lines equal the sim run's but the walls. The torchrun jobs run one
    after the other, the sim runs beside the first."""
    t0 = time.perf_counter()

    def args(name):
        return ("-m", "repro_torch.launch.sssp_run", "--parts", str(P),
                *RUNNER_NCCL_ARGS, *RUNNER_NCCL_RUNS[name])

    def torchrun(name):
        return [sys.executable, "-m", "torch.distributed.run",
                "--nproc-per-node", str(P), "--master-port", str(free_port()),
                *args(name), "--backend", "shmap", "--dist-backend", "nccl"]

    names = list(RUNNER_NCCL_RUNS)
    outs = run_procs({("nccl", names[0]): torchrun(names[0]),
                      **{("sim", x): [sys.executable, *args(x), "--backend",
                                      "sim"] for x in names}},
                     errors=True)
    outs.update(run_procs({("nccl", x): torchrun(x) for x in names[1:]},
                          errors=True))
    for name in names:
        got, want = outs["nccl", name], outs["sim", name]
        for (kind, (rc, out, err)) in (("nccl", got), ("sim", want)):
            if rc != 0 or f"validation vs Dijkstra ({DIST_K} queries): OK" \
                    not in out:
                fail(f"dist nccl runner {name} ({kind}): exit {rc}\n{out}"
                     f"\n{err[-4000:]}")
        a, b = (RUNNER_WALLS.sub("<t>", x[1]).splitlines()
                for x in (got, want))
        if a != b:
            fail(f"dist nccl runner {name}: rank 0's lines differ from the "
                 f"sim run's:\n{got[1]}\n--- sim ---\n{want[1]}")
        for line in got[1].splitlines():
            say(f"  runner nccl {name} | {line}")
        solve = [x[1].split("solve: ")[1].split("s ")[0] for x in (got, want)]
        say(f"dist nccl runner {name}: torchrun {P} ranks over NCCL, exit 0,"
            f" validated; rank 0's {len(a)} lines == the sim run's but the "
            f"walls (solve {solve[0]} s vs {solve[1]} s sim)")
    say(f"dist nccl runner: {time.perf_counter() - t0:.1f} s for "
        f"{len(names)} torchrun jobs and their sim runs ({card})")


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
    fused_round_wrappers(torch, sh, carry, act, incoming, label, ragged)


def fused_round_wrappers(torch, sh, carry, act, incoming, label: str,
                         ragged: bool):
    """The fused round's per-shard entry points on shard 0 of a round-2
    state, in the reference's form: ``fused_round_pallas`` with bucket and
    with dense incoming (one in-kernel sweep, so a residual is left) must
    launch kernel 7 (dense layouts) or 8 (ragged) and be bit-equal to its
    plain twin and to row 0 of the stacked body the solver calls
    (``_fused_round_stacked``); ``fused_round_rescue`` the same with the
    relax and send kernels it launches; ``fused_round_ref`` (the plain
    oracle, no kernel) equal to row 0 of its stacked body and, with bucket
    incoming, to the round finished by the rescue."""
    from repro_torch.kernels import build
    from repro_torch.kernels import round as RD
    from repro_torch.kernels.round.ref import _fused_round_ref_stacked
    sfx = "_ragged" if ragged else ""
    lays = [tuple(a[0] for a in lay) for lay in (
        sh.relax_layout, sh.send_layout, sh.merge_layout)]
    e = sh.e_loc
    prn = (carry.pruned[0, :e], carry.pruned[0, e:])
    live = ~carry.done
    kw = dict(vb=sh.rx_vb, sb=sh.tx_sb, n_sweeps=1)
    inc = {False: incoming, True: torch.where(
        torch.isfinite(carry.dist), carry.dist - 0.5, carry.dist)}
    out = {}

    def check(name, kernels, one, stacked):
        torch.cuda.synchronize()
        build.reset_launches()
        got = _flat(tuple(one()))
        torch.cuda.synchronize()
        n = {k + sfx: build.LAUNCHES[k + sfx] for k in kernels}
        if kernels and min(n.values()) < 1 or not kernels and any(
                build.LAUNCHES.values()):
            fail(f"wrappers {label}: {name} launched {dict(build.LAUNCHES)}, "
                 f"not {kernels}")
        with plain_round_kernels():
            want = _flat(tuple(one()))
        row0 = [t[0] for t in _flat(tuple(stacked()))]
        for g_, w_, r_ in zip(got, want, row0, strict=True):
            if not (torch.equal(g_, w_) and torch.equal(g_, r_)):
                fail(f"wrappers {label}: {name} differs from its plain twin "
                     f"or from row 0 of its stacked body")
        return got, n

    for dense in (False, True):
        name = f"fused_round_pallas({'dense' if dense else 'bucket'})"
        out[dense], n = check(name, ("round",), lambda: RD.fused_round_pallas(
            carry.dist[0], act[0], live[0], inc[dense][0],
            carry.last_sent[0], sh.slot_valid[0], *lays, *prn, dense=dense,
            interpret=False, **kw), lambda: RD.ops._fused_round_stacked(
            carry.dist, act, live, inc[dense], carry.last_sent,
            sh.slot_valid, sh.relax_layout, sh.send_layout,
            None if dense else sh.merge_layout, carry.pruned[:, :e],
            carry.pruned[:, e:], dense=dense, chunks=sh.round_chunks, **kw))
        say(f"  {name}: {n}")
    d0, resid = out[False][0], out[False][5]
    if not bool((resid > 0).any()):
        fail(f"wrappers {label}: one sweep left no residual to rescue")
    full = RD.ops._fused_round_stacked(
        carry.dist, act, live, incoming, carry.last_sent, sh.slot_valid,
        sh.relax_layout, sh.send_layout, sh.merge_layout,
        carry.pruned[:, :e], carry.pruned[:, e:], chunks=sh.round_chunks,
        **kw)
    res, n = check("fused_round_rescue", ("relax", "send"),
                   lambda: RD.fused_round_rescue(
                       d0, resid, carry.last_sent[0], sh.slot_valid[0],
                       lays[0], lays[1], *prn, interpret=False, **kw),
                   lambda: RD.ops._fused_round_rescue_stacked(
                       full[0], full[5], carry.last_sent, sh.slot_valid,
                       sh.relax_layout, sh.send_layout, carry.pruned[:, :e],
                       carry.pruned[:, e:], send_bounds=sh.send_bounds,
                       relax_chunks=sh.relax_chunks, **kw))
    say(f"  fused_round_rescue: {n}")
    ref, _ = check("fused_round_ref", (), lambda: RD.fused_round_ref(
        carry.dist[0], act[0], live[0], incoming[0], sh.recv_idx[0],
        carry.last_sent[0], sh.slot_valid[0], sh.loc_src[0], sh.loc_dst[0],
        sh.loc_w[0], prn[0], sh.cut_src[0], sh.cut_seg[0], sh.cut_w[0],
        prn[1]), lambda: _fused_round_ref_stacked(
        carry.dist, act, live, incoming, sh.recv_idx.reshape(
            sh.n_parts, -1), carry.last_sent, sh.slot_valid, sh.loc_src,
        sh.loc_dst, sh.loc_w, carry.pruned[:, :e], sh.cut_src, sh.cut_seg,
        sh.cut_w, carry.pruned[:, e:]))
    for i, j in ((0, 0), (1, 1), (2, 2), (4, 3)):
        if not torch.equal(res[i], ref[j]):
            fail(f"wrappers {label}: the rescued round's output {i} "
                 f"differs from fused_round_ref's")
    say(f"wrappers {label}: fused_round_pallas (bucket and dense incoming), "
        f"fused_round_rescue and fused_round_ref on shard 0 at round 2, "
        f"each bit-equal to its plain twin and to row 0 of its stacked "
        f"body; the rescued round == the oracle")


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
    params = materialize(tf.param_defs(cfg, one_ax()), gen, device=dev,
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
        step = tf.make_train_step(cfg, one_ax(), AdamWConfig(),
                                  microbatches=mb)
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
    pc = materialize(tf.param_defs(c, one_ax()),
                     torch.Generator().manual_seed(0),
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
    loss_f = functools.partial(tf.loss_fn, ax=one_ax())
    rel, worst = grads_card_vs_cpu(torch, loss_f, pc, bc, c,
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
        tf._value_and_grad(_to(pc, dev), _to(bc, dev), cp, one_ax())
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
            abstract(tf.param_defs(full, one_ax()), full.dtype)))
        gen = torch.Generator(device=dev)
        gen.manual_seed(SERVE["seed"] + 10 + i)
        t0 = time.perf_counter()
        params = materialize(tf.param_defs(cfg, one_ax()), gen, device=dev,
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
            lx = tf.make_prefill_step(cfg_x, one_ax())(
                params, {"tokens": prompts})[0]
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
                logits = tf.forward(_to(pc, dev_), tc.to(dev_), c,
                                    one_ax())[0].cpu()
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
BONDED_EGNN_COORDS = 0.3       # EGNN's coordinate scale on bonded molecules


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
    ax = one_ax()
    defs = ai.autoint_param_defs(cfg, ax)
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
    step = ai.make_autoint_train_step(cfg, ax, AdamWConfig())
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
    serve = ai.make_autoint_serve_step(cfg, ax)
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
    retrieve = ai.make_retrieval_step(cfg, ax, RECSYS["top_k"])
    med, worst = serve_latency(torch, lambda: retrieve(params, query),
                               RECSYS["serve_reps"])
    vals, idx = retrieve(params, query)
    q = ai.mlp_apply(params["retr_proj"], ai.autoint_embed(
        params, query, cfg, ax), 1)
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
    pc = materialize(ai.autoint_param_defs(c, ax),
                     torch.Generator().manual_seed(0), device="cpu")
    bc = next(RecsysBatcher(64, c.n_sparse, c.vocab_per_field, c.multi_hot,
                            seed=3, device="cpu"))
    bc["sparse_idx"].view(-1)[::5] = c.total_vocab       # padding sentinels
    s_cpu = ai.make_autoint_serve_step(c, ax)(pc, bc)
    s_gpu = ai.make_autoint_serve_step(c, ax)(_to(pc, dev),
                                          _to(bc, dev)).cpu()
    serr = float((s_gpu - s_cpu).abs().max()) / float(s_cpu.abs().max())
    if serr > 1e-4:
        fail(f"recsys smoke: serve scores card vs CPU {serr:.3g}")
    rel, worst = grads_card_vs_cpu(torch, functools.partial(
        ai.autoint_loss, ax=ax), pc, bc, c,
                                   "recsys smoke")
    base = torch.randn((512, c.d_retrieval), generator=torch.Generator()
                       .manual_seed(4))
    cands = base[torch.randint(0, 512, (4096,), generator=torch.Generator()
                               .manual_seed(5))]             # ties
    rq = {"sparse_idx": bc["sparse_idx"][:2], "cand_vecs": cands}
    v_cpu, i_cpu = ai.make_retrieval_step(c, ax, 100)(pc, rq)
    v_gpu, i_gpu = ai.make_retrieval_step(c, ax, 100)(_to(pc, dev),
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


def gnn_cell(torch, arch: str, shape_id: str, gen,
             graphcast_layers: int = GRAPHCAST_LAYERS, bonded: bool = False):
    """(config, ParamDef tree, loss, batch on the card) of ``arch`` at its
    published widths on GNN_SHAPES[shape_id], the widths adapted as the
    reference's _gnn_cell does (GraphCast cut to ``graphcast_layers``): random
    edges over the whole graph as build_gnn makes them, or, on the batched
    molecule shape, edges inside molecules of MOLECULE_ATOMS atoms.
    ``bonded``: molecule edges join two distinct atoms and EGNN's
    coordinates are drawn at BONDED_EGNN_COORDS, where EGNN and MACE stay
    well inside f32 (PERF.md): with self-loops MACE's correlation-3
    products reach a loss near 1e13, and EGNN's unnormalised coordinate
    update grows about as the cube of the coordinates' scale a layer."""
    from repro_torch.configs.registry import GNN_SHAPES, _load
    from repro_torch.models import gnn
    dev = _card(torch)
    sh = GNN_SHAPES[shape_id]
    N, E, Df = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    cfg = _load(arch)[1]
    if arch == "gat-cora":
        cfg = dataclasses.replace(cfg, d_in=Df, n_classes=sh["n_classes"])
    elif arch == "egnn":
        cfg = dataclasses.replace(cfg, d_in=Df)
    elif arch == "graphcast":
        cfg = dataclasses.replace(cfg, n_layers=graphcast_layers)
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
        src = randint(MOLECULE_ATOMS, E)
        dst = ((src + 1 + randint(MOLECULE_ATOMS - 1, E)) % MOLECULE_ATOMS
               if bonded else randint(MOLECULE_ATOMS, E))
        b = dict(edge_src=base + src, edge_dst=base + dst)
    else:
        b = dict(edge_src=randint(N, E), edge_dst=randint(N, E))
    if arch == "gat-cora":
        b["node_feat"] = randn(N, Df)
        b["labels"] = randint(sh["n_classes"], N)
    elif arch == "egnn":
        b["node_feat"] = randn(N, Df)
        b["coords"] = randn(N, 3) * (BONDED_EGNN_COORDS if bonded else 1.0)
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
        h0 = gnn.mace_forward(params, batch, cfg, one_ax())[0]
        h1 = gnn.mace_forward(params, dict(batch, coords=batch["coords"]
                                           @ R.T), cfg, one_ax())[0]
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
        step = gnn.make_gnn_train_step(loss, cfg, one_ax(), AdamWConfig())
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
        pc, _, data = build_gnn(arch, c, one_ax(), AdamWConfig(), "cpu")
        rel, worst = grads_card_vs_cpu(
            torch, functools.partial(gnn.MODELS[arch][2], ax=one_ax()), pc,
            next(data), c, f"gnn smoke {arch}")
        say(f"  {c.name} f32 on the card vs the CPU (256 nodes, 1024 "
            f"edges): loss {rel:.3g} relative (tolerance 1e-4), gradients "
            f"within {worst:.3g} of each one's largest value (1e-3)")

    # ---- MACE's rotation invariance: tests/test_arch_smoke.py's check -----
    c = _load("mace", smoke=True)[1]
    pc = materialize(gnn.mace_param_defs(c, one_ax()),
                     torch.Generator().manual_seed(2), device="cpu")
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


def run_procs(cmds: dict, timeout: float = 600, errors: bool = False
              ) -> dict:
    """Run each command of ``cmds`` ({name: argv}) from the checkout with
    the port on its path, all at once; {name: (exit code, output)}, the
    standard error in the output, or with ``errors`` {name: (exit code,
    standard output, standard error)}. Every process is waited for, and
    killed if it outlives ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    try:
        for name, cmd in cmds.items():
            procs[name] = subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE if errors else subprocess.STDOUT,
                text=True)
        outs = {name: p.communicate(timeout=timeout)
                for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return {name: (procs[name].returncode, *(out if errors else out[:1]))
            for name, out in outs.items()}


def param_defs_of(arch: str, cfg):
    """(ParamDef tree, default dtype) of ``arch``'s config ``cfg``."""
    import torch
    from repro_torch.configs.registry import ARCHS
    family = ARCHS[arch][0]
    if family == "lm":
        from repro_torch.models import transformer as tf
        return tf.param_defs(cfg, one_ax()), cfg.dtype
    if family == "recsys":
        from repro_torch.models import autoint as ai
        return ai.autoint_param_defs(cfg, one_ax()), torch.float32
    from repro_torch.models import gnn
    return gnn.MODELS[arch][0](cfg, one_ax()), torch.float32


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


MATERIALIZE_SLICE = 10_000_000     # table entries the CPU draws to compare
MATERIALIZE_ULPS = 4
REAL_CELLS = (("autoint", "train_batch"), ("gat-cora", "full_graph_sm"))
ARGS_REL = 0.01                    # allocated vs the dry run's argument bytes


def f32_ulps(np, got, want) -> int:
    """Largest distance in ulps between two f32 arrays."""
    def ordered(a):
        b = a.view(np.int32).astype(np.int64)
        return np.where(b < 0, -(b & 0x7FFFFFFF), b)
    return int(np.abs(ordered(got) - ordered(want)).max(initial=0))


def materialize_phase(torch, np, card: str):
    """The full-width AutoInt weights from ``prng.key(0)`` on the card
    against the CPU's (module docstring: weights)."""
    from repro_torch.configs.registry import _load
    from repro_torch.core import prng
    from repro_torch.models import autoint as ai
    from repro_torch.models import params as pm
    from repro_torch.models.params import ParamDef, materialize, tree_leaves
    dev = torch.device("cuda")
    cfg = _load("autoint")[1]
    defs = ai.autoint_param_defs(cfg, one_ax())
    table_def = defs["table"]
    n_leaves = len(tree_leaves(defs))
    i_table = [k for k, _ in pm._leaves(defs)].index(("table",))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = materialize(defs, prng.key(0), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    weights = nbytes(*tree_leaves(params))
    peak = torch.cuda.max_memory_allocated()
    transient = peak - base - weights
    # one slice's draw alone: the transients a draw leaves per element
    key = prng.split(prng.key(0).to(dev), n_leaves)[i_table]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = prng.normal(key, (pm.DRAW_SLICE,))
    per_elem = (torch.cuda.max_memory_allocated() - before
                - nbytes(one)) / pm.DRAW_SLICE
    del one
    n_table = params["table"].numel()
    say(f"weights phase: materialize(autoint, prng.key(0)) on the card: "
        f"{n_leaves} leaves, {weights} B, table {tuple(table_def.shape)} "
        f"({n_table} entries); {wall:.2f} s; peak allocated {peak} B, "
        f"transients past the weights {transient} B with slices of "
        f"{pm.DRAW_SLICE} (a whole draw of the table would hold about "
        f"{per_elem * n_table:.3e} B, {per_elem:.1f} B an element); {card}")
    if transient > 2 * per_elem * pm.DRAW_SLICE + (64 << 20):
        fail(f"weights: the slices left {transient} B of transients, more "
             f"than two slices' {2 * per_elem * pm.DRAW_SLICE:.0f} B")
    # every other leaf whole on the CPU: a one-row table keeps the tree's
    # leaf order, so every other leaf takes the same key
    small = dict(defs, table=ParamDef((1, table_def.shape[1]),
                                      scale=table_def.scale))
    cpu = materialize(small, prng.key(0), device="cpu")
    worst = 0
    for (path, got), want in zip(pm._leaves(params), tree_leaves(cpu)):
        if path == ("table",):
            continue
        worst = max(worst, f32_ulps(np, got.cpu().numpy(), want.numpy()))
    # the table on a slice at an offset, drawn on the CPU alone
    off = n_table // 2 - MATERIALIZE_SLICE // 2
    m = MATERIALIZE_SLICE
    lo = -0.99999994039535522
    kc = prng.split(prng.key(0), n_leaves)[i_table]
    u_dev = prng.uniform(key, (m,), lo, 1.0, off).cpu().numpy()
    u_cpu = prng.uniform(kc, (m,), lo, 1.0, off).numpy()
    scale = torch.tensor(table_def.scale, dtype=torch.float32)
    t_cpu = (prng.normal(kc, (m,), off) * scale).numpy()
    t_dev = params["table"].view(-1)[off:off + m].cpu().numpy()
    table_ulps = f32_ulps(np, t_dev, t_cpu)
    equal = float((t_dev.view(np.int32) == t_cpu.view(np.int32)).mean())
    say(f"  card vs CPU: {n_leaves - 1} leaves whole within {worst} ulp; "
        f"the table's entries {off}..{off + m}: uniform bits "
        f"{'equal' if np.array_equal(u_dev.view(np.int32), u_cpu.view(np.int32)) else 'DIFFERENT'}"
        f", weights within {table_ulps} ulp ({equal:.6f} of them equal bit "
        f"for bit); tolerance {MATERIALIZE_ULPS} ulp")
    if (worst > MATERIALIZE_ULPS or table_ulps > MATERIALIZE_ULPS
            or not np.array_equal(u_dev.view(np.int32), u_cpu.view(np.int32))):
        fail("weights: the card's materialize differs from the CPU's")
    del params, cpu
    torch.cuda.empty_cache()


def real_args(torch, arch: str, args, dev):
    """A cell's arguments for real on ``dev``: the weights from
    ``prng.key(0)`` (the cells of REAL_CELLS keep their config's widths),
    the AdamW state, and a batch of the structs' shapes (features normal,
    ids below the table's or the graph's size, labels 0/1)."""
    from repro_torch.configs.registry import _load
    from repro_torch.core import prng
    from repro_torch.models.params import materialize
    from repro_torch.optim import adamw_init
    cfg = _load(arch)[1]
    params = materialize(param_defs_of(arch, cfg)[0], prng.key(0),
                         device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    batch = {}
    for name, t in args[2].items():
        if t.dtype.is_floating_point:
            batch[name] = torch.randn(t.shape, generator=gen, device=dev)
            continue
        hi = (2 if name == "labels" else cfg.total_vocab
              if name == "sparse_idx" else args[2]["node_feat"].shape[0])
        batch[name] = torch.randint(0, hi, t.shape, generator=gen,
                                    device=dev, dtype=t.dtype)
    return params, adamw_init(params), batch


DRYRUNS = {"production": ("--all", "--both-meshes"),
           "one card": ("--all", "--one-card")}


def start_dryrun():
    """``python -m repro_torch.launch.dryrun`` as a user runs it, both
    sweeps (DRYRUNS: the production meshes' 88 records and the one-card
    sweep's 44), started now in the background (nice 19, one thread, no
    card visible: the cells are meta tensors) so that their host work
    overlaps the card's phases; dryrun_phase collects them. Killed at exit
    if still running."""
    import atexit
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        env.pop(k, None)
    runs = {}
    for i, (name, flags) in enumerate(DRYRUNS.items()):
        out = tmp / f"sweep{i}"
        out.mkdir()
        with open(out / "log", "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
                 "--force", "--out", str(out / "cells")], cwd=ROOT, env=env,
                stdout=log, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(19))
        runs[name] = dict(proc=proc, dir=out)

    def stop():
        for r in runs.values():
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return dict(runs=runs, t0=time.perf_counter())


def _sweep(dry: dict, name: str):
    """The records of one of start_dryrun's sweeps, waited for."""
    r = dry["runs"][name]
    t0 = time.perf_counter()
    try:
        rc = r["proc"].wait(timeout=600)
    except subprocess.TimeoutExpired:
        fail(f"dryrun: the {name} sweep still running 600 s after the "
             f"card's phases")
    waited = time.perf_counter() - t0
    out = (r["dir"] / "log").read_text()
    if rc != 0:
        fail(f"dryrun: the {name} sweep: exit {rc}: {out[-2000:]}")
    cells = r["dir"] / "cells"
    recs = [json.loads((cells / f).read_text())
            for f in sorted(os.listdir(cells))]
    say(f"dryrun phase: python -m repro_torch.launch.dryrun "
        f"{' '.join(DRYRUNS[name])}: exit 0, {len(recs)} records, done "
        f"{time.perf_counter() - dry['t0']:.1f} s after its start beside "
        f"the card's phases ({waited:.1f} s waited for it here; host work "
        f"on meta tensors; {out.splitlines()[-1]})")
    return recs


def production_records(recs, card: str):
    """The production sweep's 88 records (44 cells on the (16, 16) and
    (2, 16, 16) meshes): every cell ok but the reference's long_500k
    skips; every LM, GNN and AutoInt record with collective bytes; the
    LM cells' table; mistral-large-123b decode_32k's single-pod caches a
    rank at the reference layout's 5,905,580,032 B."""
    from repro_torch.configs.registry import LM_ARCHS
    say(f"  {'record':<48} {'args B a rank':>14} {'collective B':>13} "
        f"{'all-reduce':>11} {'all-gather':>11} {'red-scatter':>11} "
        f"{'all-to-all':>11} dominant")
    skipped = 0
    for r in recs:
        name = f"{r['arch']}/{r['shape']}/" + ("multipod" if r["multi_pod"]
                                               else "singlepod")
        if r["status"] == "skipped" and r["shape"] == "long_500k":
            skipped += 1
            continue
        if r["status"] != "ok":
            fail(f"dryrun production: {name}: {r.get('error', r)}")
        c = r["collectives"]
        if r["arch"] != "sp-async" and not c["total"] > 0:
            fail(f"dryrun production: {name} recorded no collective bytes")
        if r["arch"] in LM_ARCHS:
            say(f"  {name:<48} {r['argument_bytes']:>14} {c['total']:>13} "
                f"{c['all-reduce']:>11} {c['all-gather']:>11} "
                f"{c['reduce-scatter']:>11} {c['all-to-all']:>11} "
                f"{r['roofline']['dominant']}"
                + (f"; caches {r['cache_bytes']} B (head layout "
                   f"{r['cache_bytes_head_layout']} B)"
                   if "cache_bytes" in r else ""))
    if len(recs) != 88 or skipped != 10:
        fail(f"dryrun production: {len(recs)} records ({skipped} skipped), "
             f"not 88 (10)")
    mistral = [r for r in recs if r["arch"] == "mistral-large-123b"
               and r["shape"] == "decode_32k" and not r["multi_pod"]][0]
    if mistral["cache_bytes"] != 5_905_580_032:
        fail(f"dryrun production: mistral decode_32k caches "
             f"{mistral['cache_bytes']} B a rank")
    say(f"  production meshes: 78 records ok, 10 long_500k skipped as in "
        f"the reference; every LM, GNN and AutoInt record moves collective "
        f"bytes; {card}")


def dryrun_phase(torch, card: str, dry: dict):
    """The two sweeps ``start_dryrun`` began, waited for: the production
    meshes' records checked (``production_records``); the one-card
    sweep's table of cells, and two cells built for real on the card
    (module docstring: dryrun)."""
    from repro_torch.configs.registry import argument_bytes, build_cell
    from repro_torch.models.params import tree_leaves
    dev = torch.device("cuda")
    production_records(_sweep(dry, "production"), card)
    recs = _sweep(dry, "one card")
    say(f"  {'cell':<42} {'argument_bytes':>16} {'counted FLOPs':>13} "
        f"{'model_flops':>12} {'useful':>7} fits")
    by_cell = {}
    for r in recs:
        by_cell[r["arch"], r["shape"]] = r
        name = f"{r['arch']}/{r['shape']}"
        if r["status"] == "skipped":
            say(f"  {name:<42} skipped: {r['reason'][:60]}")
            continue
        flops = "null" if r["flops"] is None else f"{r['flops']:.4e}"
        useful = ("null" if r["useful_ratio"] is None
                  else f"{r['useful_ratio']:.4f}")
        say(f"  {name:<42} {r['argument_bytes']:>16} {flops:>13} "
            f"{r['model_flops']:>12.4e} {useful:>7} {r['fits']}")
        if r["status"] != "ok" or (r["arch"] != "sp-async"
                                   and not r["flops"] > 0):
            fail(f"dryrun: cell {name}: {r}")
    if len(recs) != 44:
        fail(f"dryrun: {len(recs)} cells recorded, not 44")
    for arch, shape in REAL_CELLS:
        cell = build_cell(arch, shape, None, None)
        want = by_cell[arch, shape]["argument_bytes"]
        if want != argument_bytes(cell.args_struct):
            fail(f"dryrun: {arch}/{shape} argument bytes differ")
        gc.collect()               # cycles left by the last cell's step
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = real_args(torch, arch, cell.args_struct, dev)
        # no name may hold an argument past the step: the next cell's
        # baseline would count it
        if [(t.shape, t.dtype) for t in tree_leaves(args)] != [
                (t.shape, t.dtype) for t in tree_leaves(cell.args_struct)]:
            fail(f"dryrun: {arch}/{shape}: the arguments' shapes and types "
                 f"differ from the cell's")
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        rel = abs(held - want) / want
        t0 = time.perf_counter()
        out = cell.step_fn(*args)
        loss = float(out[2]["loss"])
        step_s = time.perf_counter() - t0
        say(f"  {arch}/{shape} for real on the card: allocated {held} B for "
            f"the arguments vs the dry run's {want} B ({rel:.2e} apart, "
            f"tolerance {ARGS_REL}); one step {step_s:.3f} s (the first), "
            f"loss {loss:.6f}")
        if rel > ARGS_REL or not math.isfinite(loss):
            fail(f"dryrun: {arch}/{shape}: {held} B vs {want} B, loss {loss}")
        del args, out


# The mesh phase: the LMs under a (data, model) mesh of processes
# (models/transformer.py, models/moe.py, distributed/sharding.py). Four gloo
# ranks share the card, as the dist phase's do; each rank holds its shard
# of the weights, made from the seed on the card (materialize under the
# mesh draws only its elements). In f32 the ranks and one process differ
# only by the order of float32 sums, which leaves the last logits about
# 1e-6 of the largest apart; in bf16 each rank's row-parallel partials
# are rounded to bf16 before the psum adds them (as the reference's psum
# does), and each run's own roundings move the logits by enough to flip a
# greedy token or an expert at a near tie. So the equality runs are
# in f32 (MESH_DTYPE), held to MESH_LOGITS_REL of the largest logit, the
# greedy tokens exact, the MoE routing exact but at near ties
# (MESH_ROUTE_TIE); the train step's loss and gradient norm within
# MESH_LOSS_REL, its gradient (AdamW's first moment after one step, (1 -
# b1) g) within MESH_GRAD_REL of each leaf's largest, and each stepped
# parameter within 2 lr plus one ulp of the one-process step's (a first
# AdamW step moves an element by about lr, its sign the gradient's). One
# serving run is in bf16, the configs' own type (kernel 12's bf16 route at
# a rank's heads, the row-parallel partials rounded to bf16 and summed by
# the collective in bf16): its logits within MESH_BF16_REL of the largest
# (the port's bf16 tolerance against JAX), its greedy tokens exact where
# one process's top-2 gap exceeds twice that, and a row's later logits
# held while its tokens agree (_agreeing).
#
# Serving: mistral-large-123b (src/repro/configs/mistral_large_123b.py) at
# its published widths cut from 88 layers to 4 (6.34e9 parameters, 25.4
# GB in f32), 4 prompts of 2048 tokens and 16 greedy steps on (1, 4),
# the depth cut to keep the script's wall in its limit; on (2, 2) cut to
# 2 layers and one greedy step, since FSDP gathers every weight over data
# at every step and gloo moves them through the host (8 layers: 38.7 s a
# decode step, 2 layers 9.8-11.3 s, on an H100 80GB HBM3, PERF.md);
# qwen3-moe-235b-a22b at its published widths cut to 4 layers (11.2e9
# parameters; 128 experts, 32 a rank) with 512-token prompts and 8 greedy
# steps on (1, 4), under both MoE impls; mistral-large in bf16, 2 layers,
# 4 x 2048 and 8 greedy steps on (1, 4). Training: olmoe-1b-7b cut to 2
# layers, one AdamW step on 4 x 512 tokens on (2, 2) (data_shards=2: the
# one-process step routes in the same 2 groups).
MESH_RANKS = 4
MESH_TIMEOUT = 900             # seconds a collective may wait for its peers
MESH_AXES = ("data", "model")
MESH_DTYPE = "float32"
MESH_LOGITS_REL = 1e-4
MESH_LOSS_REL = 1e-5
MESH_GRAD_REL = 1e-4
MESH_BF16_REL = 3e-2
# An expert pick may differ from one process's only at a near tie, where
# one process's k-th and (k+1)-th router probabilities are within this
# share of the k-th (50x the 2e-6 that f32 sums in another order move
# the logits by on an H100, PERF.md), or where an earlier such move
# reached it (route_flips).
MESH_ROUTE_TIE = 1e-4
MESH_SERVE = (
    dict(arch="mistral-large-123b", layers=4, meshes=((1, 4),),
         impls=("shmap",), batch=4, prompt=2048, gen=16, seed=30,
         dtype=MESH_DTYPE),
    dict(arch="mistral-large-123b", layers=2, meshes=((2, 2),),
         impls=("shmap",), batch=4, prompt=2048, gen=1, seed=30,
         dtype=MESH_DTYPE),
    dict(arch="qwen3-moe-235b-a22b", layers=4, meshes=((1, 4),),
         impls=("shmap", "gspmd"), batch=4, prompt=512, gen=8, seed=31,
         dtype=MESH_DTYPE),
    dict(arch="mistral-large-123b", layers=2, meshes=((1, 4),),
         impls=("shmap",), batch=4, prompt=2048, gen=8, seed=30,
         dtype="bfloat16"))
MESH_TRAIN = dict(arch="olmoe-1b-7b", layers=2, mesh=(2, 2), batch=4,
                  seq=512, seed=32, dtype=MESH_DTYPE)
# mistral-large at full depth in bf16 on four cards, one NCCL rank a card
# (61.5 GB of weights a card): its TTFT and decode ms a step
MESH_FULL = dict(MESH_SERVE[0], layers=None, dtype="bfloat16")
# AutoInt and the GNN zoo on the mesh (f32, published widths): AutoInt's
# train step at REC_SHAPES' train_batch and serving at serve_p99 on (2, 2)
# (the table over model, the batch over data), retrieval of one query over
# 1e6 candidates on (1, 4); each GNN of GNN_CELLS one train step and its
# forward on (2, 2), node and edge rows over (data, model); GraphCast cut
# to 2 layers, since gloo moves its whole-graph gathers (170k x 512 f32)
# through the host; EGNN and MACE on bonded molecules (gnn_cell), where
# their losses and gradients stay well inside f32.
MESH_MODELS = (
    dict(kind="recsys", arch="autoint", mesh=(2, 2), seed=33),
    dict(kind="retrieval", arch="autoint", mesh=(1, 4), seed=33,
         n_cand=1_000_000, top_k=100),
    dict(kind="gnn", arch="gat-cora", shape="minibatch_lg", mesh=(2, 2),
         seed=34),
    dict(kind="gnn", arch="graphcast", shape="minibatch_lg", mesh=(2, 2),
         seed=34, layers=2),
    dict(kind="gnn", arch="egnn", shape="molecule", mesh=(2, 2), seed=34),
    dict(kind="gnn", arch="mace", shape="molecule", mesh=(2, 2), seed=34))
MESH_RETRIEVAL_TIE = 1e-5
# A model axis wider than the KV heads: qwen3-moe-235b-a22b (64 query, 4
# KV heads) at its published widths cut to 2 layers, on (1, 8) with 8
# gloo ranks sharing the card, 4 x 512 prompts and 8 greedy steps in f32.
# Two ranks compute each KV head; a rank's caches are its eighth of the
# sequence with every KV head, half of the KV-heads layout (its one KV
# head over the whole sequence).
MESH_WIDE = dict(arch="qwen3-moe-235b-a22b", layers=2, meshes=((1, 8),),
                 impls=("shmap",), batch=4, prompt=512, gen=8, seed=36,
                 dtype=MESH_DTYPE)
MESH_WIDE_RANKS = 8


def _card(torch):
    """This process's card."""
    return torch.device("cuda", torch.cuda.current_device())


def _mesh_cfg(spec: dict, impl: str = "shmap"):
    """``spec``'s config at its published widths, cut to its layers, in
    ``spec["dtype"]`` where it names one."""
    from repro_torch.configs.registry import _load
    full = _load(spec["arch"])[1]
    return dataclasses.replace(full, n_layers=spec["layers"] or full.n_layers,
                               attn_impl="pallas", moe_impl=impl,
                               dtype=spec.get("dtype", full.dtype))


def _route(cfg):
    """Kernel 12's launch counter for the config's type."""
    bf16 = str(cfg.dtype).endswith("bfloat16")
    return "flash_attention_tc" if bf16 else "flash_attention"


def _logits_rel(cfg) -> float:
    """The share of the largest logit a mesh run's logits may differ by
    from one process's in the config's type."""
    bf16 = str(cfg.dtype).endswith("bfloat16")
    return MESH_BF16_REL if bf16 else MESH_LOGITS_REL


def _agreeing(np, gen, ref, rel: float):
    """Each row's count of leading greedy tokens equal to one process's
    (``ref``: its tokens and their top-2 gaps, ``_margin``); a token must
    equal where the gap exceeds ``2 rel`` (two sets of logits within
    ``rel`` of one process's take its argmax there), and a row's first
    token that differs at a smaller gap ends its count."""
    n = np.full(gen.shape[0], gen.shape[1])
    for b, t in np.argwhere(gen != ref["gen"]):       # row-major
        if t < n[b]:
            if ref["margins"][b, t] > 2 * rel:
                fail(f"mesh: greedy token at row {b} step {t} differs from "
                     f"one process's at a top-2 gap of "
                     f"{ref['margins'][b, t]:.3g} of its largest logit, past "
                     f"2 x {rel}")
            n[b] = t
    return n


def _mesh_ax(shape):
    from repro_torch.distributed.sharding import MeshAxes
    return MeshAxes(data=("data",), data_shards=shape[0])


def _margin(logits):
    """Each row's gap between its largest and second-largest logit, over
    its largest |logit| (how near a tie its greedy choice is)."""
    top = logits.float().topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) / logits.float().abs().amax(dim=-1)


def mesh_serve(torch, np, spec: dict, shape, mesh, impls):
    """The serving path under ``mesh`` (None: one process) as
    examples/serve_decode.py drives it: weights from ``prng.key(seed)`` on
    the card (this rank's shards), this rank's rows of the prompts, the
    prefill, the caches grown by ``gen`` (``grow_caches``) and donated,
    ``gen`` greedy steps; once an impl on the same weights. Returns, an impl each, the
    tokens and the prefill's and the last step's logits (this rank's rows,
    the whole vocabulary, on the CPU), the routing of every MoE call, the
    launches of the prefill and of the decode (the counters set to 0 before
    each and read after), TTFT (s), the decode steps (ms, CUDA events),
    the peak memory, this rank's bytes of the caches (its block of the
    sequence, every KV head) and what it would hold keeping the KV heads
    its queries read over the whole sequence (the KV-heads layout); and the
    seconds the weights took."""
    from repro_torch.core import prng
    from repro_torch.distributed.sharding import block, placement
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    dev = _card(torch)
    cfg = _mesh_cfg(spec)
    ax = _mesh_ax(shape)
    B, P, G = spec["batch"], spec["prompt"], spec["gen"]
    prompts = np.random.default_rng(spec["seed"]).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    out = []
    with use_mesh(mesh):
        pl = placement(ax)
        lo, hi = block(B, 1, 0) if pl is None else block(B, pl.d, pl.di)
        t0 = time.perf_counter()
        params = materialize(tf.param_defs(cfg, ax), prng.key(spec["seed"]),
                             device=dev, default_dtype=cfg.dtype)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        toks = torch.as_tensor(prompts[lo:hi], device=dev)
        for impl in impls:
            c = dataclasses.replace(cfg, moe_impl=impl)
            prefill = tf.make_prefill_step(c, ax)
            serve = tf.make_serve_step(c, ax, donate=True)
            prefill(params, {"tokens": toks[:, :128]})      # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            routes, gaps = [], []

            def tie(args, out):   # the experts, and the k + 1 largest
                routes.append(out[1].cpu().numpy())    # probabilities
                gaps.append(args[0].float().topk(args[1] + 1, dim=-1)
                            .values.cpu().numpy())

            with recording(moe, "top_k", tie):
                build.reset_launches()
                t0 = time.perf_counter()
                first, kvs = prefill(params, {"tokens": toks})
                torch.cuda.synchronize()
                ttft = time.perf_counter() - t0
                in_prefill = {k: v for k, v in build.LAUNCHES.items() if v}
                caches = tf.grow_caches(kvs, G, ax)
                del kvs
                cache_bytes = sum(t.numel() * t.element_size()
                                  for t in caches)
                k = caches[0]        # [L, B, n, Hkv, Dh]: this rank's block
                head_bytes = 2 * k.shape[0] * k.shape[1] * (P + G) * \
                    tf._Mesh(c, ax).hk * k.shape[4] * k.element_size()
                tok = first.argmax(dim=-1)[:, None].to(torch.int32)
                gen, margins = [tok], [_margin(first)]
                marks = [torch.cuda.Event(enable_timing=True)
                         for _ in range(G + 1)]
                build.reset_launches()
                marks[0].record()
                for i in range(G):
                    last, caches = serve(params, tok, caches, P + i)
                    tok = last.argmax(dim=-1)[:, None].to(torch.int32)
                    gen.append(tok)
                    margins.append(_margin(last))
                    marks[i + 1].record()
                torch.cuda.synchronize()
                in_decode = {k: v for k, v in build.LAUNCHES.items() if v}
            out.append(dict(
                impl=impl, gen=torch.cat(gen, 1).cpu().numpy(),
                margins=torch.stack(margins, 1).cpu().numpy(),
                first=first.float().cpu().numpy(),
                last=last.float().cpu().numpy(),
                routes=routes, gaps=gaps,
                in_prefill=in_prefill,
                in_decode=in_decode, ttft=ttft, cache_bytes=cache_bytes,
                head_bytes=head_bytes,
                steps=sorted(a.elapsed_time(b)
                             for a, b in zip(marks, marks[1:])),
                peak=torch.cuda.max_memory_allocated(),
                finite=bool(torch.isfinite(first).all()
                            and torch.isfinite(last).all())))
            del caches, first, last
        del params
    torch.cuda.empty_cache()
    return out, t_init


def mesh_train(torch, np, spec: dict, shape, mesh, save: str | None):
    """One make_train_step step (AdamWConfig(), attn_impl="chunked") of
    ``spec``'s config under ``mesh`` (None: one process) on this rank's
    rows of a batch drawn from the seed. Returns the loss and the gradient
    norm; the stepped parameters and AdamW's first moments (this rank's
    shards, on the CPU) go to ``save`` when given, else are returned."""
    from repro_torch.core import prng
    from repro_torch.distributed.sharding import block, placement
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = _card(torch)
    cfg = dataclasses.replace(_mesh_cfg(spec), attn_impl="chunked")
    ax = _mesh_ax(shape)
    B, S = spec["batch"], spec["seq"]
    tok = np.random.default_rng(spec["seed"]).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    with use_mesh(mesh):
        pl = placement(ax)
        lo, hi = block(B, 1, 0) if pl is None else block(B, pl.d, pl.di)
        params = materialize(tf.param_defs(cfg, ax), prng.key(spec["seed"]),
                             device=dev, default_dtype=cfg.dtype)
        batch = {"tokens": torch.as_tensor(tok[lo:hi, :-1], device=dev),
                 "labels": torch.as_tensor(tok[lo:hi, 1:], device=dev)}
        step = tf.make_train_step(cfg, ax, AdamWConfig())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, opt, m = step(params, adamw_init(params), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        leaves = dict(new=[t.cpu() for t in tree_leaves(new)],
                      m=[t.cpu() for t in tree_leaves(opt.m)])
        del params, new, opt
    torch.cuda.empty_cache()
    out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               wall=wall)
    if save is None:
        out.update(leaves)
    else:
        torch.save(leaves, save)
    return out


def _leaves_of(y):
    """A forward's outputs (a tensor, a tuple, MACE's dict by l) as a list."""
    if isinstance(y, dict):
        return [y[k] for k in sorted(y)]
    return list(y) if isinstance(y, tuple) else [y]


def mesh_model(torch, np, spec: dict, shape, mesh):
    """One job of MESH_MODELS under ``mesh`` (None: one process), weights
    from ``prng.key(seed)`` on the card (this rank's shards), the inputs
    drawn whole on the card from the seed and cut to this rank's block:
    AutoInt's train step on its rows of REC_SHAPES' train_batch and its
    serve scores at serve_p99, or a GNN's train step and forward on its
    node and edge rows; or AutoInt's retrieval of one query over this
    rank's block of ``n_cand`` candidates. One process writes its first
    moments, stepped parameters and outputs to ``spec["ref"]``; a rank
    reads its blocks of them there (memory-mapped) and returns its worst
    differences. Returns the loss, the gradient norm, the step's wall and
    the peak allocated on this rank."""
    from repro_torch.configs.registry import REC_SHAPES, _load
    from repro_torch.core import prng
    from repro_torch.data import RecsysBatcher
    from repro_torch.distributed.sharding import P, local_shard
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.models import autoint as ai
    from repro_torch.models import gnn
    from repro_torch.models.params import materialize, specs, tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init
    dev = _card(torch)
    ax = _mesh_ax(shape)
    seed = spec["seed"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def mine(t, sp):
        return t if mesh is None else local_shard(t, sp, mesh).contiguous()

    with use_mesh(mesh):
        if spec["arch"] == "autoint":
            cfg = _load("autoint")[1]
            defs = ai.autoint_param_defs(cfg, ax)

            def draw(B, s):
                return next(RecsysBatcher(B, cfg.n_sparse,
                                          cfg.vocab_per_field, cfg.multi_hot,
                                          seed=s, device=dev))
        if spec["kind"] == "retrieval":
            params = materialize(defs, prng.key(seed), device=dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            cand = torch.randn((spec["n_cand"], cfg.d_retrieval),
                               generator=gen, device=dev)
            batch = {"sparse_idx": draw(1, seed + 2)["sparse_idx"],
                     "cand_vecs": mine(cand, P(ax.model, None))}
            del cand
            step = ai.make_retrieval_step(cfg, ax, spec["top_k"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, idx = step(params, batch)
            torch.cuda.synchronize()
            # numpy, not tensors: a tensor put on the result queue is
            # shared through this process, which may have exited by the
            # time the parent reads it
            return dict(wall=time.perf_counter() - t0,
                        vals=vals.cpu().numpy(), idx=idx.cpu().numpy(),
                        peak=torch.cuda.max_memory_allocated())
        if spec["arch"] == "autoint":
            params = materialize(defs, prng.key(seed), device=dev)
            rows = P(ax.data)
            batch = {k: mine(v, rows) for k, v in draw(
                REC_SHAPES["train_batch"]["batch"], seed).items()}
            query = {"sparse_idx": mine(draw(
                REC_SHAPES["serve_p99"]["batch"], seed + 1)["sparse_idx"],
                rows)}
            step = ai.make_autoint_train_step(cfg, ax, AdamWConfig())

            def serve(p):
                return ai.make_autoint_serve_step(cfg, ax)(p, query)
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            cfg, defs, loss, whole = gnn_cell(
                torch, spec["arch"], spec["shape"], gen,
                spec.get("layers") or GRAPHCAST_LAYERS,
                bonded=spec["shape"] == "molecule")
            params = materialize(defs, prng.key(seed), device=dev)
            rows = P(ax.all)
            batch = {k: v if k == "graph_energy" else mine(v, rows)
                     for k, v in whole.items()}
            del whole
            step = gnn.make_gnn_train_step(loss, cfg, ax, AdamWConfig())
            fwd = gnn.MODELS[spec["arch"]][1]

            def serve(p):
                with torch.no_grad():
                    return fwd(p, batch, cfg, ax)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, opt, m = step(params, adamw_init(params), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ys = _leaves_of(serve(params))
        got = dict(m=tree_leaves(opt.m), new=tree_leaves(new), y=ys)
        if spec["kind"] == "gnn":
            # the gradients themselves, before AdamW's clip scales them
            got["grad"] = tree_leaves(gnn.value_and_grad(
                loss, params, batch, cfg, ax)[1])
        out = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                   wall=wall, peak=torch.cuda.max_memory_allocated())
        del params, opt, batch
        if mesh is None:
            top = {k: [float(torch.nan_to_num(t.float(), nan=0.0, posinf=0.0,
                                              neginf=0.0).abs().max())
                       for t in v] for k, v in got.items() if k != "new"}
            torch.save(dict({k: [t.cpu() for t in v]
                             for k, v in got.items()}, top=top), spec["ref"])
            return out
        ref = torch.load(spec["ref"], mmap=True)
        sp = dict(m=tree_leaves(specs(defs)), new=tree_leaves(specs(defs)),
                  grad=tree_leaves(specs(defs)), y=[P(rows[0])] * len(ys))
        lr = AdamWConfig().lr
        worst = dict(new=0.0, new_excess=float("-inf"))
        for key in got:
            for i, (t, whole) in enumerate(zip(got[key], ref[key],
                                               strict=True)):
                want = mine(whole, sp[key][i]).to(dev)
                diff = (t.float() - want.float()).abs()
                if not diff.numel():
                    continue
                if key == "new":
                    ulp = torch.exp2(torch.frexp(want.abs())[1].float() - 24)
                    worst["new"] = max(worst["new"], float(diff.max()))
                    worst["new_excess"] = max(worst["new_excess"], float(
                        (diff - 2 * lr - ulp).max()))
                    continue
                # NaN and inf count as equal only in the same places
                t, want = t.float(), want.float()
                same = (t == want) | (torch.isnan(t) & torch.isnan(want))
                err = float(torch.where(same, 0.0, diff).nan_to_num(
                    nan=float("inf")).max())
                top = ref["top"][key][i]
                rel = err / top if top else (0.0 if err == 0 else float("inf"))
                worst[key] = max(worst.get(key, 0.0), rel)
        out["worst"] = worst
        return out


def check_mesh_model(spec: dict, shape, parts, ref, label: str):
    """The ranks' results of a MESH_MODELS job (``parts``, a rank's
    ``mesh_model`` each) against one process's (``ref``): the loss and the
    gradient norm within MESH_LOSS_REL relative; the first moments, a
    GNN's gradients and the outputs (serve scores, the forward's rows)
    within MESH_GRAD_REL of each leaf's largest one-process value; the
    stepped parameters within 2 lr plus one ulp. Retrieval: the indices
    equal but where one process's adjacent scores lie within
    MESH_RETRIEVAL_TIE relative, the values within MESH_LOSS_REL of the
    largest."""
    name = f"{spec['arch']} {spec.get('shape', spec['kind'])}"
    walls = ", ".join(f"{p['wall']:.2f}" for p in parts)
    peak = max(p["peak"] for p in parts) / 2**30
    if spec["kind"] == "retrieval":
        import numpy as np
        v1, i1 = ref["vals"], ref["idx"]
        top = float(np.abs(v1).max())
        moved = 0
        for r, p in enumerate(parts):
            if float(np.abs(p["vals"] - v1).max()) > MESH_LOSS_REL * top:
                fail(f"{label}: retrieval rank {r}'s scores differ from one "
                     f"process's by {float(np.abs(p['vals'] - v1).max())}")
            for b, t in np.argwhere(p["idx"] != i1).tolist():
                near = [float(abs(v1[b, t] - v1[b, u])) for u in (t - 1, t + 1)
                        if 0 <= u < v1.shape[1]]
                if min(near) > MESH_RETRIEVAL_TIE * abs(float(v1[b, t])):
                    fail(f"{label}: retrieval rank {r}'s index {t} differs "
                         f"from one process's at no tie")
                moved += 1
        say(f"  {label} {name} on {shape}: top-{i1.shape[1]} of "
            f"{spec['n_cand']} candidates on every rank == one process's "
            f"({moved} indices moved at adjacent scores within "
            f"{MESH_RETRIEVAL_TIE}); {walls} s a rank, {ref['wall']:.3f} s "
            f"one process; peak {peak:.2f} GiB a rank")
        return
    if not (math.isfinite(ref["loss"]) and math.isfinite(ref["grad_norm"])):
        fail(f"{label}: {name}: one process's loss {ref['loss']} or gradient "
             f"norm {ref['grad_norm']} is not finite")
    for r, p in enumerate(parts):
        for key in ("loss", "grad_norm"):
            same = p[key] == ref[key]
            if not same and abs(p[key] - ref[key]) > MESH_LOSS_REL * abs(
                    ref[key]):
                fail(f"{label}: {name} rank {r} {key} {p[key]} vs one "
                     f"process {ref[key]}")
        w = p["worst"]
        if w["new_excess"] > 0 or any(v > MESH_GRAD_REL for k, v in
                                      w.items() if k in ("m", "grad", "y")):
            fail(f"{label}: {name} rank {r} differs from one process: {w}")
    w = {k: max(p["worst"].get(k, 0.0) for p in parts)
         for k in ("m", "grad", "y", "new")}
    say(f"  {label} {name} on {shape}: loss {parts[0]['loss']:.7g} vs "
        f"{ref['loss']:.7g} one process, grad norm "
        f"{parts[0]['grad_norm']:.7g} vs {ref['grad_norm']:.7g}; first "
        f"moments within {w['m']:.3g}"
        + (f", gradients within {w['grad']:.3g}" if spec["kind"] == "gnn"
           else "")
        + f", outputs within {w['y']:.3g} of each leaf's largest "
        f"(tolerance {MESH_GRAD_REL}), stepped parameters within "
        f"{w['new']:.3g} (2 lr + 1 ulp); step {walls} s a rank, "
        f"{ref['wall']:.3f} s one process; peak {peak:.2f} GiB a rank")

def mesh_rank(rank, world, backend, init, work, tmp, queue):
    """One rank of the mesh phase, a spawned process: for each item of
    ``work`` (("serve", spec, shape), ("train", spec, shape) or ("model",
    spec, shape)) joins the
    mesh of that shape over ``backend`` (one a shape) and runs it; the stepped
    parameters' shards go to ``tmp``. Puts (rank, "ok", results) on
    ``queue``."""
    try:
        if str(ROOT / "src") not in sys.path:
            sys.path.insert(0, str(ROOT / "src"))
        import numpy as np
        import torch
        import torch.distributed as tdist
        from repro_torch.launch.mesh import make_host_mesh
        torch.set_num_threads(1)
        torch.backends.cuda.matmul.allow_tf32 = False
        if backend == "gloo":
            torch.cuda.set_device(0)
        out = []
        # one mesh a shape: its axis groups (communicators, with their
        # buffers on the card under NCCL) made once, by its first job
        meshes = {}
        for kind, spec, shape in work:
            if shape not in meshes:
                meshes[shape] = make_host_mesh(
                    shape, MESH_AXES, backend=backend, init_method=init,
                    rank=rank, world_size=world, timeout=MESH_TIMEOUT)
            mesh = meshes[shape]
            t0 = time.perf_counter()
            if kind == "serve":
                out.append(mesh_serve(torch, np, spec, shape, mesh,
                                      spec["impls"]))
                runs, t_init = out[-1]
                done = (f"weights {t_init:.1f} s, TTFT "
                        + ", ".join(f"{x['ttft']:.2f}" for x in runs)
                        + " s, decode "
                        + ", ".join(f"{x['steps'][len(x['steps']) // 2]:.1f}"
                                    for x in runs) + " ms a step")
            elif kind == "model":
                out.append(mesh_model(torch, np, spec, shape, mesh))
                done = (f"{spec['arch']} {spec['kind']} "
                        f"{out[-1]['wall']:.2f} s")
            else:
                out.append(mesh_train(torch, np, spec, shape, mesh,
                                      f"{tmp}/train_{rank}.pt"))
                done = f"step {out[-1]['wall']:.2f} s"
            if rank == 0:
                print(f"mesh {backend} rank 0: {kind} {spec['arch']} on "
                      f"{shape}: {done}; {time.perf_counter() - t0:.1f} s",
                      file=sys.stderr, flush=True)
        queue.put((rank, "ok", out))
        tdist.destroy_process_group()
    except BaseException:
        import traceback
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_mesh(world: int, backend: str, init: str, work, tmp: str,
             label: str):
    """Spawn ``world`` ``mesh_rank`` processes and collect their results
    (rank order); fails on a rank's error or a timeout, and stops every
    process it started."""
    import queue as queue_mod

    import torch.multiprocessing as tmp_mp
    ctx = tmp_mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=mesh_rank, args=(r, world, backend, init,
                                                 work, tmp, q))
             for r in range(world)]
    got = {}
    try:
        for p in procs:
            p.start()
        while len(got) < world:
            try:
                rank, status, res = q.get(timeout=2 * MESH_TIMEOUT)
            except queue_mod.Empty:
                fail(f"mesh {label}: no result from ranks "
                     f"{sorted(set(range(world)) - set(got))}")
            if status != "ok":
                fail(f"mesh {label}: rank {rank} failed:\n{res}")
            got[rank] = res
    finally:
        for p in procs:
            p.join(60)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def _rows_of(parts, shape, pick):
    """A result of every data row laid together (the first model rank's;
    every model rank's must equal it): an array, or a list of arrays laid
    together one by one."""
    import numpy as np
    d, m = shape
    rows = []
    for di in range(d):
        row = [pick(p) for p in parts[di * m:(di + 1) * m]]
        for other in row[1:]:
            if not all(np.array_equal(a, b) for a, b in zip(
                    other if isinstance(other, list) else [other],
                    row[0] if isinstance(row[0], list) else [row[0]])):
                fail("mesh: the model ranks of a data row disagree")
        rows.append(row[0])
    if isinstance(rows[0], list):
        return [np.concatenate([r[i] for r in rows])
                for i in range(len(rows[0]))]
    return np.concatenate(rows)


def route_flips(np, routes, want, tops, B: int, P: int, L: int):
    """Where the MoE picks ``routes`` (a ``[T, k]`` array a call: the
    prefill's L calls over B x P tokens, then L a decode step, one token a
    row) differ from one process's ``want``, whose k + 1 largest router
    probabilities a token are ``tops``. A token whose set of experts
    changed is a root when no earlier move reached it; its margin is the
    gap between its k-th and (k+1)-th probability. A token whose experts
    are the same but in another order (the combine adds them in that
    order) has the gap between the two it swapped as its margin. A moved
    set changes its token's state and so, at every later layer, the picks
    of the tokens after it in its row (attention reads it) and of every
    token after it in the batch's row-major order (capacity keeps an
    expert's first tokens in that order): those are consequences. Returns
    (roots, reordered, consequences, the widest relative margin among
    roots and reorders, where it is: (call, row, position))."""
    width = P + len(routes) // L          # a row's positions, and more
    reached = np.inf                      # first (row, position) reached
    roots = swaps = later = 0
    worst, at = 0.0, None
    for c, (got, ref, top) in enumerate(zip(routes, want, tops)):
        S = P if c < L else 1
        pos = np.arange(S) + (0 if c < L else P + (c - L) // L)
        key = (np.arange(B)[:, None] * width + pos[None]).ravel()
        moved = (np.sort(got, -1) != np.sort(ref, -1)).any(-1)
        order = (got != ref).any(-1) & ~moved
        root = moved & (key < reached)
        k = got.shape[1]
        margin = np.zeros(len(got))
        margin[root] = ((top[:, k - 1] - top[:, k]) / top[:, k - 1])[root]
        for t in np.nonzero(order & (key < reached))[0]:
            j = int(np.argmax(got[t] != ref[t]))
            margin[t] = (top[t, j] - top[t, j + 1]) / top[t, j]
        roots += int(root.sum())
        swaps += int(order.sum())
        later += int((moved & ~root).sum())
        if margin.max() > worst:
            t = int(margin.argmax())
            worst, at = float(margin[t]), (c, t // S, int(pos[t % S]))
        if moved.any():
            reached = min(reached, key[moved].min())
    return roots, swaps, later, worst, at


def check_mesh_serve(np, spec, shape, parts, ref, label: str):
    """The ranks' serving results on the mesh of ``shape`` (``parts``: a
    rank's ``mesh_serve`` runs each) against the
    one-process run ``ref``: in f32 tokens and routing exact, the
    prefill's and the last step's logits within MESH_LOGITS_REL of the
    largest; in bf16 the tokens by ``_agreeing`` and the logits within
    MESH_BF16_REL (the last step's of the rows whose tokens agree); finite;
    each rank's prefill launched kernel 12's route for the type once a
    layer and nothing else, its decode no kernel. Prints TTFT and ms a
    step."""
    cfg = _mesh_cfg(spec)
    route = _route(cfg)
    rel = _logits_rel(cfg)
    for i, impl in enumerate(spec["impls"]):
        what = f"{label} {cfg.name} {cfg.n_layers} layers on {shape}" + (
            f" impl={impl}" if cfg.moe else "")
        runs = [p[i] for p in parts]
        for r, x in enumerate(runs):
            if (x["in_prefill"] != {route: cfg.n_layers}
                    or x["in_decode"] or not x["finite"]):
                fail(f"{what}: rank {r} launched {x['in_prefill']} in the "
                     f"prefill and {x['in_decode']} in decode (want "
                     f"{cfg.n_layers} {route}, then none), "
                     f"finite {x['finite']}")
        gen = _rows_of(runs, shape, lambda x: x["gen"])
        n = _agreeing(np, gen, ref, rel)
        errs = []
        for key, rows in (("first", n >= 0), ("last", n >= spec["gen"])):
            got = _rows_of(runs, shape, lambda x: x[key])[rows]
            want = ref[key][rows]
            errs.append(float(np.abs(got - want).max() / np.abs(want).max())
                        if rows.any() else 0.0)
        if rel == MESH_LOGITS_REL and not np.array_equal(gen, ref["gen"]):
            b, t = np.argwhere(gen != ref["gen"])[0]
            fail(f"{what}: greedy tokens differ from one process's "
                 f"({int((gen != ref['gen']).sum())} of {gen.size}; first "
                 f"at row {b} step {t}, where one process's top-2 gap is "
                 f"{ref['margins'][b, t]:.3g} of its largest logit; the "
                 f"prefill's and last logits {errs} of the largest apart; "
                 f"smallest gaps {np.sort(ref['margins'].ravel())[:4]})")
        if max(errs) > rel:
            fail(f"{what}: the prefill's and last logits {errs} of the "
                 f"largest from one process's (tolerance {rel})")
        if cfg.moe is not None:
            routes = _rows_of(runs, shape, lambda x: x["routes"])
            if len(routes) != len(ref["routes"]):
                fail(f"{what}: {len(routes)} MoE calls, one process "
                     f"{len(ref['routes'])}")
            roots, swaps, later, worst, at = route_flips(
                np, routes, ref["routes"], ref["gaps"], spec["batch"],
                spec["prompt"], cfg.n_layers)
            if worst >= MESH_ROUTE_TIE:
                fail(f"{what}: MoE routing differs from one process's at a "
                     f"token no earlier move reached (MoE call, row, "
                     f"position {at}) by {worst:.3g} of a probability "
                     f"(relative), past the {MESH_ROUTE_TIE} of a tie; "
                     f"{roots} sets moved, {swaps} orders, {later} reached")
        steps = max(x["steps"][len(x["steps"]) // 2] for x in runs)
        wide = int((ref["margins"] > 2 * rel).sum())
        say(f"  {what}: " + (
                f"tokens == one process's ({gen.shape[0]} x {gen.shape[1]})"
                if rel == MESH_LOGITS_REL else
                f"{int(n.sum())} of {gen.size} greedy tokens == one "
                f"process's, each row's up to its first that differs at a "
                f"top-2 gap within 2 x {rel} ({wide} of one process's "
                f"tokens at a gap past it)") + (
                f"; each token's experts == one process's but {roots} "
                f"(token, layer) sets and {swaps} orders within the top-k, "
                f"each at a near tie (within {worst:.3g} of a probability, "
                f"tie {MESH_ROUTE_TIE}), and {later} sets those reach at "
                f"later layers" if cfg.moe else ""))
        say(f"    prefill and last logits within {errs[0]:.3g}, "
            f"{errs[1]:.3g} of the largest (tolerance {rel}; the last of "
            f"{int((n >= spec['gen']).sum())} rows); "
            f"TTFT {max(x['ttft'] for x in runs):.3f} s (one process "
            f"{ref['ttft']:.3f} s), decode {steps:.2f} ms a step, median "
            f"of the slowest rank (one process "
            f"{ref['steps'][len(ref['steps']) // 2]:.2f} ms); peak "
            f"{max(x['peak'] for x in runs) / 2**30:.2f} GiB a rank; "
            f"kernel 12 ({route}) launched {cfg.n_layers} times in every "
            f"rank's prefill, none in decode; caches "
            f"{max(x['cache_bytes'] for x in runs)} B a rank, the "
            f"sequence over model (the KV-heads layout, the KV heads a rank's "
            f"queries read over the whole sequence: "
            f"{max(x['head_bytes'] for x in runs)} B)")


def check_mesh_train(torch, spec, shape, parts, ref, tmp: str, label: str):
    """The ranks' train steps (``parts``: a rank's ``mesh_train`` result
    each) against the one-process step ``ref``: the loss and the gradient
    norm within MESH_LOSS_REL relative; each rank's shard of every leaf's
    first moment (after one step, (1 - b1) times the clipped gradient)
    within MESH_GRAD_REL of the leaf's largest one-process value, and of
    its stepped parameters within 2 lr plus one ulp, against
    ``local_shard`` of the one-process leaf; the share of parameters that
    differ printed."""
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.launch.mesh import HostMesh
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import _leaves
    from repro_torch.optim import AdamWConfig
    cfg = _mesh_cfg(spec)
    defs = [d for _, d in _leaves(tf.param_defs(cfg, _mesh_ax(shape)))]
    lr = AdamWConfig().lr
    worst, worst_m, differ, total = 0.0, 0.0, 0, 0
    dev = _card(torch)
    top_m = [float(w.abs().max()) for w in ref["m"]]
    for r, x in enumerate(parts):
        for key in ("loss", "grad_norm"):
            if abs(x[key] - ref[key]) > MESH_LOSS_REL * abs(ref[key]):
                fail(f"{label}: rank {r} {key} {x[key]} vs one process "
                     f"{ref[key]}")
        mesh = HostMesh(shape=shape, axis_names=MESH_AXES, backend="gloo",
                        rank=r)
        mine = torch.load(f"{tmp}/train_{r}.pt")
        for d, got, whole, top in zip(defs, mine["m"], ref["m"], top_m,
                                      strict=True):
            want = local_shard(whole, d.pspec, mesh).to(dev)
            if not want.numel():
                continue
            err = float((got.to(dev) - want).abs().max()) / max(top, 1e-30)
            worst_m = max(worst_m, err)
            if err > MESH_GRAD_REL:
                fail(f"{label}: rank {r}'s gradient (first moment) differs "
                     f"from one process's by {err:.3g} of its largest, past "
                     f"{MESH_GRAD_REL}")
        for d, got, whole in zip(defs, mine["new"], ref["new"], strict=True):
            want = local_shard(whole, d.pspec, mesh).to(dev).float()
            diff = (got.to(dev).float() - want).abs()
            bits = 8 if got.dtype == torch.bfloat16 else 24
            ulp = torch.exp2(torch.frexp(want.abs())[1].float() - bits)
            excess = float((diff - 2 * lr - ulp).max()) if diff.numel() \
                else 0.0
            worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
            differ += int((diff > 0).sum())
            total += diff.numel()
            if excess > 0:
                fail(f"{label}: rank {r}'s stepped shard differs from one "
                     f"process's by {float(diff.max())}, past 2 lr + 1 ulp")
    say(f"  {label} {cfg.name} {cfg.n_layers} layers on {shape}: loss "
        f"{parts[0]['loss']:.6f} vs {ref['loss']:.6f} one process, "
        f"grad norm {parts[0]['grad_norm']:.7g} vs {ref['grad_norm']:.7g} "
        f"(tolerance {MESH_LOSS_REL}); gradients (first moments) within "
        f"{worst_m:.3g} of a leaf's largest (tolerance {MESH_GRAD_REL}); "
        f"stepped parameters within {worst:.3g} (2 lr = {2 * lr}), "
        f"{differ} of {total} elements not bit-equal; step "
        f"{max(p['wall'] for p in parts):.2f} s on the ranks, "
        f"{ref['wall']:.2f} s one process")


def mesh_phase(torch, np, card: str):
    """The LMs under a (data, model) mesh of processes on the card: the
    one-process runs of MESH_SERVE and MESH_TRAIN, then MESH_RANKS gloo
    ranks sharing the card run them on their meshes (check_mesh_serve,
    check_mesh_train). Then, with two cards or more, the same over NCCL,
    one rank a card (and with four, mistral-large at full depth on (1,
    4), its TTFT and decode ms a step printed); with one card it says so.
    Fails on any mismatch."""
    import tempfile
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as ref_dir:
        models = [dict(spec, ref=f"{ref_dir}/model_{i}.pt")
                  for i, spec in enumerate(MESH_MODELS)]
        _mesh_phase(torch, np, card, MESH_SERVE, MESH_TRAIN, models)
    mesh_wide(torch, np, card, MESH_WIDE)
    say(f"mesh phase: {time.perf_counter() - t_phase:.1f} s")


def mesh_wide(torch, np, card: str, spec: dict):
    """``spec``'s serving job (MESH_WIDE) on its one mesh, a model axis
    wider than the KV heads, MESH_WIDE_RANKS gloo ranks sharing the card,
    against one process (check_mesh_serve: tokens exact, the last logits
    within MESH_LOGITS_REL of the largest, kernel 12 once a layer in the
    prefill and none in decode; a rank's cache bytes printed beside the
    KV-heads layout's)."""
    import tempfile
    cfg = _mesh_cfg(spec)
    runs, t_init = mesh_serve(torch, np, spec, (1, 1), None, spec["impls"])
    say(f"mesh phase: {cfg.name} at its published widths, {cfg.n_layers} "
        f"layers, {cfg.n_params()} params ({cfg.dtype}), one process: "
        f"weights {t_init:.1f} s, TTFT {runs[0]['ttft']:.3f} s for "
        f"{spec['batch']} x {spec['prompt']} tokens, caches "
        f"{runs[0]['cache_bytes']} B; {card}")
    shape = spec["meshes"][0]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parts = run_mesh(MESH_WIDE_RANKS, "gloo", f"file://{tmp}/store",
                         [("serve", spec, shape)], tmp, "gloo wide")
        wall = time.perf_counter() - t0
    check_mesh_serve(np, spec, shape, [p[0][0] for p in parts], runs[0],
                     "mesh gloo")
    say(f"mesh gloo wide: {MESH_WIDE_RANKS} ranks sharing the card, "
        f"{cfg.n_kv_heads} KV heads over a model axis of {shape[1]}, "
        f"{wall:.1f} s ({card})")


def _fit(shape, world: int):
    """A mesh of ``world`` ranks in ``shape``'s place: (1, m) -> (1,
    world), (d, m) -> (2, world // 2)."""
    return shape if shape[0] * shape[1] == world else (
        (1, world) if shape[0] == 1 else (2, world // 2))


def _mesh_phase(torch, np, card: str, serve, train, models=()):
    import socket
    import tempfile
    refs = []
    for spec in serve:
        cfg = _mesh_cfg(spec)
        runs, t_init = mesh_serve(torch, np, spec, (1, 1), None, ("shmap",))
        refs.append(runs[0])
        say(f"mesh phase: {cfg.name} at its published widths, "
            f"{cfg.n_layers} layers, {cfg.n_params()} params "
            f"({cfg.dtype}), one process: weights {t_init:.1f} s, TTFT "
            f"{runs[0]['ttft']:.3f} s for {spec['batch']} x "
            f"{spec['prompt']} tokens, decode "
            f"{runs[0]['steps'][len(runs[0]['steps']) // 2]:.2f} ms a step, "
            f"peak {runs[0]['peak'] / 2**30:.2f} GiB; {card}")
    train_ref = mesh_train(torch, np, train, (train["mesh"][0], 1), None,
                           None)
    model_refs = []
    for spec in models:
        model_refs.append(mesh_model(torch, np, spec, (1, 1), None))
        x = model_refs[-1]
        say(f"mesh phase: {spec['arch']} {spec.get('shape', spec['kind'])} "
            f"at its published widths"
            + (f", {spec['layers']} layers" if spec.get("layers") else "")
            + f", one process: {spec['kind']} {x['wall']:.3f} s, peak "
            f"{x['peak'] / 2**30:.2f} GiB; {card}")
    work = [("serve", i, shape) for i, spec in enumerate(serve)
            for shape in spec["meshes"]]
    work.append(("train", None, train["mesh"]))
    work += [("model", i, spec["mesh"]) for i, spec in enumerate(models)]

    def items(world):
        return [(kind, serve[i] if kind == "serve" else models[i]
                 if kind == "model" else train, _fit(shape, world))
                for kind, i, shape in work]

    def check(parts, world, label, tmp):
        for j, (kind, i, shape) in enumerate(work):
            shape = _fit(shape, world)
            if kind == "serve":
                check_mesh_serve(np, serve[i], shape,
                                 [p[j][0] for p in parts], refs[i], label)
            elif kind == "model":
                check_mesh_model(models[i], shape, [p[j] for p in parts],
                                 model_refs[i], label)
            else:
                check_mesh_train(torch, train, shape, [p[j] for p in parts],
                                 train_ref, tmp, f"{label} train")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parts = run_mesh(MESH_RANKS, "gloo", f"file://{tmp}/store",
                         items(MESH_RANKS), tmp, "gloo")
        wall = time.perf_counter() - t0
        check(parts, MESH_RANKS, "mesh gloo", tmp)
    say(f"mesh gloo: {MESH_RANKS} ranks sharing the card, jobs "
        f"{len(work)}, {wall:.1f} s; every collective goes through gloo, "
        f"time-sliced on one card: not a deployment's speed ({card})")
    n = torch.cuda.device_count()
    if n < 2:
        say(f"mesh nccl: not run: {n} CUDA device on this machine; NCCL "
            f"takes one rank a card")
        return
    world = 4 if n >= 4 else 2
    nwork = items(world)
    if world == 4:
        nwork.append(("serve", MESH_FULL, (1, 4)))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parts = run_mesh(world, "nccl", f"tcp://localhost:{port}", nwork,
                         tmp, "nccl")
        wall = time.perf_counter() - t0
        check(parts, world, "mesh nccl", tmp)
        if world == 4:
            runs = [p[-1][0][0] for p in parts]
            cfg = _mesh_cfg(MESH_FULL)
            if not all(x["finite"] and x["in_prefill"] == {
                    _route(cfg): cfg.n_layers} and not x["in_decode"]
                    for x in runs):
                fail("mesh nccl full depth: a rank's logits or launches are "
                     "off")
            steps = max(x["steps"][len(x["steps"]) // 2] for x in runs)
            say(f"  mesh nccl {cfg.name} full depth ({cfg.n_layers} layers, "
                f"{cfg.dtype}) on (1, 4), one rank a card: TTFT "
                f"{max(x['ttft'] for x in runs):.3f} s for "
                f"{MESH_FULL['batch']} x {MESH_FULL['prompt']} tokens, decode"
                f" {steps:.2f} ms a step (median, slowest rank), with the "
                f"caches' sequence over model (the KV-heads layout: TTFT "
                f"1.272 s, 224.25 ms a step on four H100 80GB HBM3 at 700 W),"
                f" peak "
                f"{max(x['peak'] for x in runs) / 2**30:.2f} GiB a card, "
                f"caches {max(x['cache_bytes'] for x in runs)} B a card")
    say(f"mesh nccl: {world} ranks, one a card, jobs {len(nwork)}, "
        f"{wall:.1f} s ({card})")

# ---- cards: the kernels and entry points on a card that is not current ------
# With two cards or more the part runs in this process with card 0 the
# current card throughout (it never calls torch.cuda.set_device): work
# placed on cuda:k must launch there and allocate nothing on card 0.
CARDS_K = 16                    # queries a batch (the main path's)
CARDS_GUARD_TURNS = dict(reps=101, calls=20)   # host time a call, in turns
CARDS_TRAIN_ARGS = ("--arch", "olmoe-1b-7b", "--smoke", "--steps", "3",
                    "--log-every", "1")


def cards_moved(x, dev):
    """``x`` (a tensor, or tuples and lists of them) on ``dev``; anything
    else (None, a flag, a number) as it is."""
    if isinstance(x, (tuple, list)):
        return type(x)(cards_moved(a, dev) for a in x)
    return x.to(dev) if hasattr(x, "to") else x


def cards_sync(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def nothing_on_card0(torch, label: str):
    """Fail unless the work inside leaves card 0 the current card and
    allocates nothing on card 0 at any time: its allocated bytes before,
    at the peak and after are equal."""
    gc.collect()
    cards_sync(torch)
    if torch.cuda.current_device() != 0:
        fail(f"cards: {label}: the current card is "
             f"{torch.cuda.current_device()} before the work, not 0")
    before = torch.cuda.memory_allocated(0)
    torch.cuda.reset_peak_memory_stats(0)
    yield
    cards_sync(torch)
    cur = torch.cuda.current_device()
    peak, after = (torch.cuda.max_memory_allocated(0),
                   torch.cuda.memory_allocated(0))
    if cur != 0:
        fail(f"cards: {label}: the work left card {cur} current")
    if peak != before or after != before:
        fail(f"cards: {label}: card 0's allocation moved: {before} B "
             f"before, peak {peak} B, {after} B after")


def cards_kernel_cases(torch, np, engines, sources, src7, g6):
    """Kernels 1-13 at the shapes of the kernel phases (dense_kernel_phase,
    ragged_kernel_phase, round_kernel_phase, single_phase, embag_phase,
    flash_phase), their operands made on card 0, the current card, by the
    card-0 ``engines`` after round 2 of a solve and by the kernels there.
    Returns [(label, counter, kernel, plain, args, kw, kernel_kw, check)]:
    ``kernel_kw`` (live chunks, tile bounds) goes to the kernel alone;
    ``check`` is "equal", "bf16" or "f32" (kernel 12's tolerances)."""
    import torch.nn.functional as F
    from repro_torch.graph import graph_to_numpy
    from repro_torch.kernels.common import live_chunks, pad_last, take_fill
    from repro_torch.kernels.embedding_bag import (embedding_bag_p,
                                                   embedding_bag_p_plain)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_p_plain)
    from repro_torch.kernels.merge import (merge_scatter_ragged,
                                           merge_scatter_ragged_plain,
                                           merge_scatter_tiled,
                                           merge_scatter_tiled_plain)
    from repro_torch.kernels.relax import (
        build_dst_tiled_layout, fixpoint_operands,
        relax_dst_ragged_fixpoint_batch,
        relax_dst_ragged_fixpoint_batch_plain, relax_dst_tiled,
        relax_dst_tiled_fixpoint, relax_dst_tiled_fixpoint_batch,
        relax_dst_tiled_fixpoint_batch_plain, relax_dst_tiled_fixpoint_plain,
        relax_dst_tiled_masked, relax_dst_tiled_masked_plain,
        relax_dst_tiled_plain)
    from repro_torch.kernels.round import (fused_round_operands,
                                           fused_round_ragged,
                                           fused_round_ragged_plain,
                                           fused_round_tiled,
                                           fused_round_tiled_plain)
    from repro_torch.kernels.send import (send_operands, send_pack_ragged,
                                          send_pack_ragged_plain,
                                          send_pack_tiled,
                                          send_pack_tiled_plain,
                                          send_payload_bucket)
    inf = float("inf")
    dev0 = torch.device("cuda", 0)
    cases = []

    def mid(eng, srcs):
        carry = eng.start(srcs)
        for _ in range(2):
            carry = eng.round_fn(carry)
        return carry

    # ---- kernels 1, 3, 5 (dense, staged) and 2, 4, 6 (ragged, staged) ----
    for label, eng, srcs, ragged in (
            ("scale-1e6 dense", engines["dense"], sources, False),
            ("scale-1e7 ragged", engines["ragged"], src7, True)):
        sh, cfg = eng.shards, eng.cfg
        P, K = sh.n_parts, len(srcs)
        c = mid(eng, srcs)
        act = c.active & ~c.done[..., None]
        lay = sh.relax_layout
        bp = -(-sh.block // sh.rx_vb) * sh.rx_vb
        r_in = fixpoint_operands(c.dist, act, c.pruned[:, :sh.e_loc], lay[3],
                                 bp)
        r_kw = dict(vb=sh.rx_vb, n_sweeps=cfg.pallas_sweeps)
        if ragged:
            r_args = (*r_in[:2], lay[4], *lay[:3], r_in[2])
            cases.append((f"kernel 2 ({label})", "relax_ragged",
                          relax_dst_ragged_fixpoint_batch,
                          relax_dst_ragged_fixpoint_batch_plain, r_args, r_kw,
                          {}, "equal"))
            r_out = relax_dst_ragged_fixpoint_batch(*r_args, **r_kw)
        else:
            r_args = (*r_in[:2], *lay[:3], r_in[2])
            for how, kk in (("live chunks", dict(chunks=sh.relax_chunks)),
                            ("pre-pass", {})):
                cases.append((f"kernel 1 ({label}, {how})", "relax",
                              relax_dst_tiled_fixpoint_batch,
                              relax_dst_tiled_fixpoint_batch_plain, r_args,
                              r_kw, kk, "equal"))
            r_out = relax_dst_tiled_fixpoint_batch(*r_args, **r_kw,
                                                   chunks=sh.relax_chunks)
        dist = r_out[0][..., :sh.block]
        tx = sh.send_layout
        pruned_t = take_fill(c.pruned[:, sh.e_loc:].to(torch.int32),
                             tx[3].reshape(P, -1), 0).reshape(tx[3].shape)
        s_rows = send_operands(dist, c.last_sent, sh.slot_valid,
                               sh.n_stiles if ragged else tx[0].shape[1],
                               sh.tx_sb)
        if ragged:
            s_args = (*s_rows, tx[4], *tx[:3], pruned_t)
            s_kk = dict(bounds=sh.send_bounds)
            send, send_plain, name, counter = (
                send_pack_ragged, send_pack_ragged_plain, "kernel 4",
                "send_ragged")
        else:
            s_args = (*s_rows, *tx[:3], pruned_t)
            s_kk = {}
            send, send_plain, name, counter = (
                send_pack_tiled, send_pack_tiled_plain, "kernel 3", "send")
        cases.append((f"{name} ({label})", counter, send, send_plain, s_args,
                      dict(sb=sh.tx_sb), s_kk, "equal"))
        s_out = send(*s_args, sb=sh.tx_sb, **s_kk)
        payload = send_payload_bucket(s_out[0][..., :sh.n_slots],
                                      sh.tx_payload_slot)
        incoming = payload.transpose(0, 2).reshape(P, K, -1).contiguous()
        mx = sh.merge_layout
        m_rows = (pad_last(dist, -(-sh.block // sh.mx_vb) * sh.mx_vb, inf),
                  incoming)
        if ragged:
            cases.append((f"kernel 6 ({label})", "merge_ragged",
                          merge_scatter_ragged, merge_scatter_ragged_plain,
                          (*m_rows, mx[3], *mx[:3]), dict(vb=sh.mx_vb),
                          dict(bounds=sh.merge_bounds), "equal"))
        else:
            cases.append((f"kernel 5 ({label})", "merge", merge_scatter_tiled,
                          merge_scatter_tiled_plain, (*m_rows, *mx),
                          dict(vb=sh.mx_vb), {}, "equal"))

    # ---- kernels 7 (dense) and 8 (ragged): the fused round at round 2 ------
    for label, eng, srcs, ragged in (
            ("scale-1e6 dense", engines["dense fused"], sources, False),
            ("scale-1e7 ragged", engines["ragged fused"], src7, True)):
        sh, cfg = eng.shards, eng.cfg
        P, K = sh.n_parts, len(srcs)
        c = mid(eng, srcs)
        live = ~c.done
        ops = fused_round_operands(
            c.dist, c.active & live[..., None], live,
            c.incoming.reshape(P, K, -1), c.last_sent, sh.slot_valid,
            sh.relax_layout, sh.send_layout, sh.merge_layout,
            c.pruned[:, :sh.e_loc], c.pruned[:, sh.e_loc:], vb=sh.rx_vb,
            sb=sh.tx_sb, dense=False)
        kw = dict(vb=sh.rx_vb, sb=sh.tx_sb, n_sweeps=cfg.pallas_sweeps,
                  dense=False)
        if ragged:
            cases.append((f"kernel 8 ({label})", "round_ragged",
                          fused_round_ragged, fused_round_ragged_plain, ops,
                          kw, {}, "equal"))
        else:
            cases.append((f"kernel 7 ({label})", "round", fused_round_tiled,
                          fused_round_tiled_plain, ops, kw,
                          dict(chunks=sh.round_chunks), "equal"))

    # ---- kernels 9, 10, 11: scale-1e6 as one block, a mid-solve state ------
    vb, eb = 128, 512
    edges = graph_to_numpy(g6)
    src_t, w_t, dr_t, eid_t, bp = build_dst_tiled_layout(
        *edges, g6.n_vertices, vb=vb, eb=eb, with_eid=True)
    lay = tuple(a.to(dev0) for a in (src_t, w_t, dr_t))
    eid = eid_t.to(dev0)
    p10 = torch.from_numpy((np.random.default_rng(14).random(
        len(edges[0])) < 0.1).astype(np.int32)).to(dev0)
    pr10 = take_fill(p10, eid.reshape(-1), 0).reshape(eid.shape)
    chunks = live_chunks(lay[1][None] < inf)
    d = torch.full((bp,), inf, device=dev0)
    f = torch.zeros(bp, device=dev0)
    d[sources[0]], f[sources[0]] = 0.0, 1.0
    for _ in range(3):              # three masked steps, as single_phase
        new, _ = relax_dst_tiled_masked(d, f, *lay, torch.zeros_like(pr10),
                                        vb=vb, chunks=chunks)
        f, d = (new < d).float(), new
    args9 = (d, f, *lay, pr10)
    cases.append(("kernel 9 (scale-1e6 as one block)", "relax_single",
                  relax_dst_tiled_fixpoint, relax_dst_tiled_fixpoint_plain,
                  args9, dict(vb=vb, n_sweeps=2), {}, "equal"))
    for how, kk in (("live chunks", dict(chunks=chunks)), ("pre-pass", {})):
        cases.append((f"kernel 10 (scale-1e6 as one block, {how})",
                      "relax_masked", relax_dst_tiled_masked,
                      relax_dst_tiled_masked_plain, args9, dict(vb=vb), kk,
                      "equal"))
        cases.append((f"kernel 11 (scale-1e6 as one block, {how})",
                      "relax_sweep", relax_dst_tiled, relax_dst_tiled_plain,
                      (d, *lay), dict(vb=vb), kk, "equal"))

    # ---- kernel 13: AutoInt's table and bags (embag_phase) ----------------
    V, D = AUTOINT["fields"] * AUTOINT["vocab"], AUTOINT["dim"]
    gen = torch.Generator(device=dev0)
    gen.manual_seed(13)
    table = torch.randn((V, D), generator=gen, device=dev0)

    def bags(B, L):
        idx = torch.randint(0, V, (B, L), generator=gen, device=dev0,
                            dtype=torch.int32)
        u = torch.rand((B, L), generator=gen, device=dev0)
        idx = torch.where(u < 0.05, idx - V, idx)
        return torch.where(u > 0.95, V, idx).to(torch.int32).contiguous()

    multi = bags(TRAIN_BATCH * AUTOINT["fields"], 4)
    for what, t, i, mode in (
            ("serve sum", table, bags(SERVE_BULK * AUTOINT["fields"], 1),
             "sum"),
            ("multi-hot mean f32", table, multi, "mean"),
            ("multi-hot mean bf16", table.to(torch.bfloat16), multi, "mean")):
        cases.append((f"kernel 13 ({what})", "embedding_bag", embedding_bag_p,
                      embedding_bag_p_plain, (t, i), dict(mode=mode), {},
                      "equal"))

    # ---- kernel 12: the flash phase's shapes, each type on its route -------
    gen = torch.Generator(device=dev0)
    gen.manual_seed(12)
    B, H, _, S, D = FLASH_SHAPES[SERVE["arch"]]
    skv = S + SERVE["gen"]
    runs = [(arch, dt, B_, Hq, Hkv, S_, S_, D_, 0)
            for arch, (B_, Hq, Hkv, S_, D_) in FLASH_SHAPES.items()
            for dt in ("bfloat16", "float32")]
    runs += [(f"{SERVE['arch']} decode", dt, B, H, H, 1, skv, D, skv - 1)
             for dt in ("bfloat16", "float32")]
    route = {"bfloat16": "flash_attention_tc", "float32": "flash_attention"}
    for name, dt, B_, Hq, Hkv, Sq, Skv, D_, off in runs:
        dtype = getattr(torch, dt)
        q = torch.randn((B_, Hq, Sq, D_), generator=gen, device=dev0).to(dtype)
        k, v = (torch.randn((B_, Hkv, Skv, D_), generator=gen, device=dev0)
                .to(dtype) for _ in range(2))
        bq, bk = min(128, Sq), min(128, Skv)

        def plain(q, k, v, *, bq=bq, bk=bk, off=off, Sq=Sq, Skv=Skv, D_=D_):
            def pad(t, b):
                return F.pad(t, (0, 0, 0, (-t.shape[2]) % b))
            return flash_attention_p_plain(
                pad(q, bq), pad(k, bk), pad(v, bk), scale=D_ ** -0.5,
                causal=True, q_offset=off, kv_len=Skv, block_q=bq,
                block_k=bk)[:, :, :Sq]

        cases.append((f"kernel 12 ({name} {dt})", route[dt], flash_attention,
                      plain, (q, k, v), {},
                      dict(causal=True, q_offset=off, block_q=bq),
                      "bf16" if dt == "bfloat16" else "f32"))
    return cases


def cards_check(torch, label, check, out, ref):
    """Kernel against plain on the same card: bit-equal, or kernel 12's
    tolerance (2 bf16 ulps; 2e-5 in f32). Returns the max abs error."""
    out = out if isinstance(out, tuple) else (out,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if check == "equal":
        return compare(torch, f"cards: {label}", out, ref)
    err = float((out[0].float() - ref[0].float()).abs().max())
    ok = (err <= FLASH_F32_TOL if check == "f32"
          else bf16_ulps(torch, out[0], ref[0]) <= FLASH_BF16_ULPS)
    if not (ok and bool(torch.isfinite(out[0]).all())):
        fail(f"cards: {label}: kernel vs plain max abs err {err}")
    return err


def cards_kernels(torch, cases, dev):
    """Every case's kernel on ``dev`` (the current card stays 0) against
    its plain version on ``dev``, its launch counted, card 0's allocation
    still. A launch that raises is printed and the job fails after the
    last case, so one run shows what each kernel family does."""
    from repro_torch.kernels import build
    errors = []
    t0 = time.perf_counter()
    with nothing_on_card0(torch, f"kernels 1-13 on {dev}"):
        for label, counter, kernel, plain, args, kw, kk, check in cases:
            a = cards_moved(args, dev)
            kk = {key: cards_moved(val, dev) for key, val in kk.items()}
            build.reset_launches()
            try:
                out = kernel(*a, **kw, **kk)
                torch.cuda.synchronize(dev)
            except Exception as e:          # noqa: BLE001  (fails below)
                errors.append(label)
                say(f"  cards: {label} on {dev}: {type(e).__name__}: {e}")
                continue
            launched = dict(build.LAUNCHES)
            if launched[counter] < 1 or sum(launched.values()) != launched[
                    counter]:
                fail(f"cards: {label}: launches {launched}, want {counter}")
            outs = out if isinstance(out, tuple) else (out,)
            if any(o.device != dev for o in outs):
                fail(f"cards: {label}: outputs on "
                     f"{[str(o.device) for o in outs]}, not {dev}")
            err = cards_check(torch, label, check, out, plain(*a, **kw))
            say(f"  cards: {label} on {dev}: {counter} launched "
                f"{launched[counter]}x, " + (
                    "bit-equal to plain" if check == "equal" else
                    f"max abs err {err:.3g} vs plain") + " on the same card")
            del a, kk, out, outs
    if errors:
        fail(f"cards: {len(errors)} of {len(cases)} kernel calls on {dev} "
             f"raised with card 0 current: {errors}")
    say(f"cards kernels: {len(cases)} calls, kernels 1-13 on {dev} with card "
        f"0 current, each == its plain version on {dev} (bit for bit but "
        f"kernel 12: {FLASH_BF16_ULPS} bf16 ulps, {FLASH_F32_TOL} in f32), "
        f"card 0's allocation still; {time.perf_counter() - t0:.1f} s")


def cards_guard_cost(torch, cases, dev):
    """Host time a call of kernels 3, 5, 10 and 11 (10 and 11 with the live
    chunks) four ways (``guard_turns``): on ``dev``, where the guard sets
    the card, and on card 0, the current card, as the wrappers are,
    without the device guard, and on the parent's path (the baseline)."""
    card0 = torch.device("cuda", 0)
    for label, counter, kernel, _, args, kw, kk, _ in cases:
        if not (counter in ("send", "merge")
                or counter in ("relax_masked", "relax_sweep") and kk):
            continue
        fn = {}
        for d in (card0, dev):
            k2 = {key: cards_moved(val, d) for key, val in kk.items()}
            fn[d] = functools.partial(kernel, *cards_moved(args, d), **kw,
                                      **k2)
        say(f"  cards: {label}: host a call, medians of "
            f"{CARDS_GUARD_TURNS['reps']} turns of "
            f"{CARDS_GUARD_TURNS['calls']} calls: " + ", ".join(guard_turns(
                torch, [(f"on {dev} (the guard sets it)", fn[dev],
                         contextlib.nullcontext),
                        ("as is on cuda:0", fn[card0],
                         contextlib.nullcontext),
                        ("no device guard", fn[card0],
                         lambda: unguarded_launches(guard_only=True)),
                        ("parent's path", fn[card0], unguarded_launches)])))


def cards_mixed(torch, cases, dev):
    """Each kernel family with one operand on cuda:0 and the rest on
    ``dev``: ValueError naming both cards, and no launch."""
    from repro_torch.kernels import build

    def one_on_card0(args):
        args = list(args)
        for i in reversed(range(len(args))):
            a = args[i]
            if isinstance(a, tuple):
                moved = one_on_card0(a)
                if moved is not None:
                    args[i] = tuple(moved)
                    return args
            elif hasattr(a, "to"):
                args[i] = a.to(torch.device("cuda", 0))
                return args
        return None

    seen = set()
    for label, counter, kernel, _, args, kw, kk, _ in cases:
        if (counter, tuple(kk)) in seen:
            continue
        seen.add((counter, tuple(kk)))
        a = one_on_card0(cards_moved(args, dev))
        k2 = {key: cards_moved(val, dev) for key, val in kk.items()}
        build.reset_launches()
        try:
            kernel(*a, **kw, **k2)
        except ValueError as e:
            if str(dev) not in str(e) or "cuda:0" not in str(e):
                fail(f"cards: {label}, mixed cards: {e}")
        else:
            fail(f"cards: {label} with one operand on cuda:0 and the rest on "
                 f"{dev} did not raise")
        if sum(build.LAUNCHES.values()):
            fail(f"cards: {label}, mixed cards: launches {build.LAUNCHES}")
        del a, k2
    say(f"cards mixed: {len(seen)} kernel calls with one operand on cuda:0 "
        f"and the rest on {dev}: each raised ValueError naming both cards "
        f"before any launch")


def cards_sssp(torch, np, shards, engines, sources, src7, n: int):
    """The SSSP engine on a card that is not current: scale-1e7 ragged
    staged (all kernels) and fused on cuda:1, scale-1e6 dense all-kernel
    on cuda:2, each equal to the same engine on cuda:0 bit for bit
    (distances, every counter, status), two solves each, the second's
    wall printed beside card 0's; engine_for, submit and drain on cuda:1
    against card 0's solve; the runner with --device cuda:1 (validated).
    Nothing of it allocates on card 0."""
    from repro_torch.core import SsspEngine, engine_for
    from repro_torch.kernels import build
    jobs = (("scale-1e7 ragged staged", "ragged", src7, 1,
             ("relax_ragged", "send_ragged", "merge_ragged")),
            ("scale-1e7 ragged fused", "ragged fused", src7, 1,
             ("round_ragged",)),
            ("scale-1e6 dense all-kernel", "dense", sources, 2,
             ("relax", "send", "merge")))
    for label, key, srcs, k, kernels in jobs:
        dev = torch.device("cuda", min(k, n - 1))
        eng0 = engines[key]
        want = [eng0.solve(srcs) for _ in range(2)]
        with nothing_on_card0(torch, f"{label} on {dev}"):
            eng = SsspEngine.build(shards[key.split()[0]], eng0.cfg,
                                   device=dev)
            build.reset_launches()
            got = [eng.solve(srcs) for _ in range(2)]
            launched = dict(build.LAUNCHES)
        for g, w in zip(got, want):
            same_results(g, w, f"cards: {label} on {dev} vs cuda:0")
        if got[-1].device != str(dev) or want[-1].device != "cuda:0":
            fail(f"cards: {label}: results name {got[-1].device} and "
                 f"{want[-1].device}")
        if any(launched[name] < 1 for name in kernels):
            fail(f"cards: {label} on {dev}: launches {launched}")
        say(f"cards sssp: {label} on {dev} == cuda:0 bit for bit "
            f"(distances, every counter, status {got[-1].status}, "
            f"{int(got[-1].stats.rounds)} rounds), QueryResult.device "
            f"{got[-1].device}; wall {got[-1].wall_s:.4f} s vs "
            f"{want[-1].wall_s:.4f} s on cuda:0 (second solves; first "
            f"{got[0].wall_s:.4f} vs {want[0].wall_s:.4f} s); launches "
            + ", ".join(f"{name} {launched[name]}" for name in kernels))
        del eng, got
    # the serving surface: engine_for, submit and drain on cuda:1
    dev = torch.device("cuda", min(1, n - 1))
    want = engines["dense"].solve(sources[:4])
    with nothing_on_card0(torch, f"engine_for, submit, drain on {dev}"):
        eng = engine_for(shards["dense"], engines["dense"].cfg, device=dev)
        if engine_for(shards["dense"], engines["dense"].cfg,
                      device=str(dev)) is not eng:
            fail("cards: engine_for did not reuse the engine of its card")
        hs = [eng.submit(s) for s in sources[:4]]
        eng.drain()
        got = [h.result() for h in hs]
    for i, r in enumerate(got):
        if (r.device != str(dev) or r.status != "converged"
                or not np.array_equal(r.dist[0], want.dist[i])):
            fail(f"cards: drained query {sources[i]} on {dev}: device "
                 f"{r.device}, status {r.status}, or distances differ from "
                 f"cuda:0's solve")
    say(f"cards sssp: engine_for, submit x4 and drain on {dev}: each "
        f"query's distances == cuda:0's, QueryResult.device {got[0].device}")
    del eng, hs, got
    # the runner with --device cuda:k, in this process
    from repro_torch.launch import sssp_run
    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["sssp_run", *RUNNER_ARGS, "--device", str(dev)]
    t0 = time.perf_counter()
    try:
        with nothing_on_card0(torch, f"sssp_run --device {dev}"), \
                contextlib.redirect_stdout(buf):
            sssp_run.main()
    except SystemExit as e:
        if e.code:
            fail(f"cards: sssp_run --device {dev} exited {e.code}:\n"
                 f"{buf.getvalue()}")
    finally:
        sys.argv = argv
    lines = buf.getvalue().splitlines()
    if not any("validation" in x and "OK" in x for x in lines):
        fail(f"cards: sssp_run --device {dev} did not validate:\n"
             f"{buf.getvalue()}")
    say(f"cards sssp: python -m repro_torch.launch.sssp_run "
        f"{' '.join(RUNNER_ARGS)} --device {dev} (in this process): "
        f"validated, {len(lines)} lines, {time.perf_counter() - t0:.1f} s; "
        f"{next(x for x in lines if 'validation' in x)}")


def cards_models(torch, np, n: int):
    """gemma-7b at full width, depth 2, bf16: examples/serve_decode.py's
    generate (the prefill of 4 x 2048 and 4 decode steps) on cuda:3 (or
    the last card) against cuda:0 on the same weights: tokens equal, the
    prefill's logits within 2 bf16 ulps, kernel 12's bf16 route launched
    once a layer; AutoInt's serve step at batch 512 on cuda:1 bit-equal
    to cuda:0's; the training launcher with --device cuda:1 against
    cuda:0. Nothing of the named card's work allocates on card 0."""
    from repro_torch.configs.registry import REC_SHAPES, _load
    from repro_torch.data import RecsysBatcher
    from repro_torch.examples.serve_decode import generate
    from repro_torch.kernels import build
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import autoint as ai
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import materialize
    dev0 = torch.device("cuda", 0)
    # ---- gemma-7b, depth 2 -------------------------------------------------
    devg = torch.device("cuda", min(3, n - 1))
    cfg = dataclasses.replace(_load(SERVE["arch"])[1], attn_impl="pallas",
                              n_layers=2)
    B, P = SERVE["batch"], SERVE["prompt"]
    gen = torch.Generator(device=dev0)
    gen.manual_seed(SERVE["seed"])
    params0 = materialize(tf.param_defs(cfg, one_ax()), gen, device=dev0,
                          default_dtype=cfg.dtype)
    prompts0 = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                             device=dev0, dtype=torch.int32)
    prefill = tf.make_prefill_step(cfg, one_ax())
    paramsg, promptsg = _to(params0, devg), prompts0.to(devg)
    walls = {}
    for dev, params, prompts in ((dev0, params0, prompts0),
                                 (devg, paramsg, promptsg)):
        ctx = (nothing_on_card0(torch, f"gemma-7b generate on {dev}")
               if dev != dev0 else contextlib.nullcontext())
        with ctx:
            generate(params, prompts[:, :128], cfg, one_ax(), 2)  # warm-up
            build.reset_launches()
            cards_sync(torch)
            t0 = time.perf_counter()
            toks = generate(params, prompts, cfg, one_ax(), 5)
            cards_sync(torch)
            wall = time.perf_counter() - t0
            launched = dict(build.LAUNCHES)
            logits = prefill(params, {"tokens": prompts})[0]
            walls[str(dev)] = (toks.cpu(), logits.float().cpu(), wall,
                               launched, toks.device)
            del toks, logits        # card 0's go before cuda:k's block
    (t0_, l0, w0, _, _), (tg_, lg, wg, lnch, tdev) = walls.values()
    if tdev != devg or not torch.equal(t0_, tg_):
        fail(f"cards: gemma-7b tokens on {tdev} differ from cuda:0's")
    ulps = bf16_ulps(torch, lg, l0)
    if not ulps <= FLASH_BF16_ULPS:
        fail(f"cards: gemma-7b prefill logits on {devg} {ulps} bf16 ulps "
             f"from cuda:0's")
    if (lnch["flash_attention_tc"] != cfg.n_layers
            or sum(lnch.values()) != cfg.n_layers):
        fail(f"cards: gemma-7b on {devg}: launches {lnch}, want "
             f"flash_attention_tc {cfg.n_layers}")
    say(f"cards models: gemma-7b full width, {cfg.n_layers} layers, bf16, "
        f"generate {B} x {P} + 4 decode steps on {devg}: tokens == cuda:0's "
        f"{tuple(tg_.shape)}, prefill logits within {ulps:.3g} bf16 ulps "
        f"(max abs diff {float((lg - l0).abs().max()):.3g}), "
        f"flash_attention_tc launched {lnch['flash_attention_tc']}x; wall "
        f"{wg:.4f} s vs {w0:.4f} s on cuda:0")
    del params0, paramsg, prompts0, promptsg, walls
    torch.cuda.empty_cache()
    # ---- AutoInt's serve step at batch 512 ---------------------------------
    deva = torch.device("cuda", min(1, n - 1))
    cfg_a = _load("autoint")[1]
    gen = torch.Generator(device=dev0)
    gen.manual_seed(RECSYS["seed"])
    pa0 = materialize(ai.autoint_param_defs(cfg_a, one_ax()), gen,
                      device=dev0)
    B = REC_SHAPES["serve_p99"]["batch"]
    idx0 = next(RecsysBatcher(B, cfg_a.n_sparse, cfg_a.vocab_per_field,
                              cfg_a.multi_hot, seed=RECSYS["seed"] + 1,
                              device=dev0))["sparse_idx"]
    serve = ai.make_autoint_serve_step(cfg_a, one_ax())
    pa, idxa = _to(pa0, deva), idx0.to(deva)
    want = serve(pa0, {"sparse_idx": idx0}).cpu()
    with nothing_on_card0(torch, f"autoint serve on {deva}"):
        build.reset_launches()
        got = serve(pa, {"sparse_idx": idxa})
        launched = sum(build.LAUNCHES.values())
    if got.device != deva or not torch.equal(got.cpu(), want):
        fail(f"cards: autoint serve on {got.device} differs from cuda:0's")
    say(f"cards models: autoint full width (table {tuple(pa['table'].shape)}"
        f"), serve step at batch {B} on {deva}: scores == cuda:0's bit for "
        f"bit; {launched} kernel launches (AutoInt takes its bags with a "
        f"row take and a masked sum, as the reference's model does; kernel "
        f"13 runs on {torch.device('cuda', n - 1)} in the kernels job)")
    del pa0, pa, idx0, idxa
    torch.cuda.empty_cache()
    # ---- the training launcher with --device --------------------------------
    losses = {}
    for dev in (dev0, deva):
        ctx = (nothing_on_card0(torch, f"launch.train --device {dev}")
               if dev != dev0 else contextlib.nullcontext())
        with ctx, contextlib.redirect_stdout(io.StringIO()):
            losses[str(dev)] = train_main([*CARDS_TRAIN_ARGS, "--device",
                                           str(dev)])
    l0, la = losses.values()
    rel = max(abs(a - b) / abs(b) for a, b in zip(la, l0))
    if len(la) != len(l0) or not rel <= LAUNCH_REL:
        fail(f"cards: launch.train on {deva}: losses {la} vs {l0} on "
             f"cuda:0")
    say(f"cards models: python -m repro_torch.launch.train "
        f"{' '.join(CARDS_TRAIN_ARGS)} --device {deva} (in this process): "
        f"losses within {rel:.3g} relative of cuda:0's "
        f"({', '.join(f'{x:.6f}' for x in la)})")


def cards_threads(torch, np, shards, cfg, g6, cases, n: int):
    """One scale-1e6 dense all-kernel engine a card, each with its own
    K = 16 batch, solved at once from one host thread a card (each
    thread's current card 0), then kernels 10 and 11 at the single
    layout's state on the thread's card: every result equal to the same
    work done serially; a second round with the batches rotated between
    the engines."""
    import threading
    from repro_torch.core import SsspEngine
    devs = [torch.device("cuda", i) for i in range(n)]
    engs = [SsspEngine.build(shards["dense"], cfg, device=d) for d in devs]
    rng = np.random.default_rng(34)
    batches = [live_sources(np, rng, g6, CARDS_K) for _ in devs]
    sweeps = [c for c in cases if c[1] in ("relax_masked", "relax_sweep")
              and c[6]]
    ops = [[(c[2], cards_moved(c[4], d), c[5],
             {k: cards_moved(v, d) for k, v in c[6].items()})
            for c in sweeps] for d in devs]

    def work(i, batch):
        res = engs[i].solve(batch)
        outs = [fn(*a, **kw, **kk) for fn, a, kw, kk in ops[i]]
        torch.cuda.synchronize(devs[i])
        return res, [tuple(t.cpu() for t in (o if isinstance(o, tuple)
                                               else (o,))) for o in outs]

    for rnd in range(2):
        pairs = [(i, (i + rnd) % n) for i in range(n)]
        t0 = time.perf_counter()
        serial = {i: work(i, batches[b]) for i, b in pairs}
        t_serial = time.perf_counter() - t0
        got, errors, cur = {}, {}, {}

        def run(i, b):
            try:
                cur[i] = [torch.cuda.current_device()]
                got[i] = work(i, batches[b])
                cur[i].append(torch.cuda.current_device())
            except Exception as e:          # noqa: BLE001  (fails below)
                errors[i] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=run, args=p) for p in pairs]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        t_threads = time.perf_counter() - t0
        if errors:
            fail(f"cards threads: {errors}")
        for i, b in pairs:
            same_results(got[i][0], serial[i][0],
                         f"cards threads: engine on {devs[i]}, batch {b}")
            for (lbl, *_), g, w in zip(sweeps, got[i][1], serial[i][1]):
                if not all(torch.equal(x, y) for x, y in zip(g, w)):
                    fail(f"cards threads: {lbl} on {devs[i]} differs from "
                         f"its serial launch")
            if cur[i] != [0, 0] or got[i][0].device != str(devs[i]):
                fail(f"cards threads: thread {i}: current card {cur[i]}, "
                     f"result on {got[i][0].device}")
        say(f"cards threads: round {rnd + 1}, {n} threads (current card 0 "
            f"in each), engine i on cuda:i solving batch "
            f"{[b for _, b in pairs]} and kernels 10 and 11 there: each "
            f"== its serial run bit for bit; wall {t_threads:.3f} s at once "
            f"vs {t_serial:.3f} s serially")
    del engs, ops


def cards_phase(torch, np, card: str):
    """Every kernel and entry point on a card that is not current (module
    docstring: cards); with one card it says so and returns."""
    from repro_torch.core import (SsspConfig, SsspEngine, build_shards,
                                  build_shards_stream)
    from repro_torch.graph import preset_edge_stream, preset_graph
    n = torch.cuda.device_count()
    if n < 2:
        say(f"cards: not run: {n} CUDA device on this machine; the part "
            f"places work on a card other than the current one")
        return
    t_part = time.perf_counter()
    last = torch.device("cuda", n - 1)
    t0 = time.perf_counter()
    g6 = preset_graph("scale-1e6")
    n7, stream7 = preset_edge_stream("scale-1e7")
    chunks7 = list(stream7)
    shards = {"dense": build_shards(g6, 8, enumerate_triangles=False),
              "ragged": build_shards_stream(chunks7, n7, 8)}
    rng = np.random.default_rng(0)
    sources = live_sources(np, rng, g6, CARDS_K)
    src7 = live_of_chunks(np, chunks7, n7, rng, CARDS_K)
    del chunks7
    cfg, cfg_f = SsspConfig(**ALL_KERNELS), SsspConfig(round="fused")
    engines = {f"{key}{tag}": SsspEngine.build(sh, c, device="cuda:0")
               for key, sh in shards.items()
               for tag, c in (("", cfg), (" fused", cfg_f))}
    say(f"cards: {n} cards ({card} each); the current card "
        f"{torch.cuda.current_device()} throughout; scale-1e6 dense and "
        f"scale-1e7 ragged shards (P=8) built in "
        f"{time.perf_counter() - t0:.1f} s, K={CARDS_K}")
    cases = cards_kernel_cases(torch, np, engines, sources, src7, g6)
    cards_kernels(torch, cases, last)
    cards_guard_cost(torch, cases, last)
    cards_sssp(torch, np, shards, engines, sources, src7, n)
    cards_models(torch, np, n)
    cards_threads(torch, np, shards, cfg, g6, cases, n)
    cards_mixed(torch, cases, last)
    if torch.cuda.current_device() != 0:
        fail(f"cards: the current card is {torch.cuda.current_device()}")
    say(f"cards: every job passed with card 0 current throughout, "
        f"{time.perf_counter() - t_part:.1f} s")
    del cases, engines
    gc.collect()
    torch.cuda.empty_cache()


def main():
    if sys.argv[1:] not in ([], ["mesh"], ["cards"]):
        fail("usage: chip_smoke.py [mesh | cards]")
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
    laps = [("start", t_start)]

    def lap(name: str):
        laps.append((name, time.perf_counter()))

    def walls():
        say("walls by part: " + ", ".join(
            f"{n} {t - laps[k][1]:.1f} s"
            for k, (n, t) in enumerate(laps[1:])))
        say(f"total: {time.perf_counter() - t_start:.1f} s after the card "
            f"query")

    # ---- build ---------------------------------------------------------
    build_s, logs = build.build()
    say(f"build: {build_s:.1f} s for {', '.join(build.KERNELS)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    if sys.argv[1:] == ["mesh"]:      # the mesh phases alone
        lap("build")
        dist_nccl_phase(torch, np, card, out_dir)
        lap("dist nccl")
        cards_phase(torch, np, card)
        lap("cards")
        mesh_phase(torch, np, card)
        lap("mesh")
        walls()
        say_ok(torch)
        return
    if sys.argv[1:] == ["cards"]:     # the cards part alone
        lap("build")
        cards_phase(torch, np, card)
        lap("cards")
        walls()
        say_ok(torch)
        return
    dry = start_dryrun()
    lap("build")

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
    dist_phase(torch, np, sh, eng.shards, sources, DIST_JOBS_1E6,
               "1e6 dense", False, landmarks=live_sources(
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

    lap("sssp 1e6")
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

    lap("ragged 1e6")
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
    dist_phase(torch, np, sh7, eng7.shards, src7, DIST_JOBS_1E7, "1e7 ragged",
               True, card=card)
    # ---- layout-free shards, the phase hook, the per-shard wrappers -------
    no_layout_phase(torch, eng7.shards, bare7, src7, "1e7 ragged", card)
    phase_fns_phase(torch, eng7, src7, "1e7 ragged", True, card)
    shard_wrappers_phase(torch, eng7, src7, "1e7 ragged", True)
    del eng7, sh7, g7, res, out7, bare7
    torch.cuda.empty_cache()

    lap("sssp 1e7")
    # ---- the runner, as a user starts it ------------------------------------
    runner_phase()

    # ---- the standalone kernel API: kernels 9, 10, 11 and 13 ---------------
    for phase in (lambda: single_phase(torch, np, g, rng, out_dir),
                  lambda: embag_phase(torch, np)):
        new_rows, new_launches = phase()
        rows.update(new_rows)
        launches.update(new_launches)
        torch.cuda.empty_cache()

    lap("runner, kernel API")
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

    lap("LMs")
    # ---- SSSP over NCCL, a rank a card (with two cards or more) ------------
    dist_nccl_phase(torch, np, card, out_dir)
    # ---- every kernel on a card that is not current (two cards or more) ---
    cards_phase(torch, np, card)
    # ---- the LMs under a (data, model) mesh of processes ------------------
    mesh_phase(torch, np, card)
    torch.cuda.empty_cache()

    lap("mesh")
    # ---- AutoInt and the GNN zoo at their published widths ----------------
    recsys_phase(torch, np, card, out_dir)
    torch.cuda.empty_cache()
    gnn_phase(torch, np, card, out_dir)
    torch.cuda.empty_cache()
    train_launch_phase(torch, np)

    lap("recsys, gnn, launcher")
    # ---- the threefry weights and the registry's cells --------------------
    materialize_phase(torch, np, card)
    dryrun_phase(torch, card, dry)
    lap("weights, cells")
    walls()

    table = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
              "replaces": SOURCES[name][1], "launches": launches[name],
              "max_abs_err": r["err"], "ms": r["ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
              "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
             for name, r in rows.items()]
    print(json.dumps({"kernels": table}))
    say_ok(torch)


def say_ok(torch):
    """The last line: the contract's verdict and the card."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
