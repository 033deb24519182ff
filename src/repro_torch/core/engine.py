"""Session-oriented SSSP query engine: build once, stream queries.

Port of the reference's ``core/engine.py``. Two backends:

- ``sim``: all P shards stacked on one device (on one GPU, the production
  path);
- ``shmap``: one process a shard, over ``torch.distributed`` (the paper's
  MPI setting). Every process builds the engine with the same shards (or
  its own ``SsspShards.shard`` view), the same config and a
  ``launch/mesh.py: HostMesh`` with the ``axis_names`` whose ranks number
  the shards, and makes the same calls in the same order: each call is a
  sequence of collectives. Each rank runs the sim's round on its one-shard
  stack through ``ShmapComm``; every rank returns the same
  ``QueryResult``, equal to the sim engine's bit for bit (``dist``
  all-gathered to ``[K, n_vertices]``, the counters all-reduced).

    eng = SsspEngine.build(graph_or_shards, cfg)          # on cuda
    res = eng.solve([3, 17, 1999])                        # QueryResult
    h = eng.submit(42); eng.submit([7, 9])
    eng.drain()                                           # bucketed batches
    h.result().dist

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no CUDA device and no ``device`` argument, ``build`` raises rather
than fall back to the CPU. A batch is padded to the next power-of-two
bucket: padded rows start with no frontier and ``done=True``, so results
are bit-identical to the unpadded solve. The host syncs once per round
(the termination check), as the reference's sim loop does; under shmap
the check reads a flag the detector's collectives agreed, so every rank
leaves the loop on the same round.

Bucket reuse without tracing
----------------------------

The reference counts jit traces: one compiled round per bucket shape, and
on the landmark-warm path one seed program per ``(bucket, L)``. The port
runs eagerly, so a "trace" here is the first run of a shape on this
engine: the first round at bucket ``kb`` (and the first certificate, in
``cert_traces``), and on the warm path the first seed at ``(kb, L)``; each
adds one to ``trace_counts[kb]``. ``compile_s`` is the synchronized wall
of those first runs: the first use's kernel build and module load and the
allocator's growth. It is 0.0 on every later call, and ``compiled`` says
``trace_counts`` grew. Under shmap, as in the reference, the first solve
of a bucket (or of a (bucket, L) on the warm path) is the trace, and
``compile_s`` is that whole solve's wall. The reference's reuse contract
thus holds in the same form: one "trace" per bucket serves any source
set.

Streaming arrivals
------------------

``submit`` enqueues a query (or query batch) and returns a
``QueryHandle``; ``drain`` coalesces everything pending into batches of
at most ``max_bucket`` queries (a handle is never split) and solves them.
``handle.result()`` drains on demand.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import phases
from repro_torch.core.shards import (SsspShards, build_shards,
                                     shard_distance_rows)
from repro_torch.core.sssp import (ShmapComm, SsspConfig, SsspStats,
                                   _as_sources, _Carry,
                                   build_shmap_certificate,
                                   build_shmap_solver_traced,
                                   certificate_improved_sim,
                                   dispatches_per_round, init_carry,
                                   make_finalize, make_round)
from repro_torch.core.warmstart import CachedRow, LandmarkCache, ResultCache
from repro_torch.device import resolve_device


def bucket_k(k: int) -> int:
    """Bucket policy: the next power of two >= k."""
    if k < 1:
        raise ValueError("at least one source is required")
    return 1 << (k - 1).bit_length()


def _total(counts: torch.Tensor) -> np.int32:
    """A counter's total over shards (and queries), summed in int32 so that
    it wraps past 2**31 - 1 as the reference's ``np.sum(..., dtype=np.int32)``
    does."""
    return np.int32(int(counts.sum(dtype=torch.int32)))


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """Result of one solved (sub)batch. ``dist``/``q_rounds``/
    ``q_relaxations`` cover the real queries (padded rows sliced away).
    ``compile_s`` is the first run's cost of this bucket (module docstring)
    and 0.0 on later calls; ``bucket_k`` is 0 when the result cache served
    every query.

    ``status``: ``"converged"`` (every query passed the fixpoint
    certificate), ``"max_rounds"`` (the round budget ran out first) or
    ``"degraded"`` (a detector fired but the certificate found an
    improvement). Only certified rows enter the result cache or the
    landmark cache."""

    dist: np.ndarray            # [K, n_vertices]
    sources: tuple
    stats: SsspStats
    bucket_k: int
    backend: str
    wall_s: float
    compile_s: float            # first-run cost of this bucket (0.0 after)
    compiled: bool              # True iff this call grew trace_counts
    cache_hits: int = 0         # queries answered from the result cache
    warm_started: bool = False  # landmark-seeded (vs cold +inf) start
    status: str = "converged"
    device: str = "cpu"

    @property
    def q_rounds(self) -> np.ndarray:
        return np.asarray(self.stats.q_rounds)

    @property
    def q_relaxations(self) -> np.ndarray:
        return np.asarray(self.stats.q_relaxations)

    @property
    def q_converged(self) -> np.ndarray:
        return np.asarray(self.stats.q_converged)

    @property
    def overlap_fraction(self) -> float:
        """Share of rounds whose exchange overlapped local work: 0.0 for
        a synchronous exchange and for results the cache served with no
        round."""
        if self.stats.overlap_rounds is None:
            return 0.0
        rounds = int(self.stats.rounds)
        return float(int(self.stats.overlap_rounds)) / rounds if rounds else 0.0


class QueryHandle:
    """A submitted, possibly unsolved query batch; ``result()`` drains the
    owning engine on demand."""

    __slots__ = ("sources", "_engine", "_result")

    def __init__(self, engine: "SsspEngine", sources: tuple):
        self.sources = sources
        self._engine = engine
        self._result: QueryResult | None = None

    @property
    def done(self) -> bool:
        return self._result is not None

    def result(self) -> QueryResult:
        if self._result is None:
            self._engine.drain()
        return self._result

    def __repr__(self):
        state = "done" if self.done else "pending"
        return f"QueryHandle(sources={self.sources}, {state})"


class SsspEngine:
    """One per-graph session: owns the shards (on its device; under shmap
    this rank's shard), the resolved round and, for the fused round, the
    exit-time merge of the last delivered batch; the result and landmark
    caches; and the queue of submitted queries."""

    def __init__(self, shards: SsspShards, cfg: SsspConfig,
                 backend: str = "sim", mesh=None, axis_names=None,
                 max_bucket: int = 16, result_cache: int = 0,
                 certify: bool = True, *, device=None):
        if backend not in ("sim", "shmap"):
            raise ValueError(f"unknown backend {backend!r}; valid: "
                             "['shmap', 'sim']")
        if backend == "shmap" and (mesh is None or axis_names is None):
            raise ValueError("backend='shmap' requires mesh and axis_names")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.axis_names = tuple(axis_names) if axis_names else None
        self.comm = None
        if backend == "shmap":
            ag = mesh.axis_group(self.axis_names)
            if ag.size != shards.n_parts:
                raise ValueError(
                    f"the shards have n_parts={shards.n_parts}; the mesh "
                    f"axes {self.axis_names} span {ag.size} processes")
            if shards.shard_id is None:
                shards = shards.shard(ag.rank)
            elif shards.shard_id != ag.rank:
                raise ValueError(f"rank {ag.rank} was given the view of "
                                 f"shard {shards.shard_id}")
            self.comm = ShmapComm(ag, self.device)
        elif shards.shard_id is not None:
            raise ValueError("backend='sim' needs the full shard stack, not "
                             "a one-shard view")
        self.shards = shards.to(self.device)
        self.cfg = cfg
        self.backend = backend
        self.max_bucket = int(max_bucket)
        self._pending: list[QueryHandle] = []
        self.batches_served = 0
        self.queries_served = 0
        # the result LRU serves exact repeats with no round; the landmark
        # cache seeds every other query when cfg.warm_start="landmark".
        # graph_epoch keys both: invalidate_caches orphans them.
        self.graph_epoch = 0
        self.result_cache = ResultCache(result_cache)
        self.landmarks: LandmarkCache | None = None
        self._warm_stage = phases.resolve("warm_init", cfg.warm_start)
        # first runs (the module docstring's "traces"): rounds by bucket,
        # seeds by (bucket, L), certificates by bucket. _warm_traced is
        # the warm path's coverage for warmup(), dropped with the caches.
        self.trace_counts: dict[int, int] = {}
        self._round_runs: set[int] = set()
        self._seed_runs: set[tuple[int, int]] = set()
        self._cert_runs: set[int] = set()
        self._warm_traced: set[tuple[int, int]] = set()
        self.certify = bool(certify)
        self.cert_traces = 0
        if backend == "sim":
            self.round_fn = make_round(self.shards, cfg)
            self._finalize = make_finalize(self.shards, cfg)
            self.shmap_solver = None
        else:
            self.round_fn = self._finalize = None
            self.shmap_solver = build_shmap_solver_traced(
                self.shards, cfg, self.comm, on_trace=self._note_trace)
            self._warm_solver = None      # built on the first warm solve
            self._cert_shmap = build_shmap_certificate(
                self.shards, self.comm, on_trace=self._note_cert)

    @classmethod
    def build(cls, graph_or_shards, cfg: SsspConfig | None = None,
              backend: str = "sim", mesh=None, axis_names=None, *,
              n_parts: int = 8, device=None, max_bucket: int = 16,
              result_cache: int = 0, certify: bool = True,
              **shard_kwargs) -> "SsspEngine":
        """A session over ``SsspShards`` (used as-is) or a ``Graph``
        (partitioned here with ``n_parts`` and any ``build_shards``
        keyword). ``result_cache`` sizes the exact-repeat LRU (0, the
        default, disables it). ``backend="shmap"`` takes the ``mesh``
        (``launch/mesh.py: make_host_mesh``) and the ``axis_names`` whose
        processes hold the shards, one each."""
        dev = resolve_device(device)      # fail before any host work without CUDA
        if isinstance(graph_or_shards, SsspShards):
            if shard_kwargs:
                raise ValueError("shard build options only apply when "
                                 "building from a Graph")
            sh = graph_or_shards
        else:
            sh = build_shards(graph_or_shards, n_parts, **shard_kwargs)
        return cls(sh, cfg or SsspConfig(), backend, mesh, axis_names,
                   device=dev, max_bucket=max_bucket,
                   result_cache=result_cache, certify=certify)

    @property
    def n_vertices(self) -> int:
        return self.shards.n_vertices

    @property
    def n_parts(self) -> int:
        return self.shards.n_parts

    @property
    def trace_count(self) -> int:
        """First runs across every bucket of this engine."""
        return sum(self.trace_counts.values())

    def _note_trace(self, kb: int) -> None:
        self.trace_counts[kb] = self.trace_counts.get(kb, 0) + 1

    def _note_cert(self, kb: int) -> None:
        self.cert_traces += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------------------------------------------------- solve ----

    def _warm_active(self) -> bool:
        """True when solves seed from the landmark cache: the config opted
        in and a cache of the current graph epoch exists."""
        return (self._warm_stage.needs_landmarks
                and self.landmarks is not None
                and self.landmarks.epoch == self.graph_epoch)

    @staticmethod
    def _padded(srcs: tuple, bucket: bool):
        """(sources [kb] int32, q_valid [kb] bool) of a batch padded to its
        bucket (``bucket=False``: K exactly)."""
        k = len(srcs)
        kb = bucket_k(k) if bucket else k
        src_arr = np.zeros((kb,), np.int32)
        src_arr[:k] = srcs
        return src_arr, np.arange(kb) < k

    def start(self, sources, *, bucket: bool = True) -> _Carry:
        """The initial cold carry of a (padded) source batch."""
        srcs = _as_sources(sources, self.n_vertices)
        if not srcs:
            raise ValueError("at least one source is required")
        src_arr, q_valid = self._padded(srcs, bucket)
        return init_carry(self.shards, src_arr, self.cfg, q_valid=q_valid)

    def solve(self, sources, *, bucket: bool = True) -> QueryResult:
        """Solve a source batch (int or sequence), padded to its bucket
        (``bucket=False`` keeps K exact: the same results, another shape).

        With a result cache, exact repeats of a source in the current graph
        epoch are answered from the LRU with no round, and cached sources
        (and in-batch duplicates) are stripped BEFORE padding, so a partly
        cached batch rides a smaller bucket. Cached rows report
        ``q_rounds == 0``."""
        srcs = _as_sources(sources, self.n_vertices)
        if len(srcs) < 1:
            raise ValueError("at least one source is required")
        if self.result_cache.maxsize == 0:
            return self._solve_batch(srcs, bucket=bucket)
        return self._solve_cached(srcs, bucket=bucket)

    def _solve_batch(self, srcs: tuple, *, bucket: bool = True,
                     use_warm: bool = True) -> QueryResult:
        """Run the round loop for ``srcs`` (no result-cache layer).
        ``use_warm=False`` forces the cold +inf start, as the landmark
        pivots themselves are solved."""
        k = len(srcs)
        src_arr, q_valid = self._padded(srcs, bucket)
        kb = len(src_arr)
        warm = use_warm and self._warm_active()

        traces0 = self.trace_count
        t0 = time.perf_counter()
        if self.backend == "shmap":
            return self._solve_shmap(srcs, src_arr, q_valid, warm, traces0,
                                     t0)
        compile_s = 0.0
        seed = None
        if warm:
            key = (kb, self.landmarks.n_landmarks)
            tc = time.perf_counter()
            seed = self._warm_stage.seed_stacked(
                self.landmarks.dist,
                torch.as_tensor(src_arr, device=self.device),
                torch.as_tensor(q_valid, device=self.device))
            if key not in self._seed_runs:
                self._sync()
                compile_s += time.perf_counter() - tc
                self._seed_runs.add(key)
                self._note_trace(kb)
            # the warm path's coverage (warmup() reads it): a cold first
            # run of this bucket does not cover the seed
            self._warm_traced.add(key)
        carry = init_carry(self.shards, src_arr, self.cfg, q_valid=q_valid,
                           seed_dist=seed)
        while carry.rounds < self.cfg.max_rounds:
            first = kb not in self._round_runs
            tc = time.perf_counter()
            carry = self.round_fn(carry)
            if first:
                self._sync()
                compile_s += time.perf_counter() - tc
                self._round_runs.add(kb)
                self._note_trace(kb)
            if bool(carry.done.all()):          # one host sync per round
                break
        done_k = carry.done[0, :k].cpu().numpy()
        dist_pk = (carry.dist if self._finalize is None
                   else self._finalize(carry))
        dist = dist_pk.transpose(0, 1).reshape(kb, -1)[:k, :self.n_vertices]
        stats = SsspStats(
            rounds=np.int32(carry.rounds),
            relaxations=_total(carry.relaxations),
            msgs_sent=_total(carry.msgs_sent),
            msgs_recv=_total(carry.msgs_recv),
            pruned_edges=_total(carry.pruned),
            q_rounds=carry.q_rounds.amax(0)[:k].cpu().numpy(),
            q_relaxations=carry.relaxations.sum(0, dtype=torch.int32)[:k]
            .cpu().numpy(),
            stale_merges=_total(carry.stale), resends=_total(carry.resent),
            n_dispatches=np.int32(
                carry.rounds * dispatches_per_round(self.shards, self.cfg)),
            overlap_rounds=np.int32(int(carry.overlap)),
            bytes_moved=np.int32(int(carry.comm_bytes)))
        # the detector's word (done_k) is a claim; one extra unmasked relax
        # round is the proof, and overrides it in both directions
        if self.certify:
            if kb not in self._cert_runs:
                self._cert_runs.add(kb)
                self.cert_traces += 1
            q_conv = ~certificate_improved_sim(self.shards,
                                               dist_pk)[:k].cpu().numpy()
        else:
            q_conv = done_k.copy()
        return self._result(srcs, dist, stats, q_conv, done_k, kb, traces0,
                            t0, compile_s, warm)

    def _result(self, srcs, dist, stats, q_conv, done_k, kb, traces0, t0,
                compile_s, warm) -> QueryResult:
        """The batch's ``QueryResult``: status from the certificate's
        verdict ``q_conv`` against the detector's ``done_k``."""
        if q_conv.all():
            status = "converged"
        elif (~q_conv & ~done_k).any():
            status = "max_rounds"
        else:
            status = "degraded"
        dist = dist.cpu().numpy()
        compiled = self.trace_count > traces0
        self.batches_served += 1
        self.queries_served += len(srcs)
        return QueryResult(dist=dist, sources=srcs,
                           stats=stats._replace(q_converged=q_conv),
                           bucket_k=kb, backend=self.backend,
                           wall_s=time.perf_counter() - t0,
                           compile_s=compile_s, compiled=compiled,
                           warm_started=warm, device=str(self.device),
                           status=status)

    def _solve_shmap(self, srcs, src_arr, q_valid, warm, traces0, t0):
        """``_solve_batch`` on a rank of the shmap backend: the rank's
        solve, then ``dist`` all-gathered and the certificate (one pmin,
        one or-reduce); every rank returns the same result."""
        k, kb = len(srcs), len(src_arr)
        if warm:
            if self._warm_solver is None:
                self._warm_solver = build_shmap_solver_traced(
                    self.shards, self.cfg, self.comm,
                    on_trace=self._note_trace, warm=True)
            dist_loc, stats = self._warm_solver(src_arr, q_valid,
                                                self.landmarks.dist)
            self._warm_traced.add((kb, self.landmarks.n_landmarks))
        else:
            dist_loc, stats = self.shmap_solver(src_arr, q_valid)
        self._sync()
        compile_s = (time.perf_counter() - t0 if self.trace_count > traces0
                     else 0.0)
        done_k = stats.q_converged[:k]
        dist_pk = self.comm.all_gather(dist_loc)
        dist = dist_pk.transpose(0, 1).reshape(kb, -1)[:k, :self.n_vertices]
        stats = stats._replace(q_rounds=stats.q_rounds[:k],
                               q_relaxations=stats.q_relaxations[:k])
        if self.certify:
            q_conv = ~self._cert_shmap(dist_loc)[:k].cpu().numpy()
        else:
            q_conv = done_k.copy()
        return self._result(srcs, dist, stats, q_conv, done_k, kb, traces0,
                            t0, compile_s, warm)

    def _solve_cached(self, srcs: tuple, *, bucket: bool) -> QueryResult:
        """Result-cache layer over ``_solve_batch``: strip the sources the
        LRU can answer (and in-batch duplicates) before bucket padding,
        solve the rest, and reassemble the rows in submitted order."""
        t0 = time.perf_counter()
        epoch = self.graph_epoch
        hits: dict[int, CachedRow] = {}
        uncached: list[int] = []
        for s in dict.fromkeys(srcs):
            row = self.result_cache.get(s, epoch)
            if row is None:
                uncached.append(s)
            else:
                hits[s] = row
        raw = None
        if uncached:
            raw = self._solve_batch(tuple(uncached), bucket=bucket)
            for i, s in enumerate(uncached):
                # only certified rows enter the LRU: a degraded or
                # max_rounds row is an upper bound, which the cache would
                # pass off as exact in later batches
                if not bool(raw.stats.q_converged[i]):
                    continue
                # a copy, so no cached row pins the whole batch array
                self.result_cache.put(s, epoch,
                                      CachedRow(dist=raw.dist[i].copy()))
        raw_col = {s: i for i, s in enumerate(uncached)}

        k = len(srcs)
        dist = np.empty((k, self.n_vertices), np.float32)
        q_rounds = np.zeros((k,), np.int32)
        q_relax = np.zeros((k,), np.int32)
        q_conv = np.ones((k,), bool)    # LRU rows were certified on entry
        n_hit = 0
        for j, s in enumerate(srcs):
            if s in hits:
                dist[j] = hits[s].dist
                n_hit += 1
            else:
                i = raw_col[s]
                dist[j] = raw.dist[i]
                q_rounds[j] = raw.q_rounds[i]
                q_relax[j] = raw.q_relaxations[i]
                q_conv[j] = bool(raw.stats.q_converged[i])
        zero = np.int32(0)
        if raw is not None:
            stats = raw.stats._replace(q_rounds=q_rounds,
                                       q_relaxations=q_relax,
                                       q_converged=q_conv)
        else:
            # every source served from the LRU: no round ran
            stats = SsspStats(rounds=zero, relaxations=zero, msgs_sent=zero,
                              msgs_recv=zero, pruned_edges=zero,
                              q_rounds=q_rounds, q_relaxations=q_relax,
                              q_converged=q_conv, stale_merges=zero,
                              resends=zero, n_dispatches=zero,
                              overlap_rounds=zero, bytes_moved=zero)
            self.batches_served += 1
        # _solve_batch already counted the uncached part it ran
        self.queries_served += k - len(uncached)
        return QueryResult(
            dist=dist, sources=srcs, stats=stats,
            bucket_k=raw.bucket_k if raw is not None else 0,
            backend=self.backend, wall_s=time.perf_counter() - t0,
            compile_s=raw.compile_s if raw is not None else 0.0,
            compiled=raw.compiled if raw is not None else False,
            cache_hits=n_hit,
            warm_started=raw.warm_started if raw is not None else False,
            device=str(self.device),
            status=raw.status if raw is not None else "converged")

    # ------------------------------------------------------ warm start ----

    def precompute_landmarks(self, l_sources) -> LandmarkCache:
        """Solve the L pivot sources once (cold) and keep their distances
        on the device as ``[P, L, block]``, 4 B x L x block a shard. With
        ``cfg.warm_start="landmark"`` every later solve starts from
        ``min_l(land[l, src] + land[l, v])`` instead of +inf and reaches
        the cold fixpoint bit for bit, a repeated pivot in one round. The
        pivot rows also enter the result cache.

        Needs symmetric distances (the bound uses ``d(l, src)`` where the
        triangle inequality needs ``d(src, l)``): the pivots' L x L
        cross-distances are checked, and an asymmetry raises rather than
        seed a bound that is too low. A necessary check, not a sufficient
        one."""
        srcs = _as_sources(l_sources, self.n_vertices)
        if len(srcs) < 1:
            raise ValueError("at least one landmark source is required")
        res = self._solve_batch(tuple(dict.fromkeys(srcs)), use_warm=False)
        # landmark rows seed every later solve: only certified fixpoints,
        # and never NaN (one NaN seed poisons everything downstream)
        if res.status != "converged":
            raise ValueError(
                f"landmark precompute did not converge (status="
                f"{res.status!r}): refusing to cache non-fixpoint seeds; "
                "raise max_rounds or fix the termination config")
        if np.isnan(res.dist).any():
            raise ValueError(
                "landmark precompute produced NaN distances: the seed rows "
                "are not finite upper bounds (check edge weights)")
        cross = res.dist[:, list(res.sources)]      # [L, L] pivot pairs
        if not np.allclose(cross, cross.T, rtol=1e-4, atol=1e-4):
            raise ValueError(
                "landmark warm start requires symmetric distances, but the "
                "pivot cross-distances are asymmetric (directed graph?): "
                "the triangle-inequality seed would not be an upper bound")
        land = shard_distance_rows(res.dist, self.n_parts, self.shards.block)
        if self.backend == "shmap":
            land = land[self.comm.r:self.comm.r + 1]      # this rank's row
        land = land.to(self.device)
        self.landmarks = LandmarkCache(sources=res.sources, dist=land,
                                       epoch=self.graph_epoch)
        for i, s in enumerate(res.sources):
            self.result_cache.put(s, self.graph_epoch,
                                  CachedRow(dist=res.dist[i].copy()))
        return self.landmarks

    def invalidate_caches(self) -> int:
        """Graph-epoch bump: orphans every result-cache row and drops the
        landmark cache. Call after changing the graph. Returns the new
        epoch."""
        self.graph_epoch += 1
        self.result_cache.clear()
        self.landmarks = None
        self._warm_traced.clear()
        return self.graph_epoch

    def warmup(self, k: int = 1) -> float:
        """Run the bucket serving batches of size ``k`` once ahead of
        traffic; returns its first-run seconds (0.0 if already warm).
        Bypasses the result cache, so repeated probe sources keep the full
        bucket. On a landmark-warm engine it covers the warm path, which a
        cold first run of the same bucket (e.g. from
        ``precompute_landmarks``) does not."""
        kb = bucket_k(k)
        if self._warm_active():
            already = (kb, self.landmarks.n_landmarks) in self._warm_traced
        else:
            already = self.trace_counts.get(kb, 0) > 0
        if already:
            return 0.0
        return self._solve_batch((0,) * kb, bucket=False).compile_s

    # ------------------------------------------------------- streaming ----

    def submit(self, sources) -> QueryHandle:
        """Enqueue a query (or query batch) for the next ``drain``; sources
        are validated now, so a bad id fails at submission."""
        srcs = _as_sources(sources, self.n_vertices)
        if len(srcs) < 1:
            raise ValueError("at least one source is required")
        h = QueryHandle(self, srcs)
        self._pending.append(h)
        return h

    @property
    def pending(self) -> int:
        return len(self._pending)

    def drain(self) -> list[QueryResult]:
        """Coalesce pending handles into batches and solve them.

        Consecutive handles are packed while the batch stays within
        ``max_bucket``; a handle is never split, so an oversized one rides
        its own larger bucket. Each handle gets a ``QueryResult`` of its
        own rows; the batch's totals and timing are shared. If a solve
        fails, every unsolved handle (the failing batch's included) is
        re-queued before the error propagates."""
        pending, self._pending = self._pending, []
        results: list[QueryResult] = []
        i = 0
        while i < len(pending):
            start = i
            group = [pending[i]]
            total = len(pending[i].sources)
            i += 1
            while (i < len(pending)
                   and total + len(pending[i].sources) <= self.max_bucket):
                group.append(pending[i])
                total += len(pending[i].sources)
                i += 1
            try:
                batch = self.solve([s for h in group for s in h.sources])
            except BaseException:
                self._pending = pending[start:] + self._pending
                raise
            off = 0
            for h in group:
                kk = len(h.sources)
                sl = slice(off, off + kk)
                conv = np.asarray(batch.stats.q_converged)[sl]
                h._result = dataclasses.replace(
                    batch, dist=batch.dist[sl], sources=h.sources,
                    status="converged" if bool(conv.all()) else batch.status,
                    stats=batch.stats._replace(
                        q_rounds=batch.stats.q_rounds[sl],
                        q_relaxations=batch.stats.q_relaxations[sl],
                        q_converged=conv))
                results.append(h._result)
                off += kk
        return results

    def __repr__(self):
        return (f"SsspEngine(backend={self.backend!r}, device="
                f"{str(self.device)!r}, n_vertices={self.n_vertices}, "
                f"n_parts={self.n_parts}, buckets="
                f"{sorted(self.trace_counts)}, pending={self.pending})")


# --------------------------------------------------------------------------
# engine cache behind the legacy wrappers
# --------------------------------------------------------------------------

# One engine per (caller's shards, cfg, backend, device, mesh, axes). The
# engine holds ``shards.to(device)``, a new object, so the entry keeps the
# caller's shards and mesh themselves: strong references, so the id()s in
# a live key are never recycled, and the identity checks that make a hit.
# Bounded.
_ENGINE_CACHE: dict = {}
_ENGINE_CACHE_MAX = 16


def engine_for(sh: SsspShards, cfg: SsspConfig, backend: str = "sim",
               mesh=None, axis_names=None, *, device=None) -> SsspEngine:
    """The cached engine of ``(sh, cfg, backend, device)``, and under
    shmap of ``(mesh, axis_names)`` too, for the legacy wrappers and any
    caller that holds shards and a config rather than a session."""
    dev = resolve_device(device)
    axes = tuple(axis_names) if axis_names else None
    key = (id(sh), cfg, backend, str(dev))
    if mesh is not None:
        key += (id(mesh), axes)
    hit = _ENGINE_CACHE.get(key)
    if hit is not None and hit[0] is sh and hit[2] is mesh:
        return hit[1]
    eng = SsspEngine(sh, cfg, backend, mesh, axes, device=dev)
    if len(_ENGINE_CACHE) >= _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    _ENGINE_CACHE[key] = (sh, eng, mesh)
    return eng
