"""SP-Async round (paper Algorithm 2), batched over a query axis.

Port of the reference's ``core/sssp.py``. The round runs on a stack of
shards: per-shard state is ``[R, K, ...]``. Under the ``sim`` backend all
P shards are stacked on one device (R = P; on one GPU the production
path) and the exchange is a transpose or a min over the shard axis
(``SimComm``). Under the ``shmap`` backend each process of a
``torch.distributed`` job holds one shard (R = 1, ``SsspShards.shard``)
and the same round exchanges through collectives (``ShmapComm``), so both
backends give the same bits. One round:

  1. *Local phase*: every shard with a live frontier in any query runs its
     local solver to a fixpoint; idle shards evaluate a chunk of Trishla
     triangle candidates instead (only they advance their cursor).
  2. *Send phase*: cut-edge candidates are min-reduced per message slot,
     masked against ``last_sent``, and routed into the bucketed
     ``[P, K, P, C]`` payload, or, under a dense exchange, into
     owner-addressed ``[P, K, P, block]`` rows.
  3. *Exchange*: an ``ExchangeStage`` on ``SimComm``. ``bucket`` is a
     transpose of the shard axes; ``pmin`` and ``a2a_dense`` a min over
     the senders. The deferred exchanges (``async``, ``async_bucket``,
     ``async_ppermute``) deliver a round's sends one or more rounds late:
     the round takes the batch carried in ``carry.inflight`` before its
     local solve and pushes its own sends after the send phase.
  4. *Merge phase*: incoming messages scatter-min into ``dist`` (dense
     rows: an elementwise min); improved vertices form the next frontier.
  5. *Termination*: a ToKa stage (``toka0``-``toka3``), per query. Payload
     still in flight counts as activity, so no detector declares
     quiescence over the wire.

``round="fused"`` rotates that chain so the three tiled phases land in one
kernel launch (``kernels/round``): round r merges the messages delivered in
round r-1 (held un-merged in ``carry.incoming``), chases the frontier to
the local fixpoint and packs the sends, then exchanges; receives and the
termination view are accounted at delivery time, so every counter and
detector sees the staged sequence. Two dispatches per round instead of
four.

Phase backends resolve through ``core/phases.py`` from the reference's
config names: ``xla`` is plain PyTorch ops, ``pallas`` the hand-written
CUDA kernel (its plain PyTorch version on CPU tensors). The dense payload
assembly, the dense merge, the token ring and the in-flight buffers are
plain PyTorch, as they are plain ``jnp`` in the reference. Everything a
round carries stays on the device; the engine reads one flag a round.
"""
from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import local_solver, phases, trishla
from repro_torch.core import warmstart  # noqa: F401  (registers warm_init)
from repro_torch.core import toka as toka_mod
from repro_torch.core.shards import SsspShards
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.common import INF, scatter_min_drop, take_fill
from repro_torch.kernels.merge import merge_scatter
from repro_torch.kernels.round.ops import (_fused_round_rescue_stacked,
                                          _fused_round_stacked)
from repro_torch.kernels.send import send_pack, send_payload_bucket


@dataclasses.dataclass(frozen=True)
class SsspConfig:
    """The reference's config fields, values and checks;
    ``pallas_interpret`` is accepted and has no effect."""
    exchange: str = "bucket"        # bucket | pmin | a2a_dense
                                    #   | async | async_bucket | async_ppermute
    toka: str = "toka0"             # toka0 | toka1 | toka2 | toka3
    async_lag: int = 1              # rounds a deferred exchange buffers sends
    local_solver: str = "bellman"   # bellman | delta | pallas
    send_backend: str = "xla"       # xla | pallas
    merge_backend: str = "xla"      # xla | pallas
    round: str = "staged"
    warm_start: str = "none"
    delta: float = 4.0
    local_iters: int = 10_000
    pallas_sweeps: int = 8          # relaxation sweeps per relax launch
    pallas_interpret: bool = True
    prune_online: bool = True       # Trishla in the idle branch
    prune_offline_passes: int = 0   # vectorized Trishla before the solve
    tri_chunk: int = 256
    max_rounds: int = 100_000
    faults: faults_mod.FaultPlan | None = None  # message failure model
    toka3_safety: float = 2.0

    def __post_init__(self):
        phases.validate("exchange", self.exchange)
        phases.validate("toka", self.toka)
        phases.validate("local_solver", self.local_solver)
        phases.validate("send", self.send_backend)
        phases.validate("merge", self.merge_backend)
        phases.validate("round", self.round)
        phases.validate("warm_init", self.warm_start)
        if self.faults is not None and not isinstance(self.faults,
                                                      faults_mod.FaultPlan):
            raise TypeError(f"cfg.faults must be a FaultPlan or None, got "
                            f"{type(self.faults).__name__}")
        if self.toka3_safety <= 0:
            raise ValueError("toka3_safety must be > 0")
        if self.async_lag < 1:
            raise ValueError("async_lag must be >= 1 (1 = double-buffered)")
        if self.async_lag != 1 and self.exchange not in ("async",
                                                         "async_bucket"):
            raise ValueError(
                f"async_lag={self.async_lag} only applies to the buffered "
                f"deferred exchanges ('async'/'async_bucket'); "
                f"exchange={self.exchange!r} ignores it "
                "(async_ppermute's lag is the ring distance)")
        if self.pallas_sweeps < 1:
            raise ValueError("pallas_sweeps must be >= 1")

    @property
    def fault_plan(self) -> faults_mod.FaultPlan | None:
        """The active fault plan: an all-zero plan is None, so the
        fault-free pipeline carries no fault state and draws nothing."""
        if self.faults is not None and self.faults.active:
            return self.faults
        return None


class SsspStats(NamedTuple):
    rounds: Any              # outer rounds until the LAST query converged
    relaxations: Any         # total edge relaxations (TEPS numerator)
    msgs_sent: Any
    msgs_recv: Any
    pruned_edges: Any
    q_rounds: Any = None       # [K] rounds each query was live
    q_relaxations: Any = None  # [K] edge relaxations per query
    q_converged: Any = None    # [K] certified-converged mask
    stale_merges: Any = None   # improving late (deferred) deliveries
    resends: Any = None        # anti-entropy retransmissions
    n_dispatches: Any = None   # data-plane dispatches (rounds x 4 or 2)
    overlap_rounds: Any = None  # rounds overlapping delivery with compute
    bytes_moved: Any = None    # logical payload bytes on the wire


class _Carry(NamedTuple):
    dist: torch.Tensor         # [P, K, block]
    active: torch.Tensor       # [P, K, block] bool frontier
    pruned: torch.Tensor       # [P, e_loc + e_cut] bool (query-invariant)
    tri_cursor: torch.Tensor   # [P] int32
    last_sent: torch.Tensor    # [P, K, S]
    done: torch.Tensor         # [P, K] bool converged-query mask
    rounds: int
    q_rounds: torch.Tensor     # [P, K] int32
    relaxations: torch.Tensor  # [P, K] int32
    msgs_sent: torch.Tensor    # [P, K] int32
    msgs_recv: torch.Tensor    # [P, K] int32
    comm_bytes: torch.Tensor   # scalar int32
    streak: torch.Tensor       # [P, K] int32 globally quiet rounds (toka3)
    stale: torch.Tensor        # [P, K] int32 improving late deliveries
    resent: torch.Tensor       # [P, K] int32 anti-entropy retransmissions
    overlap: torch.Tensor      # scalar int32 rounds of delivery + compute
    toka2: Any = None          # Toka2State of [P, K] fields (toka2 only)
    incoming: torch.Tensor | None = None   # fused: [P, K, P, C] delivered,
                                           # not yet merged ([P, K, block]
                                           # under a dense exchange)
    front_any: torch.Tensor | None = None  # fused: [P, K] a frontier bit
                                           # next round
    inflight: tuple | None = None  # deferred: undelivered payload buffers
    faults: faults_mod.FaultState | None = None  # under an active plan


# --------------------------------------------------------------------------
# phases (stacked over shards)
# --------------------------------------------------------------------------

def _prune_idle(sh: SsspShards, idle, pruned, cursor, cfg):
    """A Trishla chunk on the idle shards ([P] bool) only, the reference's
    ``lax.cond``: only they advance their pruned mask and cursor. Returns
    (pruned, cursor, newly pruned edges [P] int32, 0 on busy shards)."""
    if not cfg.prune_online:
        return pruned, cursor, torch.zeros_like(cursor)
    w_all = torch.cat([sh.loc_w, sh.cut_w], dim=1)
    new_pruned, new_cursor, n = trishla.prune_chunk(
        w_all, pruned, cursor, sh.tri_uj, sh.tri_ui, sh.tri_ij, sh.tri_valid,
        cfg.tri_chunk)
    return (torch.where(idle[:, None], new_pruned, pruned),
            torch.where(idle, new_cursor, cursor),
            torch.where(idle, n, 0).to(torch.int32))


def _phase_local(sh: SsspShards, dist, active, pruned, cursor, cfg):
    """Busy shards (a frontier in any query) solve; idle shards run a
    Trishla chunk instead, the branches of the reference's ``lax.cond``.
    ``local_solver="pallas"`` on shards without the dst-tiled layout runs
    ``bellman`` (a one-time warning, ``local_solver.solve_stacked``).
    Returns (dist, pruned, cursor, relaxations [P, K], newly pruned edges
    [P]), the reference's tuple."""
    res = local_solver.solve_stacked(
        dist, active, sh.loc_src, sh.loc_dst, sh.loc_w,
        pruned[:, :sh.e_loc], solver=cfg.local_solver,
        max_iters=cfg.local_iters, delta=cfg.delta,
        relax_layout=sh.relax_layout, relax_vb=sh.rx_vb,
        pallas_sweeps=cfg.pallas_sweeps, chunks=sh.relax_chunks)
    # an idle shard has no frontier, so its solve above was a no-op
    idle = ~active.flatten(1).any(-1)                       # [P]
    pruned, cursor, n = _prune_idle(sh, idle, pruned, cursor, cfg)
    return res.dist, pruned, cursor, res.relaxations, n


def _bucket_payload(sh: SsspShards, send_val):
    """Masked slot values [R, K, S] -> bucketed payload [R, K, P, C] by a
    scatter-min at the static (slot_owner, slot_pos) positions (R the
    stacked rows: P, or 1 on a rank of the shmap backend)."""
    R, K, _ = send_val.shape
    P, C = sh.n_parts, sh.bucket_cap
    flat = (sh.slot_owner.long() * C + sh.slot_pos.long())[:, None, :]
    payload = torch.full((R, K, P * C), INF, device=send_val.device)
    payload.scatter_reduce_(-1, flat.expand(R, K, -1), send_val, "amin")
    return payload.reshape(R, K, P, C)


def _scatter_dense(sh: SsspShards, send_val, blk: int):
    """Masked slot values [R, K, S] -> dense [R, K, P, blk] candidate rows
    addressed by (owner, dst_local): one ``scatter_reduce_("amin")`` into
    the flat ``[R, K, P * blk]`` rows. Shared by both send backends and the
    fused round, as in the reference: bandwidth-bound assembly, no
    reduction for a kernel to win."""
    R, K, _ = send_val.shape
    P = sh.n_parts
    flat = (sh.slot_owner.long() * blk + sh.slot_dstl.long())[:, None, :]
    payload = torch.full((R, K, P * blk), INF, device=send_val.device)
    payload.scatter_reduce_(-1, flat.expand(R, K, -1), send_val, "amin")
    return payload.reshape(R, K, P, blk)


@phases.register("send", "xla")
def _phase_send_xla(sh: SsspShards, dist, pruned, last_sent, *,
                    dense: bool = False):
    """Per-slot segment-min of the cut-edge candidates + improvement
    masking. Returns (payload [P, K, P, C], or [P, K, P, block] when
    ``dense``, last_sent' [P, K, S], sends [P, K])."""
    S = sh.n_slots
    w_cut = torch.where(pruned[:, sh.e_loc:], INF, sh.cut_w)      # [P, e_cut]
    cand = take_fill(dist, sh.cut_src[:, None, :], INF) + w_cut[:, None, :]
    slot_val = scatter_min_drop(
        torch.full((*dist.shape[:2], S), INF, device=dist.device),
        sh.cut_seg[:, None, :], cand)       # empty slots stay +inf
    improved = sh.slot_valid[:, None, :] & (slot_val < last_sent)
    send_val = torch.where(improved, slot_val, INF)
    new_last = torch.where(improved, slot_val, last_sent)
    sends = improved.sum(-1, dtype=torch.int32)
    payload = (_scatter_dense(sh, send_val, dist.shape[-1]) if dense
               else _bucket_payload(sh, send_val))
    return payload, new_last, sends


@phases.register("send", "pallas")
def _phase_send_pallas(sh: SsspShards, dist, pruned, last_sent, *,
                       dense: bool = False):
    """Slot-tiled send kernel over ``sh.tx_*`` (dense, or ragged when the
    layout carries its chunk->tile map): segment-min, masking and counts in
    one launch; the bucketed payload is the static gather through
    ``tx_payload_slot``, the dense one ``_scatter_dense``."""
    lay = sh.send_layout
    src_t, w_t, segrel_t, eid_t = lay[:4]
    P = eid_t.shape[0]
    pruned_t = take_fill(pruned[:, sh.e_loc:].to(torch.int32),
                         eid_t.reshape(P, -1), 0).reshape(eid_t.shape)
    send_val, new_last, sends = send_pack(
        dist, last_sent, sh.slot_valid, src_t, w_t, segrel_t, pruned_t,
        sb=sh.tx_sb, ctile=lay[4] if len(lay) == 5 else None,
        bounds=sh.send_bounds)
    return _payload(sh, send_val, dist.shape[-1], dense), new_last, sends


def _merge_dense(dist, incoming):
    """Dense incoming rows [P, K, block] are owner-addressed: an
    elementwise min, no scatter for a kernel to replace (both merge
    backends, as in the reference). Receives count the improving
    entries."""
    new = torch.minimum(dist, incoming)
    recvs = (incoming < dist).sum(-1, dtype=torch.int32)
    return new, new < dist, recvs


@phases.register("merge", "xla")
def _phase_merge_xla(sh: SsspShards, dist, incoming, *, dense: bool = False):
    """Scatter-min of the incoming [P, K, P, C] messages through
    ``recv_idx`` (sentinel ``block`` dropped), or ``_merge_dense`` of
    [P, K, block] rows. Returns (dist', new_active, recvs [P, K])."""
    if dense:
        return _merge_dense(dist, incoming)
    P, K = dist.shape[:2]
    flat_val = incoming.reshape(P, K, -1)
    new = scatter_min_drop(dist, sh.recv_idx.reshape(P, 1, -1), flat_val)
    recvs = torch.isfinite(flat_val).sum(-1, dtype=torch.int32)
    return new, new < dist, recvs


@phases.register("merge", "pallas")
def _phase_merge_pallas(sh: SsspShards, dist, incoming, *,
                        dense: bool = False):
    """Msg-tiled merge kernel over ``sh.mx_*`` (dense, or ragged when the
    layout carries its chunk->tile map): scatter-min, next frontier and
    receive counts in one launch. Dense rows go to ``_merge_dense``."""
    if dense:
        return _merge_dense(dist, incoming)
    P, K = dist.shape[:2]
    lay = sh.merge_layout
    return merge_scatter(dist, incoming.reshape(P, K, -1), *lay[:3],
                         vb=sh.mx_vb, ctile=lay[3] if len(lay) == 4 else None,
                         bounds=sh.merge_bounds)


def _mask_payload(payload):
    """Mask unused (query, destination) payload columns to +inf and price
    the transfer: 4 B x column width x columns carrying a finite value."""
    used = torch.isfinite(payload).any(-1)
    nbytes = 4 * payload.shape[-1] * used.sum(dtype=torch.int32)
    return torch.where(used[..., None], payload, INF), nbytes


class SimComm:
    """The reference's communication contract on shard-stacked [P, ...]
    arrays: reductions act over the shard axis (axis 0) and leave the query
    axis intact; flags are [P, K], payloads [P_src, K, P_dst, ...]."""

    def __init__(self, n_parts: int, device=None):
        self.P = n_parts
        self.device = device

    def rank(self):
        """[P] int32 shard ids."""
        return torch.arange(self.P, dtype=torch.int32, device=self.device)

    def size(self) -> int:
        return self.P

    @staticmethod
    def exchange_bucket(payload):
        """[P_src, K, P_dst, C] -> [P_dst, K, P_src, C]."""
        return payload.transpose(0, 2)

    @staticmethod
    def exchange_pmin(payload):
        """Dense [P_src, K, P_owner, block] -> the per-owner min over the
        senders, [P_owner, K, block]."""
        return payload.amin(0).transpose(0, 1)

    exchange_a2a_dense = exchange_pmin   # one realization on one device

    @staticmethod
    def ring(tok):
        """One hop forward on the shard ring: every field rolled by +1."""
        return type(tok)(*(torch.roll(x, 1, 0) for x in tok))

    def dest_dirs(self):
        """[P_src, P_dst] bool: True where the message travels the forward
        ring (the shorter way; ties at P/2 go forward), so no message is
        more than P // 2 hops from its owner."""
        r = self.rank()[:, None]
        d = self.rank()[None, :]
        return ((d - r) % self.P) <= ((r - d) % self.P)

    def async_hop(self, fwd, bwd):
        """One hop of the two dense transit buffers [P, K, P, block]
        (column p holds what is bound for shard p): ``fwd`` rolled by +1 on
        the shard axis, ``bwd`` by -1; shard p then takes the min of both
        buffers' column p, and those entries are cleared to +inf in the
        rolled copies (the carried buffers are not written). Returns
        (incoming [P, K, block], fwd', bwd')."""
        fwd = torch.roll(fwd, 1, 0)
        bwd = torch.roll(bwd, -1, 0)
        r = torch.arange(self.P, device=fwd.device)
        inc = torch.minimum(fwd[r, :, r], bwd[r, :, r])
        fwd[r, :, r] = INF
        bwd[r, :, r] = INF
        return inc, fwd, bwd

    @staticmethod
    def all_any(flag):
        """OR over the shard axis, broadcast back to every shard."""
        return flag.any(0, keepdim=True).expand_as(flag)

    @staticmethod
    def all_all(flag):
        """AND over the shard axis, broadcast back to every shard."""
        return flag.all(0, keepdim=True).expand_as(flag)

    @staticmethod
    def total(x):
        """Sum over the shard axis in x's dtype, broadcast back."""
        return x.sum(0, keepdim=True, dtype=x.dtype).expand_as(x)

    @staticmethod
    def any_global(flag):
        """OR over every element of every shard: a 0-dim bool."""
        return flag.any()


class ShmapComm:
    """The same contract on a rank's one-shard stack ``[1, ...]`` (the
    ``shmap`` backend: one process a shard), with ``torch.distributed``
    collectives over the mesh axes' ``AxisGroup`` in place of the shard
    axis ops (reference ``ShmapComm``). Flags are [1, K], payloads
    [1, K, P, ...]; each exchange is one collective for the whole query
    batch.

    ``timed=True`` synchronizes the device around every collective and
    adds its wall to ``coll_s`` (and one to ``coll_calls``): the time a
    solve spends in collectives, at the cost of a sync each."""

    def __init__(self, ag, device=None, *, timed: bool = False):
        self.ag = ag
        self.P = ag.size
        self.r = ag.rank
        self.device = device
        self.timed = timed
        self.coll_s = 0.0
        self.coll_calls = 0

    def _coll(self, fn, *args):
        if not self.timed:
            return fn(*args)
        sync = (torch.cuda.synchronize if self.device is not None
                and torch.device(self.device).type == "cuda" else None)
        if sync:
            sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            sync(self.device)
        self.coll_s += time.perf_counter() - t0
        self.coll_calls += 1
        return out

    def rank(self):
        """[1] int32: this rank's shard id."""
        return torch.tensor([self.r], dtype=torch.int32, device=self.device)

    def size(self) -> int:
        return self.P

    def exchange_bucket(self, payload):
        """[1, K, P_dst, C] -> [1, K, P_src, C]: one all-to-all."""
        recv = self._coll(coll.all_to_all_tiled, payload[0].transpose(0, 1),
                          self.ag)                           # [P_src, K, C]
        return recv.transpose(0, 1)[None]

    def exchange_pmin(self, payload):
        """Dense [1, K, P_owner, block] -> this rank's column of the min
        over the senders, [1, K, block]: one all-reduce min."""
        return self._coll(coll.pmin_named, payload, self.ag)[:, :, self.r]

    def exchange_a2a_dense(self, payload):
        """Dense [1, K, P_owner, block] -> [1, K, block]: an all-to-all of
        the owner columns, then the min over the senders."""
        recv = self._coll(coll.all_to_all_tiled, payload[0].transpose(0, 1),
                          self.ag)                       # [P_src, K, block]
        return recv.amin(0, keepdim=True)

    def ring(self, tok):
        """One hop forward on the ring: every field of the token, packed
        into one int32 tensor and moved by one ring permute."""
        packed = torch.stack([x.to(torch.int32) for x in tok])
        moved = self._coll(coll.ring_permute, packed, self.ag)
        return type(tok)(*(moved[i].to(x.dtype) for i, x in enumerate(tok)))

    def dest_dirs(self):
        """[1, P_dst] bool: True where the message travels the forward
        ring (the shorter way; ties at P/2 go forward)."""
        d = torch.arange(self.P, device=self.device)
        return (((d - self.r) % self.P) <= ((self.r - d) % self.P))[None]

    def async_hop(self, fwd, bwd):
        """One hop of the dense transit buffers [1, K, P, block] (column p
        is bound for rank p): ``fwd`` one hop forward, ``bwd`` one back,
        each a ring permute; this rank takes the min of both buffers' own
        column and clears it to +inf. Returns (incoming [1, K, block],
        fwd', bwd')."""
        fwd = self._coll(coll.ring_permute, fwd, self.ag)
        bwd = self._coll(coll.ring_permute_rev, bwd, self.ag)
        inc = torch.minimum(fwd[:, :, self.r], bwd[:, :, self.r])
        fwd[:, :, self.r] = INF
        bwd[:, :, self.r] = INF
        return inc, fwd, bwd

    def all_any(self, flag):
        return self._coll(coll.or_reduce, flag, self.ag)

    def all_all(self, flag):
        return self._coll(coll.and_reduce, flag, self.ag)

    def total(self, x):
        return self._coll(coll.psum_named, x, self.ag)

    def max_all(self, x):
        return self._coll(coll.pmax_named, x, self.ag)

    def min_all(self, x):
        return self._coll(coll.pmin_named, x, self.ag)

    def any_global(self, flag):
        """OR over every element of every rank: a 0-dim bool."""
        return self.all_any(flag.any().reshape(1))[0]

    def all_gather(self, x):
        """[1, ...] on each rank -> the [P, ...] stack, rank order."""
        return self._coll(coll.all_gather_tiled, x, self.ag)


# --------------------------------------------------------------------------
# exchange stages
# --------------------------------------------------------------------------

class ExchangeStage(NamedTuple):
    """Registry entry of an exchange mode. ``dense`` selects the payload the
    send and merge phases build and take ([P, K, P, block] rows vs the
    bucketed [P, K, P, C]); ``run(comm, payload)`` is the synchronous
    transfer.

    ``deferred=True`` marks an asynchronous exchange, whose round does not
    call ``run``: ``recv(comm, inflight) -> (incoming, inflight_mid)``
    delivers the oldest carried batch at round start (round r receives what
    round r-1-lag sent), ``push(comm, inflight_mid, payload) -> inflight'``
    queues this round's sends after the send phase,
    ``init_inflight(sh, nq, cfg)`` builds the empty (+inf) buffers and
    ``flush(comm, inflight) -> [incoming, ...]`` drains every undelivered
    batch at exit (``make_finalize``)."""
    name: str
    dense: bool
    run: Any
    deferred: bool = False
    recv: Any = None
    push: Any = None
    init_inflight: Any = None
    flush: Any = None


def _async_bucket_recv(comm, inflight):
    # the oldest buffered payload is delivered; the rest keep aging
    return comm.exchange_bucket(inflight[0]), inflight[1:]


def _async_bucket_push(comm, inflight, payload):
    return inflight + (payload,)


def _async_bucket_init(sh: SsspShards, nq: int, cfg):
    shape = (sh.n_rows, nq, sh.n_parts, sh.bucket_cap)
    return tuple(torch.full(shape, INF, device=sh.device)
                 for _ in range(cfg.async_lag))


def _async_bucket_flush(comm, inflight):
    return [comm.exchange_bucket(b) for b in inflight]


def _async_ppermute_recv(comm, inflight):
    inc, fwd, bwd = comm.async_hop(*inflight)
    return inc, (fwd, bwd)


def _async_ppermute_push(comm, inflight, payload):
    # min-combine this round's sends into the transit buffers: the dense
    # payload is owner/vertex-addressed, so combining en route is exact
    fwd, bwd = inflight
    mask = comm.dest_dirs()[:, None, :, None]
    return (torch.minimum(fwd, torch.where(mask, payload, INF)),
            torch.minimum(bwd, torch.where(mask, INF, payload)))


def _async_ppermute_init(sh: SsspShards, nq: int, cfg):
    z = torch.full((sh.n_rows, nq, sh.n_parts, sh.block), INF,
                   device=sh.device)
    return (z, z)


def _async_ppermute_flush(comm, inflight):
    # short-way routing leaves any message at most P // 2 hops from its
    # owner; the merge order is irrelevant (monotone min)
    out = []
    for _ in range(comm.size() // 2):
        inc, inflight = _async_ppermute_recv(comm, inflight)
        out.append(inc)
    return out


phases.register("exchange", "bucket")(ExchangeStage(
    "bucket", dense=False, run=lambda comm, p: comm.exchange_bucket(p)))
phases.register("exchange", "pmin")(ExchangeStage(
    "pmin", dense=True, run=lambda comm, p: comm.exchange_pmin(p)))
phases.register("exchange", "a2a_dense")(ExchangeStage(
    "a2a_dense", dense=True, run=lambda comm, p: comm.exchange_a2a_dense(p)))
# deferred exchanges: "async" buffers cfg.async_lag bucketed payloads;
# "async_ppermute" streams the dense rows hop by hop around the shard ring
# in both directions, each message the short way. ``run`` is their
# synchronous realization, unused by the round.
_ASYNC_BUCKET = ExchangeStage(
    "async", dense=False, run=lambda comm, p: comm.exchange_bucket(p),
    deferred=True, recv=_async_bucket_recv, push=_async_bucket_push,
    init_inflight=_async_bucket_init, flush=_async_bucket_flush)
phases.register("exchange", "async")(_ASYNC_BUCKET)
phases.register("exchange", "async_bucket")(
    _ASYNC_BUCKET._replace(name="async_bucket"))
phases.register("exchange", "async_ppermute")(ExchangeStage(
    "async_ppermute", dense=True,
    run=lambda comm, p: comm.exchange_a2a_dense(p),
    deferred=True, recv=_async_ppermute_recv, push=_async_ppermute_push,
    init_inflight=_async_ppermute_init, flush=_async_ppermute_flush))
phases.register("round", "staged")("staged")
phases.register("round", "fused")("fused")


def _pending_inflight(inflight):
    """[P, K]: the shard still holds undelivered payload for the query.
    ORed into the termination view, so no detector declares quiescence
    over messages in flight."""
    bits = None
    for a in inflight:
        b = torch.isfinite(a).flatten(2).any(-1)
        bits = b if bits is None else bits | b
    return bits


def _count_improving(sh: SsspShards, dist, incoming, dense: bool):
    """[P, K] deliveries of a batch that improve on the pre-merge distances:
    under a deferred exchange every delivered batch is at least a round
    old, so these are the stale merges. A bucketed message's target is
    ``recv_idx``; the sentinel gathers -inf, never beaten."""
    P, K = dist.shape[:2]
    if dense:
        return (incoming < dist).sum(-1, dtype=torch.int32)
    flat = incoming.reshape(P, K, -1)
    d_t = take_fill(dist, sh.recv_idx.reshape(P, 1, -1), -INF)
    return (flat < d_t).sum(-1, dtype=torch.int32)


# --------------------------------------------------------------------------
# termination stages
# --------------------------------------------------------------------------
#
# The reference's arguments: the config, the comm, the carry before the
# round, this round's termination view of the frontier ([P, K, n]; only its
# any over the last axis is read) with payload in flight ORed in, the
# per-shard [P, K] send and receive counts, and the shards. Each returns
# ([P, K] done mask, toka2', streak').

def _quiescent(comm: SimComm, new_active):
    """([P, K] no shard has a live frontier for the query, [P, K] this
    shard has none)."""
    idle = ~new_active.any(-1)
    return comm.all_all(idle), idle


@phases.register("toka", "toka0")
def _toka0_stage(cfg, comm: SimComm, carry, new_active, sends, recvs,
                 sh: SsspShards):
    return _quiescent(comm, new_active)[0], carry.toka2, carry.streak


@phases.register("toka", "toka1")
def _toka1_stage(cfg, comm: SimComm, carry, new_active, sends, recvs,
                 sh: SsspShards):
    """Quiescence, or every shard's running receive count past P x its
    inter-edge count. The reference's ``msg_count`` is the running sum of
    ``recvs``, which is the carry's ``msgs_recv``: it is read here rather
    than kept twice."""
    vote = toka_mod.toka1_vote(carry.msgs_recv + recvs,
                               sh.inter_edges[:, None], sh.n_parts)
    return (_quiescent(comm, new_active)[0] | comm.all_all(vote),
            carry.toka2, carry.streak)


@phases.register("toka", "toka2")
def _toka2_stage(cfg, comm: SimComm, carry, new_active, sends, recvs,
                 sh: SsspShards):
    """One hop of the K token rings. Safra's counters hold only for a
    message transport: under a dense exchange a sent improvement is not
    one counted receive, and under faults a dropped send is never received
    and a released duplicate is an unmatched receive. There the color-only
    variant runs (counters zeroed, blacken on send), as in the reference;
    the pending bits in the idle view hold the ring open over messages the
    injector still holds."""
    _, idle = _quiescent(comm, new_active)
    if (not phases.resolve("exchange", cfg.exchange).dense
            and cfg.fault_plan is None):
        acct = toka_mod.toka2_account(carry.toka2, sends, recvs)
    else:
        zero = torch.zeros_like(sends)
        acct = toka_mod.toka2_account(carry.toka2, zero, zero)
        acct = acct._replace(color=torch.where(sends > 0, toka_mod.BLACK,
                                               acct.color))
    st, outgoing = toka_mod.toka2_forward(acct, comm.rank()[:, None], idle,
                                          n_parts=sh.n_parts)
    st = toka_mod.toka2_absorb(st, comm.ring(outgoing))
    return comm.all_all(st.seen_red), st, carry.streak


@phases.register("toka", "toka3")
def _toka3_stage(cfg, comm: SimComm, carry, new_active, sends, recvs,
                 sh: SsspShards):
    """The timeout: a query is done once it has been globally quiet (no
    frontier, send, receive or payload in flight) for ``toka3_bound``
    rounds of the GLOBAL inter-edge count. A fault plan widens the bound
    by its ``fault_slack``, and a deferred exchange by its worst delivery
    lag: ``async_lag`` buffered rounds, plus P // 2 hops for the dense ring.
    The bound is computed once on the host
    (``SsspShards.inter_edges_total``), so every device reads the same."""
    ex = phases.resolve("exchange", cfg.exchange)
    fp = cfg.fault_plan
    slack = 0 if fp is None else fp.fault_slack
    if ex.deferred:
        slack += cfg.async_lag + (sh.n_parts // 2 if ex.dense else 0)
    bound = toka_mod.toka3_timeout(sh.inter_edges_total, sh.n_parts,
                                   float(cfg.toka3_safety), slack)
    act = new_active.any(-1) | (sends > 0) | (recvs > 0)
    streak = torch.where(comm.all_any(act), 0, carry.streak + 1)
    return streak >= bound, carry.toka2, streak


# --------------------------------------------------------------------------
# round, init and certificate
# --------------------------------------------------------------------------

def _round_mode(sh: SsspShards, cfg: SsspConfig) -> str:
    """Resolved round pipeline. ``round="fused"`` needs all three tile
    layouts (relax ``rx_*``, send ``tx_*``, merge ``mx_*``); when any is
    missing it degrades to the staged pipeline with a one-time warning, as
    the per-phase kernel backends do."""
    if cfg.round != "fused":
        return "staged"
    if sh.has_relax_layout and sh.has_send_layout and sh.has_merge_layout:
        return "fused"
    phases.warn_once(
        "round.fused.no_layout",
        "round='fused' falling back to the staged pipeline: the shards are "
        "missing the dst-/slot-/msg-tiled layouts (build_shards was called "
        "with relax_layout=False or comm_layout=False)")
    return "staged"


def dispatches_per_round(sh: SsspShards, cfg: SsspConfig) -> int:
    """Data-plane dispatches per round: the staged pipeline launches 4
    (local solve, send pack, exchange, merge scatter); the fused round 2
    (the fused kernel, exchange)."""
    return 2 if _round_mode(sh, cfg) == "fused" else 4


def _payload(sh: SsspShards, send_val, blk: int, dense: bool):
    """Masked slot values [P, K, S] -> the dense rows or the bucketed
    payload (the static gather through ``tx_payload_slot``)."""
    return (_scatter_dense(sh, send_val, blk) if dense
            else send_payload_bucket(send_val, sh.tx_payload_slot))


def _phase_fused(sh: SsspShards, dist, front_in, live, incoming, last_sent,
                 pruned, cfg, *, dense: bool):
    """One fused kernel launch: merge + local fixpoint + send pack, plus the
    payload assembly (``incoming`` [P, K, P, C] bucketed, or [P, K, block]
    rows when ``dense``). Returns (dist, payload, last_sent', sends, nrel,
    resid): a non-empty ``resid`` row means ``cfg.pallas_sweeps`` in-kernel
    sweeps did not reach the fixpoint, and the caller must rescue the round
    before using the send outputs."""
    P, K = dist.shape[:2]
    new_dist, send_val, new_last, nrel, sends, resid = _fused_round_stacked(
        dist, front_in, live, incoming.reshape(P, K, -1), last_sent,
        sh.slot_valid, sh.relax_layout, sh.send_layout, sh.merge_layout,
        pruned[:, :sh.e_loc], pruned[:, sh.e_loc:], vb=sh.rx_vb,
        sb=sh.tx_sb, n_sweeps=cfg.pallas_sweeps, dense=dense,
        chunks=sh.round_chunks)
    payload = _payload(sh, send_val, dist.shape[-1], dense)
    return new_dist, payload, new_last, sends, nrel, resid


def _phase_fused_rescue(sh: SsspShards, dist, resid, last_sent, pruned, cfg,
                        *, dense: bool):
    """Finish a fused round whose in-kernel sweeps left a residual
    frontier: continue the fixpoint with the relax kernel and re-pack the
    sends against the ORIGINAL ``last_sent``. Returns (dist, payload,
    last_sent', sends, nrel_extra)."""
    out = _fused_round_rescue_stacked(
        dist, resid, last_sent, sh.slot_valid, sh.relax_layout,
        sh.send_layout, pruned[:, :sh.e_loc], pruned[:, sh.e_loc:],
        vb=sh.rx_vb, sb=sh.tx_sb, n_sweeps=cfg.pallas_sweeps,
        max_iters=cfg.local_iters, send_bounds=sh.send_bounds,
        relax_chunks=sh.relax_chunks)
    new_dist, send_val, new_last, nrel_extra, sends = out
    payload = _payload(sh, send_val, dist.shape[-1], dense)
    return new_dist, payload, new_last, sends, nrel_extra


def _account_delivery(sh: SsspShards, dist, incoming, dense: bool):
    """Receive counts and per-query any-improvement bits of a delivered
    batch against the post-relax distances: the staged merge phase's
    accounting, without merging (the values merge next round). Bucketed: a
    message improves iff it beats the distance at its routed target (the
    sentinel target gathers -inf, never beaten); dense rows count their
    improving entries as receives. Also the improving count ``n_imp``, the
    deferred exchanges' stale merges. Returns (any_imp, recvs, n_imp), each
    [P, K]."""
    n_imp = _count_improving(sh, dist, incoming, dense)
    if dense:
        recvs = n_imp
    else:
        P, K = dist.shape[:2]
        recvs = torch.isfinite(incoming.reshape(P, K, -1)).sum(
            -1, dtype=torch.int32)
    return n_imp > 0, recvs, n_imp


def make_finalize(sh: SsspShards, cfg: SsspConfig, comm=None,
                  vmapped: bool = True):
    """Exit-time ``fn(carry) -> dist`` merging every delivered-but-unmerged
    and in-flight batch, or None when nothing can be outstanding (a staged
    round with a synchronous exchange). The fused round merges a round's
    delivery in the next round, so the loop can exit with one batch in
    ``carry.incoming``; a deferred exchange can exit with payload in
    ``carry.inflight`` (a ``max_rounds`` or toka1 exit), which its
    ``flush`` drains. The merges run unconditionally: the final distances
    must not depend on the detector's reasoning. ``comm`` is the
    backend's (default: the ``SimComm`` of the stack). ``vmapped`` is the
    reference's switch between the vmapped stack and one shard inside
    ``shard_map``; the port's stack serves both (a shmap rank holds a
    one-shard stack), so it is accepted and changes nothing."""
    ex = phases.resolve("exchange", cfg.exchange)
    fused = _round_mode(sh, cfg) == "fused"
    if not fused and not ex.deferred:
        return None
    comm = comm or SimComm(sh.n_parts, sh.device)

    def merge(dist, incoming):
        if ex.dense:
            return torch.minimum(dist, incoming)
        return _phase_merge_xla(sh, dist, incoming)[0]

    def finalize(carry: _Carry):
        dist = carry.dist
        if fused:
            dist = merge(dist, carry.incoming)
        if ex.deferred:
            for inc in ex.flush(comm, carry.inflight):
                dist = merge(dist, inc)
        return dist

    return finalize


def _exchange(comm, ex: ExchangeStage, inflight_mid, carry_inflight,
              payload):
    """(incoming or None, inflight'): a synchronous exchange delivers this
    round's payload; a deferred one queues it (its delivery happened at
    round start)."""
    if ex.deferred:
        return None, ex.push(comm, inflight_mid, payload)
    return ex.run(comm, payload), carry_inflight


def _resend_window(cfg: SsspConfig, comm: SimComm, carry: _Carry):
    """The anti-entropy window: every ``resend_period``-th round, senders
    forget their ``last_sent`` floor for each query some receiver latched
    an unhealed drop on (one all-reduce of the latches), so the send phase
    retransmits every current slot minimum for it; slot values only fall,
    so the dropped message is healed by this round's copy unless it is
    dropped again. Gating on the latch, rather than resending blindly, is
    what lets the system ever look quiet. The round counter is a host int,
    so an off-period round costs nothing. Returns (resend_now [P, K] bool,
    or None off-period, the ``last_sent`` the send phase takes)."""
    fp = cfg.fault_plan
    if (fp is None or fp.resend_period == 0
            or carry.rounds % fp.resend_period != fp.resend_period - 1):
        return None, carry.last_sent
    resend_now = comm.all_any(carry.faults.unhealed)
    return resend_now, torch.where(resend_now[..., None], INF,
                                   carry.last_sent)


def _deliver(sh: SsspShards, ex, carry: _Carry, dist, incoming, resend_now):
    """Fault delivery of a batch under a ``FaultyExchange`` (the batch
    unchanged otherwise). A resend round first clears the latches it
    retransmits for, so only drops of the resent copies re-arm them.
    Returns (incoming', fault state', stale [P, K] or None, pending [P, K]
    or None)."""
    if not isinstance(ex, faults_mod.FaultyExchange):
        return incoming, carry.faults, None, None
    fstate = carry.faults
    if resend_now is not None:
        fstate = fstate._replace(unhealed=fstate.unhealed & ~resend_now)
    keys = faults_mod.round_keys(ex.plan, carry.rounds,
                                 range(sh.row0, sh.row0 + sh.n_rows),
                                 dist.device)
    return ex.deliver(sh, dist, incoming, fstate, keys)


def _resent(carry: _Carry, resend_now, sends):
    if resend_now is None:
        return carry.resent
    return carry.resent + torch.where(resend_now, sends, 0)


def _make_round_fused(sh: SsspShards, cfg: SsspConfig, comm):
    """The fused-round variant of ``make_round``. The idle branch (Trishla)
    runs before the kernel, gated per shard, since merge and send run on
    idle rounds too. The rescue runs when any row of the whole stack kept a
    residual frontier. Accounting happens at delivery time, from the
    post-relax distances and the raw delivered batch. A deferred exchange
    delivers at round start (the kernel merges it next round, a total lag
    of 2 under ``async``); a round overlaps when some shard had payload on
    the wire while some shard was not idle. Under a fault plan the kernel
    and its rescue pack from the resend window's ``last_sent``, and the
    delivered batch passes the injector before it is accounted."""
    pipe = build_pipeline(sh, cfg)
    ex = pipe.exchange
    dense, deferred = ex.dense, ex.deferred

    def round_fn(carry: _Carry) -> _Carry:
        live = ~carry.done                                  # [P, K]
        idle = ~(carry.front_any & live).any(-1)            # [P]
        incoming = inflight_mid = delivering = None
        if deferred:
            delivering = _pending_inflight(carry.inflight).any(-1)   # [P]
            incoming, inflight_mid = ex.recv(comm, carry.inflight)
        pruned, cursor, _ = _prune_idle(sh, idle, carry.pruned,
                                        carry.tri_cursor, cfg)
        # the injected frontier: source bits on round 0, empty thereafter
        front_in = carry.active & live[..., None]
        resend_now, last_in = _resend_window(cfg, comm, carry)
        dist, payload, last_sent, sends, nrel, resid = _phase_fused(
            sh, carry.dist, front_in, live, carry.incoming, last_in,
            pruned, cfg, dense=dense)
        if bool((resid > 0).any()):
            dist, payload, last_sent, sends, extra = _phase_fused_rescue(
                sh, dist, resid, last_in, pruned, cfg, dense=dense)
            nrel = nrel + extra
        payload, nbytes = _mask_payload(payload)
        sent, inflight = _exchange(comm, ex, inflight_mid, carry.inflight,
                                   payload)
        if sent is not None:
            incoming = sent
        incoming, fstate, stale_f, pending = _deliver(
            sh, ex, carry, dist, incoming, resend_now)
        incoming = incoming.contiguous()                   # read twice
        any_imp, recvs, n_imp = _account_delivery(sh, dist, incoming, dense)
        # toka reads only any(new_active, -1): a [P, K, 1] plane of the
        # any-improvement bits stands in for the staged merge's frontier
        toka_flag = any_imp
        if pending is not None:
            toka_flag = toka_flag | pending
        stale, overlap = carry.stale, carry.overlap
        if deferred:
            # every delivered batch is at least a round old: its improving
            # entries are the stale merges (queue releases are already
            # min-merged into it, so the injector's count is skipped)
            toka_flag = toka_flag | _pending_inflight(inflight)
            stale = stale + n_imp
            overlap = overlap + comm.any_global(delivering & ~idle).to(
                torch.int32)
        elif stale_f is not None:
            stale = stale + stale_f
        done, toka2, streak = pipe.toka(cfg, comm, carry, toka_flag[..., None],
                                        sends, recvs, sh)
        return _Carry(
            dist=dist, active=torch.zeros_like(carry.active), pruned=pruned,
            tri_cursor=cursor, last_sent=last_sent,
            done=carry.done | done, rounds=carry.rounds + 1,
            q_rounds=carry.q_rounds + (~carry.done).to(torch.int32),
            relaxations=carry.relaxations + nrel,
            msgs_sent=carry.msgs_sent + sends,
            msgs_recv=carry.msgs_recv + recvs,
            comm_bytes=carry.comm_bytes + nbytes, streak=streak, stale=stale,
            resent=_resent(carry, resend_now, sends), overlap=overlap,
            toka2=toka2, incoming=incoming, front_any=any_imp,
            inflight=inflight, faults=fstate)

    return round_fn


class RoundPipeline(NamedTuple):
    """The round's stages, resolved once per (shards, config) from the
    backend registry: ``local``, ``send`` and ``merge`` take the stacked
    shards (send and merge also ``dense=``), ``exchange`` is an
    ``ExchangeStage``, ``toka`` the termination stage."""
    local: Any
    send: Any
    exchange: ExchangeStage
    merge: Any
    toka: Any


def build_pipeline(sh: SsspShards, cfg: SsspConfig) -> RoundPipeline:
    """Resolve every phase backend for these shards. An active
    ``cfg.faults`` plan wraps the resolved exchange with the
    fault-injecting decorator (``core/faults.py: wrap_exchange``): the
    transfer is untouched, delivery goes through the injector. The pallas
    send and merge backends need the ``tx_*`` / ``mx_*`` layouts; on
    shards built with ``comm_layout=False`` they degrade to the ``xla``
    backends with a one-time warning, as the pallas local solver does
    without ``rx_*``."""
    ex = phases.resolve("exchange", cfg.exchange)
    if cfg.fault_plan is not None:
        ex = faults_mod.wrap_exchange(ex, cfg.fault_plan)
    send_backend = cfg.send_backend
    if send_backend == "pallas" and not sh.has_send_layout:
        phases.warn_once(
            "send.pallas.no_layout",
            "send_backend='pallas' falling back to 'xla': the shards carry "
            "no slot-tiled cut-edge layout (build_shards was called with "
            "comm_layout=False)")
        send_backend = "xla"
    merge_backend = cfg.merge_backend
    if merge_backend == "pallas" and not sh.has_merge_layout:
        phases.warn_once(
            "merge.pallas.no_layout",
            "merge_backend='pallas' falling back to 'xla': the shards carry "
            "no msg-tiled receive layout (build_shards was called with "
            "comm_layout=False)")
        merge_backend = "xla"
    return RoundPipeline(
        local=partial(_phase_local, cfg=cfg),
        send=phases.resolve("send", send_backend),
        exchange=ex,
        merge=phases.resolve("merge", merge_backend),
        toka=phases.resolve("toka", cfg.toka))


def make_round(sh: SsspShards, cfg: SsspConfig, comm=None):
    """Returns round(carry) -> carry for the config's round pipeline. Under
    a deferred exchange the round takes its delivery first (the batch sent
    ``async_lag`` rounds ago, or one ring hop) and queues its own sends; a
    round overlaps when some shard had payload on the wire while some shard
    had a frontier to relax. Under a fault plan the send phase packs from
    the resend window's ``last_sent`` and the delivered batch passes the
    injector. Then, under a deferred exchange, the improving entries of
    the batch as delivered, against the post-solve distances, count as
    stale merges; else the injector's own count of improving queue
    releases does. ``comm`` is the backend's (default: the ``SimComm``
    of the stack); every collective it makes runs on every rank every
    round, so the ranks of the shmap backend stay in lockstep."""
    comm = comm or SimComm(sh.n_parts, sh.device)
    if _round_mode(sh, cfg) == "fused":
        return _make_round_fused(sh, cfg, comm)
    pipe = build_pipeline(sh, cfg)
    ex = pipe.exchange
    dense, deferred = ex.dense, ex.deferred

    def round_fn(carry: _Carry) -> _Carry:
        incoming = inflight_mid = delivering = None
        if deferred:
            delivering = _pending_inflight(carry.inflight).any(-1)   # [P]
            incoming, inflight_mid = ex.recv(comm, carry.inflight)
        # finished queries stop relaxing and sending while stragglers run
        act = carry.active & ~carry.done[..., None]
        dist, pruned, cursor, nrel, _ = pipe.local(
            sh, carry.dist, act, carry.pruned, carry.tri_cursor)
        resend_now, last_in = _resend_window(cfg, comm, carry)
        payload, last_sent, sends = pipe.send(sh, dist, pruned, last_in,
                                              dense=dense)
        payload, nbytes = _mask_payload(payload)
        sent, inflight = _exchange(comm, ex, inflight_mid, carry.inflight,
                                   payload)
        if sent is not None:
            incoming = sent
        incoming, fstate, stale_f, pending = _deliver(
            sh, ex, carry, dist, incoming, resend_now)
        stale, overlap = carry.stale, carry.overlap
        if deferred:
            stale = stale + _count_improving(sh, dist, incoming, dense)
        elif stale_f is not None:
            stale = stale + stale_f
        dist, new_active, recvs = pipe.merge(sh, dist, incoming, dense=dense)
        # termination sees undelivered state (the fault queue, unhealed
        # drops, payload in flight) as activity; the real frontier stays
        # clean. The stages read only any(-1) of the view.
        if deferred:
            held = _pending_inflight(inflight)
            pending = held if pending is None else pending | held
            computing = act.flatten(1).any(-1)                      # [P]
            overlap = overlap + comm.any_global(delivering & computing).to(
                torch.int32)
        toka_view = new_active
        if pending is not None:
            toka_view = (new_active.any(-1, keepdim=True)
                         | pending[..., None])
        done, toka2, streak = pipe.toka(cfg, comm, carry, toka_view, sends,
                                        recvs, sh)
        return _Carry(
            dist=dist, active=new_active, pruned=pruned, tri_cursor=cursor,
            last_sent=last_sent,
            done=carry.done | done, rounds=carry.rounds + 1,
            q_rounds=carry.q_rounds + (~carry.done).to(torch.int32),
            relaxations=carry.relaxations + nrel,
            msgs_sent=carry.msgs_sent + sends,
            msgs_recv=carry.msgs_recv + recvs,
            comm_bytes=carry.comm_bytes + nbytes, streak=streak, stale=stale,
            resent=_resent(carry, resend_now, sends), overlap=overlap,
            toka2=toka2, inflight=inflight, faults=fstate)

    return round_fn


def sim_phase_fns(sh: SsspShards, cfg: SsspConfig):
    """Per-phase callables over the stacked sim state, the reference's
    per-phase attribution hook: each phase of the round (local, send,
    exchange, merge) can be driven and timed alone on real mid-solve
    state. Shapes follow the sim carry (leading [P], then [K]); each
    returns the reference's tuple:

    - ``local(dist, active, pruned, cursor)`` -> (dist, pruned, cursor,
      relaxations [P, K], newly pruned edges [P]);
    - ``send(dist, pruned, last_sent)`` -> (payload, last_sent', sends);
    - ``exchange(payload)`` -> the delivered batch (a deferred exchange's
      synchronous realization);
    - ``merge(dist, incoming)`` -> (dist, new_active, recvs);
    - ``fused(dist, front_in, live, incoming, last_sent, pruned)`` ->
      (dist, payload, last_sent', sends, relaxations, residual frontier),
      only when the shards carry all three tile layouts.

    The backends resolve as the round's do, fallbacks included, so the
    pallas backends launch kernels 1/2 (local), 3/4 (send), 5/6 (merge)
    and 7/8 (fused) on CUDA tensors. Plain Python over the stacked
    tensors: nothing is compiled."""
    comm = SimComm(sh.n_parts, sh.device)
    pipe = build_pipeline(sh, cfg)
    dense = pipe.exchange.dense
    fns = {
        "local": lambda dist, active, pruned, cursor: pipe.local(
            sh, dist, active, pruned, cursor),
        "send": lambda dist, pruned, last_sent: pipe.send(
            sh, dist, pruned, last_sent, dense=dense),
        "exchange": lambda payload: pipe.exchange.run(comm, payload),
        "merge": lambda dist, incoming: pipe.merge(sh, dist, incoming,
                                                   dense=dense),
    }
    if sh.has_relax_layout and sh.has_send_layout and sh.has_merge_layout:
        fns["fused"] = (
            lambda dist, front_in, live, incoming, last_sent, pruned:
            _phase_fused(sh, dist, front_in, live, incoming, last_sent,
                         pruned, cfg, dense=dense))
    return fns


def init_carry(sh: SsspShards, sources, cfg: SsspConfig,
               q_valid=None, seed_dist=None) -> _Carry:
    """Stacked start state for K sources [K] int32, over the stack's rows:
    all P shards, or on a rank of the shmap backend its one shard, which
    sets only the sources it owns. ``q_valid`` masks padded bucket rows:
    an invalid query starts with no frontier and done=True, so it never
    relaxes, sends or counts.

    ``seed_dist`` [R, K, block] (None: the cold +inf start) holds
    per-vertex upper bounds from a ``warm_init`` stage. The source bit is
    min-scattered to 0 on top of it, and every finitely seeded vertex of a
    valid query starts ACTIVE: a seeded value must still be relaxed from,
    or a neighbour whose shortest path runs through it could stay above
    its true distance. The monotone round then reaches the cold start's
    fixpoint from a closer start.

    A deferred exchange starts with empty (+inf) in-flight buffers: round
    0 delivers nothing. The toka2 rings start with every token on shard
    0. An active fault plan starts an empty queue of one slot per flat
    payload position: ``block`` under a dense exchange, ``P * C`` for the
    bucketed routing."""
    dev = sh.device
    sources = torch.as_tensor(sources, dtype=torch.int32, device=dev)
    nq = sources.shape[0]
    q_valid = (torch.ones(nq, dtype=torch.bool, device=dev) if q_valid is None
               else torch.as_tensor(q_valid, dtype=torch.bool, device=dev))
    P, R, block = sh.n_parts, sh.n_rows, sh.block
    owner, local = (sources // block).long(), (sources % block).long()
    qi = torch.arange(nq, device=dev)
    row = owner - sh.row0
    q_valid_m = q_valid
    if R < P:
        # a rank's view: only the sources it owns
        mine = (row >= 0) & (row < R)
        row, qi, local, q_valid_m = (row[mine], qi[mine], local[mine],
                                     q_valid[mine])
    if seed_dist is None:
        dist = torch.full((R, nq, block), INF, device=dev)
        dist[row, qi, local] = torch.where(q_valid_m, 0.0, INF)
        active = torch.zeros((R, nq, block), dtype=torch.bool, device=dev)
        active[row, qi, local] = q_valid_m
    else:
        dist = seed_dist.clone()
        dist[row, qi, local] = torch.minimum(
            dist[row, qi, local],
            torch.where(q_valid_m, 0.0, INF))
        active = torch.isfinite(dist) & q_valid[None, :, None]
    if cfg.prune_offline_passes > 0:
        pruned = trishla.prune_offline(sh.loc_w, sh.cut_w, sh.tri_uj,
                                       sh.tri_ui, sh.tri_ij, sh.tri_valid,
                                       cfg.prune_offline_passes)
    else:
        pruned = torch.zeros((R, sh.e_loc + sh.e_cut), dtype=torch.bool,
                             device=dev)
    zero = torch.zeros((R, nq), dtype=torch.int32, device=dev)
    ex = phases.resolve("exchange", cfg.exchange)
    incoming = front_any = None
    if _round_mode(sh, cfg) == "fused":
        # an all-+inf batch makes round 0's merge the identity (the base
        # case of the fused round's equality with the staged one)
        shape = ((R, nq, block) if ex.dense
                 else (R, nq, P, sh.bucket_cap))
        incoming = torch.full(shape, INF, device=dev)
        front_any = active.any(-1)
    fstate = None
    if cfg.fault_plan is not None:
        n_msgs = block if ex.dense else P * sh.bucket_cap
        fstate = faults_mod.init_state(cfg.fault_plan, nq, n_msgs, R, dev)
    toka2 = None
    if cfg.toka == "toka2":
        toka2 = toka_mod.toka2_init(
            torch.arange(sh.row0, sh.row0 + R, dtype=torch.int32,
                         device=dev)[:, None], nq)
    return _Carry(
        dist=dist, active=active, pruned=pruned,
        tri_cursor=torch.zeros((R,), dtype=torch.int32, device=dev),
        last_sent=torch.full((R, nq, sh.n_slots), INF, device=dev),
        done=(~q_valid)[None, :].expand(R, nq).clone(),
        rounds=0, q_rounds=zero, relaxations=zero, msgs_sent=zero,
        msgs_recv=zero,
        comm_bytes=torch.zeros((), dtype=torch.int32, device=dev),
        streak=zero, stale=zero, resent=zero,
        overlap=torch.zeros((), dtype=torch.int32, device=dev),
        toka2=toka2, incoming=incoming, front_any=front_any,
        inflight=(ex.init_inflight(sh, nq, cfg) if ex.deferred else None),
        faults=fstate)


def certificate_improved(sh: SsspShards, dist, comm):
    """Fixpoint certificate: one unmasked relaxation of EVERY edge (local
    and cut, ignoring frontiers, ``last_sent`` and Trishla pruning), the
    cut edges' candidates delivered by ``comm.exchange_pmin`` and the
    verdict agreed by ``comm.all_any``: one pmin and one or-reduce on the
    wire under the shmap backend. ``dist`` [R, K, block] -> improved [K]
    bool (True = NOT at the fixpoint)."""
    R, K, block = dist.shape
    cand = take_fill(dist, sh.loc_src[:, None, :], INF) + sh.loc_w[:, None, :]
    new = scatter_min_drop(dist, sh.loc_dst[:, None, :], cand)
    d_cut = take_fill(dist, sh.cut_src[:, None, :], INF) + sh.cut_w[:, None, :]
    slot_val = scatter_min_drop(
        torch.full((R, K, sh.n_slots), INF, device=dist.device),
        sh.cut_seg[:, None, :], d_cut)
    slot_val = torch.where(sh.slot_valid[:, None, :], slot_val, INF)
    # dense [R, K, P_owner, block] rows addressed by (owner, dst_local),
    # then the per-owner min over senders
    incoming = comm.exchange_pmin(_scatter_dense(sh, slot_val, block))
    merged = torch.minimum(new, incoming)
    return comm.all_any((merged < dist).any(-1))[0]


def certificate_improved_sim(sh: SsspShards, dist):
    """``certificate_improved`` over the stacked sim state: ``dist``
    [P, K, block] -> improved [K] bool."""
    return certificate_improved(sh, dist, SimComm(sh.n_parts, dist.device))


def build_shmap_certificate(sh: SsspShards, comm: ShmapComm, on_trace=None):
    """``fn(dist [1, K, block]) -> improved [K]``, the certificate on a
    rank's shard (one pmin and one or-reduce). ``on_trace(K)`` is called
    on the first run of each K, the engine's ``cert_traces``."""
    seen: set[int] = set()

    def run(dist):
        k = int(dist.shape[1])
        if on_trace is not None and k not in seen:
            seen.add(k)
            on_trace(k)
        return certificate_improved(sh, dist, comm)

    return run


def _shmap_stats(comm: ShmapComm, carry: _Carry, dpr: int) -> SsspStats:
    """The solve's ``SsspStats`` on every rank, as the sim engine totals
    them over the stack: the counters summed over ranks in int32 (one
    all-reduce for all of them and ``q_relaxations``), ``q_rounds`` the max
    over ranks (the sim's max over shards); ``rounds`` and
    ``overlap_rounds`` are agreed every round already."""
    i32 = torch.int32
    local = torch.stack([
        carry.relaxations.sum(dtype=i32), carry.msgs_sent.sum(dtype=i32),
        carry.msgs_recv.sum(dtype=i32), carry.pruned.sum(dtype=i32),
        carry.stale.sum(dtype=i32), carry.resent.sum(dtype=i32),
        carry.comm_bytes.to(i32)])
    tot = comm.total(torch.cat([local, carry.relaxations.sum(0, dtype=i32)]))
    tot = tot.cpu().numpy()
    q_rounds = comm.max_all(carry.q_rounds.amax(0)).cpu().numpy()
    return SsspStats(
        rounds=np.int32(carry.rounds), relaxations=tot[0],
        msgs_sent=tot[1], msgs_recv=tot[2], pruned_edges=tot[3],
        q_rounds=q_rounds, q_relaxations=tot[7:],
        q_converged=carry.done[0].cpu().numpy(), stale_merges=tot[4],
        resends=tot[5], n_dispatches=np.int32(carry.rounds * dpr),
        overlap_rounds=np.int32(int(carry.overlap)), bytes_moved=tot[6])


def build_shmap_solver_traced(sh: SsspShards, cfg: SsspConfig,
                              comm: ShmapComm, on_trace=None,
                              warm: bool = False):
    """A rank's solver of the shmap backend: ``fn(sources [K], q_valid [K]
    [, land [1, L, block]]) -> (dist [1, K, block], stats)`` on the rank's
    one-shard stack ``sh`` (``SsspShards.shard``), every rank calling it
    with the same batch. The round loop is the sim's (``make_round`` over
    ``comm``); every rank leaves it on the same round, since ``done`` is
    agreed by the detector's collectives. ``stats`` are the global totals
    (``_shmap_stats``), the same on every rank.

    The port runs eagerly (engine.py docstring): a "trace" is the first
    run of a K, or of a (K, L) on the warm solver, and calls
    ``on_trace(K)``. ``warm=True`` takes the sharded landmark rows and
    seeds through the ``warm_init`` stage's ``seed_shard`` (one [L, K]
    all-reduce min)."""
    warm_stage = phases.resolve("warm_init", cfg.warm_start) if warm else None
    if warm and warm_stage.seed_shard is None:
        raise ValueError(
            f"warm=True needs a seeding warm_init backend; "
            f"cfg.warm_start={cfg.warm_start!r} does not seed")
    round_fn = make_round(sh, cfg, comm)
    fin = make_finalize(sh, cfg, comm)
    dpr = dispatches_per_round(sh, cfg)
    seen: set = set()

    def run(sources, q_valid, land=None):
        dev = sh.device
        sources = torch.as_tensor(sources, dtype=torch.int32, device=dev)
        q_valid = torch.as_tensor(q_valid, dtype=torch.bool, device=dev)
        key = (int(sources.shape[0]),) + ((int(land.shape[1]),) if warm
                                          else ())
        if key not in seen:
            seen.add(key)
            if on_trace is not None:
                on_trace(key[0])
        seed = None
        if warm:
            seed = warm_stage.seed_shard(land, sources, q_valid, comm.r,
                                         sh.block, comm.min_all)
        carry = init_carry(sh, sources, cfg, q_valid=q_valid,
                           seed_dist=seed)
        while carry.rounds < cfg.max_rounds:
            carry = round_fn(carry)
            if bool(carry.done.all()):          # one host sync a round
                break
        dist = carry.dist if fin is None else fin(carry)
        return dist, _shmap_stats(comm, carry, dpr)

    return run


# --------------------------------------------------------------------------
# legacy entry points (the reference's deprecated wrappers): each call
# rides the cached engine of (shards, cfg, device), so repeated calls
# reuse its buckets. Prefer SsspEngine.build(...).solve(sources).
# --------------------------------------------------------------------------

def _as_sources(source_or_sources, n_vertices: int | None = None
                ) -> tuple[int, ...]:
    if isinstance(source_or_sources, (int, np.integer)):
        sources = (int(source_or_sources),)
    else:
        sources = tuple(int(s) for s in source_or_sources)
    if n_vertices is not None:
        for s in sources:
            # an out-of-range id would be dropped by the init scatter
            # (an all-+inf row) or land on a padding vertex
            if not 0 <= s < n_vertices:
                raise ValueError(
                    f"source {s} out of range [0, {n_vertices})")
    return sources


def solve_sim_batch(sh: SsspShards, sources: Sequence[int],
                    cfg: SsspConfig = SsspConfig(), *, device=None):
    """K sources on the ``sim`` backend, through ``engine_for``. Returns
    (dist [K, n_vertices], SsspStats with per-query q_rounds and
    q_relaxations [K])."""
    from repro_torch.core.engine import engine_for
    res = engine_for(sh, cfg, "sim", device=device).solve(sources)
    return res.dist, res.stats


def solve_sim(sh: SsspShards, source: int, cfg: SsspConfig = SsspConfig(),
              *, device=None):
    """One source: a K=1 batch of ``solve_sim_batch``."""
    dist, stats = solve_sim_batch(sh, (int(source),), cfg, device=device)
    return dist[0], stats


def build_shmap_solver(sh: SsspShards, cfg: SsspConfig, mesh, axis_names,
                       source, *, device=None):
    """A ``fn() -> (dist [1, K, block], stats)`` handle of the rank's solve
    of ``source`` (an int or a batch; K = its length, no padding), on the
    cached shmap engine of ``(sh, cfg, mesh, axis_names, device)``."""
    from repro_torch.core.engine import engine_for
    sources = _as_sources(source, sh.n_vertices)
    eng = engine_for(sh, cfg, "shmap", mesh, axis_names, device=device)
    srcs = np.asarray(sources, np.int32)
    q_valid = np.ones((len(sources),), bool)
    return lambda: eng.shmap_solver(srcs, q_valid)


def solve_shmap_batch(sh: SsspShards, sources: Sequence[int],
                      cfg: SsspConfig, mesh, axis_names, *, device=None):
    """K sources on the ``shmap`` backend (every rank calls it with the
    same arguments), through ``engine_for``. Returns (dist [K,
    n_vertices], stats), the same on every rank."""
    from repro_torch.core.engine import engine_for
    res = engine_for(sh, cfg, "shmap", mesh, axis_names,
                     device=device).solve(sources)
    return res.dist, res.stats


def solve_shmap(sh: SsspShards, source: int, cfg: SsspConfig, mesh,
                axis_names, *, device=None):
    """One source: a K=1 batch of ``solve_shmap_batch``."""
    dist, stats = solve_shmap_batch(sh, (int(source),), cfg, mesh,
                                    axis_names, device=device)
    return dist[0], stats
