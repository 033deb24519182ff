"""SP-Async round (paper Algorithm 2) on the single-device ``sim`` backend,
batched over a query axis.

Port of the staged round of the reference's ``core/sssp.py``. All P shards
are stacked on one device (the reference's ``sim`` backend, which on one
GPU is the production path): per-shard state is ``[P, K, ...]`` and the
exchange is a transpose. One round:

  1. *Local phase*: every shard with a live frontier in any query runs its
     local solver to a fixpoint; idle shards evaluate a chunk of Trishla
     triangle candidates instead (only they advance their cursor).
  2. *Send phase*: cut-edge candidates are min-reduced per message slot,
     masked against ``last_sent``, and routed into the bucketed
     ``[P, K, P, C]`` payload.
  3. *Exchange*: ``SimComm.exchange_bucket``, a transpose of the shard axes.
  4. *Merge phase*: incoming messages scatter-min into ``dist``; improved
     vertices form the next frontier.
  5. *Termination*: a query is done once no shard has a frontier for it
     (toka0), or, with toka1, also once every shard has received at least
     P x its inter-partition edge count of messages for it.

``round="fused"`` rotates that chain so the three tiled phases land in one
kernel launch (``kernels/round``): round r merges the messages delivered in
round r-1 (held un-merged in ``carry.incoming``), chases the frontier to
the local fixpoint and packs the sends, then exchanges; receives and the
termination view are accounted at delivery time, so every counter and
detector sees the staged sequence. Two dispatches per round instead of
four.

Phase backends resolve through ``core/phases.py`` from the reference's
config names: ``xla`` is plain PyTorch ops, ``pallas`` the hand-written
CUDA kernel (its plain PyTorch version on CPU tensors).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import phases, trishla
from repro_torch.core import local_solver  # noqa: F401  (registers the solvers)
from repro_torch.core import warmstart  # noqa: F401  (registers warm_init)
from repro_torch.core.shards import SsspShards
from repro_torch.core.toka import toka1_vote
from repro_torch.kernels.common import INF, scatter_min_drop, take_fill
from repro_torch.kernels.merge import merge_scatter
from repro_torch.kernels.round import fused_round_pallas, fused_round_rescue
from repro_torch.kernels.send import send_pack, send_payload_bucket


@dataclasses.dataclass(frozen=True)
class SsspConfig:
    """The reference's config fields and values. Values this package has
    not ported raise ``NotImplementedError`` naming their ROADMAP item;
    ``pallas_interpret`` is accepted and has no effect."""
    exchange: str = "bucket"
    toka: str = "toka0"
    async_lag: int = 1
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
    faults: Any = None
    toka3_safety: float = 2.0

    def __post_init__(self):
        phases.validate("exchange", self.exchange)
        phases.validate("toka", self.toka)
        phases.validate("local_solver", self.local_solver)
        phases.validate("send", self.send_backend)
        phases.validate("merge", self.merge_backend)
        phases.validate("round", self.round)
        phases.validate("warm_init", self.warm_start)
        if self.faults is not None:
            raise NotImplementedError(
                "fault injection is not ported yet: ROADMAP Queue 1 item 7")
        if self.async_lag != 1:
            raise ValueError("async_lag only applies to the deferred "
                             "exchanges, which are not ported yet")
        if self.pallas_sweeps < 1:
            raise ValueError("pallas_sweeps must be >= 1")


class SsspStats(NamedTuple):
    rounds: Any              # outer rounds until the LAST query converged
    relaxations: Any         # total edge relaxations (TEPS numerator)
    msgs_sent: Any
    msgs_recv: Any
    pruned_edges: Any
    q_rounds: Any = None       # [K] rounds each query was live
    q_relaxations: Any = None  # [K] edge relaxations per query
    q_converged: Any = None    # [K] certified-converged mask
    stale_merges: Any = None   # 0: no deferred exchange or faults here
    resends: Any = None        # 0: no anti-entropy here
    n_dispatches: Any = None   # data-plane dispatches (rounds x 4)
    overlap_rounds: Any = None  # 0: synchronous exchange
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
    incoming: torch.Tensor | None = None   # fused: [P, K, P, C] delivered,
                                           # not yet merged
    front_any: torch.Tensor | None = None  # fused: [P, K] a frontier bit
                                           # next round


# --------------------------------------------------------------------------
# phases (stacked over shards)
# --------------------------------------------------------------------------

def _prune_idle(sh: SsspShards, idle, pruned, cursor, cfg):
    """A Trishla chunk on the idle shards ([P] bool) only, the reference's
    ``lax.cond``: only they advance their pruned mask and cursor."""
    if not cfg.prune_online:
        return pruned, cursor
    w_all = torch.cat([sh.loc_w, sh.cut_w], dim=1)
    new_pruned, new_cursor, _ = trishla.prune_chunk(
        w_all, pruned, cursor, sh.tri_uj, sh.tri_ui, sh.tri_ij, sh.tri_valid,
        cfg.tri_chunk)
    return (torch.where(idle[:, None], new_pruned, pruned),
            torch.where(idle, new_cursor, cursor))


def _phase_local(sh: SsspShards, dist, active, pruned, cursor, cfg):
    """Busy shards (a frontier in any query) solve; idle shards run a
    Trishla chunk instead, the branches of the reference's ``lax.cond``.
    Returns (dist, pruned, cursor, relaxations [P, K])."""
    solve = phases.resolve("local_solver", cfg.local_solver)
    res = solve(dist, active, sh, pruned[:, :sh.e_loc],
                max_iters=cfg.local_iters, sweeps=cfg.pallas_sweeps,
                delta=cfg.delta)
    # an idle shard has no frontier, so its solve above was a no-op
    idle = ~active.flatten(1).any(-1)                       # [P]
    pruned, cursor = _prune_idle(sh, idle, pruned, cursor, cfg)
    return res.dist, pruned, cursor, res.relaxations


def _bucket_payload(sh: SsspShards, send_val):
    """Masked slot values [P, K, S] -> bucketed payload [P, K, P, C] by a
    scatter-min at the static (slot_owner, slot_pos) positions."""
    P, K, _ = send_val.shape
    C = sh.bucket_cap
    flat = (sh.slot_owner.long() * C + sh.slot_pos.long())[:, None, :]
    payload = torch.full((P, K, P * C), INF, device=send_val.device)
    payload.scatter_reduce_(-1, flat.expand(P, K, -1), send_val, "amin")
    return payload.reshape(P, K, P, C)


@phases.register("send", "xla")
def _phase_send_xla(sh: SsspShards, dist, pruned, last_sent):
    """Per-slot segment-min of the cut-edge candidates + improvement
    masking. Returns (payload [P, K, P, C], last_sent' [P, K, S], sends
    [P, K])."""
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
    return _bucket_payload(sh, send_val), new_last, sends


@phases.register("send", "pallas")
def _phase_send_pallas(sh: SsspShards, dist, pruned, last_sent):
    """Slot-tiled send kernel over ``sh.tx_*`` (dense, or ragged when the
    layout carries its chunk->tile map): segment-min, masking and counts in
    one launch; the payload scatter is the static gather through
    ``tx_payload_slot``."""
    lay = sh.send_layout
    src_t, w_t, segrel_t, eid_t = lay[:4]
    P = eid_t.shape[0]
    pruned_t = take_fill(pruned[:, sh.e_loc:].to(torch.int32),
                         eid_t.reshape(P, -1), 0).reshape(eid_t.shape)
    send_val, new_last, sends = send_pack(
        dist, last_sent, sh.slot_valid, src_t, w_t, segrel_t, pruned_t,
        sb=sh.tx_sb, ctile=lay[4] if len(lay) == 5 else None,
        bounds=sh.send_bounds)
    return send_payload_bucket(send_val, sh.tx_payload_slot), new_last, sends


@phases.register("merge", "xla")
def _phase_merge_xla(sh: SsspShards, dist, incoming):
    """Scatter-min of the incoming [P, K, P, C] messages through
    ``recv_idx`` (sentinel ``block`` dropped). Returns (dist', new_active,
    recvs [P, K])."""
    P, K = dist.shape[:2]
    flat_val = incoming.reshape(P, K, -1)
    new = scatter_min_drop(dist, sh.recv_idx.reshape(P, 1, -1), flat_val)
    recvs = torch.isfinite(flat_val).sum(-1, dtype=torch.int32)
    return new, new < dist, recvs


@phases.register("merge", "pallas")
def _phase_merge_pallas(sh: SsspShards, dist, incoming):
    """Msg-tiled merge kernel over ``sh.mx_*`` (dense, or ragged when the
    layout carries its chunk->tile map): scatter-min, next frontier and
    receive counts in one launch."""
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
    """Exchange and reductions on shard-stacked [P, ...] arrays."""

    @staticmethod
    def exchange_bucket(payload):
        """[P_src, K, P_dst, C] -> [P_dst, K, P_src, C]."""
        return payload.transpose(0, 2)

    @staticmethod
    def all_all(flag):
        """AND over the shard axis, broadcast back to every shard."""
        return flag.all(0, keepdim=True).expand_as(flag)


phases.register("exchange", "bucket")(SimComm.exchange_bucket)
phases.register("round", "staged")("staged")
phases.register("round", "fused")("fused")


# Termination stages: the reference's arguments, the carry before the
# round, this round's termination view of the frontier and its per-shard
# [P, K] send and receive counts, and the shards' inter-edge counts [P];
# each returns the [P, K] done mask of this round.

def _quiescent(comm: SimComm, new_active):
    """[P, K]: no shard has a live frontier for the query."""
    return comm.all_all(~new_active.any(-1))


@phases.register("toka", "toka0")
def _toka0_stage(comm: SimComm, carry, new_active, sends, recvs,
                 inter_edges):
    return _quiescent(comm, new_active)


@phases.register("toka", "toka1")
def _toka1_stage(comm: SimComm, carry, new_active, sends, recvs,
                 inter_edges):
    """Quiescence, or every shard's running receive count past P x its
    inter-edge count. The reference's ``msg_count`` is the running sum of
    ``recvs``, which is the carry's ``msgs_recv``: it is read here rather
    than kept twice."""
    vote = toka1_vote(carry.msgs_recv + recvs, inter_edges[:, None],
                      inter_edges.shape[0])
    return _quiescent(comm, new_active) | comm.all_all(vote)


# --------------------------------------------------------------------------
# round, init and certificate
# --------------------------------------------------------------------------

def _round_mode(sh: SsspShards, cfg: SsspConfig) -> str:
    """Resolved round pipeline. The reference degrades ``round="fused"`` to
    the staged pipeline when the shards lack a tile layout; the port's
    shards always carry all three, so the config's mode stands."""
    return cfg.round


def dispatches_per_round(sh: SsspShards, cfg: SsspConfig) -> int:
    """Data-plane dispatches per round: the staged pipeline launches 4
    (local solve, send pack, exchange, merge scatter); the fused round 2
    (the fused kernel, exchange)."""
    return 2 if _round_mode(sh, cfg) == "fused" else 4


def _phase_fused(sh: SsspShards, dist, front_in, live, incoming, last_sent,
                 pruned, cfg):
    """One fused kernel launch: merge + local fixpoint + send pack, plus the
    payload gather. Returns (dist, payload [P, K, P, C], last_sent', sends,
    nrel, resid): a non-empty ``resid`` row means ``cfg.pallas_sweeps``
    in-kernel sweeps did not reach the fixpoint, and the caller must rescue
    the round before using the send outputs."""
    P, K = dist.shape[:2]
    new_dist, send_val, new_last, nrel, sends, resid = fused_round_pallas(
        dist, front_in, live, incoming.reshape(P, K, -1), last_sent,
        sh.slot_valid, sh.relax_layout, sh.send_layout, sh.merge_layout,
        pruned[:, :sh.e_loc], pruned[:, sh.e_loc:], vb=sh.rx_vb,
        sb=sh.tx_sb, n_sweeps=cfg.pallas_sweeps, chunks=sh.round_chunks)
    payload = send_payload_bucket(send_val, sh.tx_payload_slot)
    return new_dist, payload, new_last, sends, nrel, resid


def _phase_fused_rescue(sh: SsspShards, dist, resid, last_sent, pruned, cfg):
    """Finish a fused round whose in-kernel sweeps left a residual
    frontier: continue the fixpoint with the relax kernel and re-pack the
    sends against the ORIGINAL ``last_sent``. Returns (dist, payload,
    last_sent', sends, nrel_extra)."""
    new_dist, send_val, new_last, nrel_extra, sends = fused_round_rescue(
        dist, resid, last_sent, sh.slot_valid, sh.relax_layout,
        sh.send_layout, pruned[:, :sh.e_loc], pruned[:, sh.e_loc:],
        vb=sh.rx_vb, sb=sh.tx_sb, n_sweeps=cfg.pallas_sweeps,
        max_iters=cfg.local_iters, send_bounds=sh.send_bounds,
        relax_chunks=sh.relax_chunks)
    payload = send_payload_bucket(send_val, sh.tx_payload_slot)
    return new_dist, payload, new_last, sends, nrel_extra


def _account_delivery(sh: SsspShards, dist, incoming):
    """Receive counts and per-query any-improvement bits of a delivered
    [P, K, P, C] batch against the post-relax distances: the staged merge
    phase's accounting, without merging (the values merge next round). A
    message improves iff it beats the distance at its routed target; the
    sentinel target gathers -inf, never beaten. Returns (any_imp, recvs),
    both [P, K]."""
    P, K = dist.shape[:2]
    flat = incoming.reshape(P, K, -1)
    recvs = torch.isfinite(flat).sum(-1, dtype=torch.int32)
    d_t = take_fill(dist, sh.recv_idx.reshape(P, 1, -1), -INF)
    return (flat < d_t).any(-1), recvs


def make_finalize(sh: SsspShards, cfg: SsspConfig):
    """Exit-time ``fn(carry) -> dist`` merging the delivered-but-unmerged
    batch of a fused solve (the fused round merges a round's delivery in
    the next round, so the loop can exit with one batch outstanding), or
    None for the staged round, which leaves nothing outstanding. The merge
    runs unconditionally: the final distances must not depend on the
    detector's reasoning."""
    if _round_mode(sh, cfg) != "fused":
        return None

    def finalize(carry: _Carry):
        return _phase_merge_xla(sh, carry.dist, carry.incoming)[0]

    return finalize


def _make_round_fused(sh: SsspShards, cfg: SsspConfig):
    """The fused-round variant of ``make_round``. The idle branch (Trishla)
    runs before the kernel, gated per shard, since merge and send run on
    idle rounds too. The rescue runs when any row of the whole stack kept a
    residual frontier. Accounting happens at delivery time, from the
    post-relax distances and the raw delivered batch."""
    comm = SimComm()
    pipe = build_pipeline(sh, cfg)

    def round_fn(carry: _Carry) -> _Carry:
        live = ~carry.done                                  # [P, K]
        idle = ~(carry.front_any & live).any(-1)            # [P]
        pruned, cursor = _prune_idle(sh, idle, carry.pruned,
                                     carry.tri_cursor, cfg)
        # the injected frontier: source bits on round 0, empty thereafter
        front_in = carry.active & live[..., None]
        dist, payload, last_sent, sends, nrel, resid = _phase_fused(
            sh, carry.dist, front_in, live, carry.incoming, carry.last_sent,
            pruned, cfg)
        if bool((resid > 0).any()):
            dist, payload, last_sent, sends, extra = _phase_fused_rescue(
                sh, dist, resid, carry.last_sent, pruned, cfg)
            nrel = nrel + extra
        payload, nbytes = _mask_payload(payload)
        incoming = pipe.exchange(payload).contiguous()   # read twice
        any_imp, recvs = _account_delivery(sh, dist, incoming)
        # toka reads only any(new_active, -1): a [P, K, 1] plane of the
        # any-improvement bits stands in for the staged merge's frontier
        done = pipe.toka(comm, carry, any_imp[..., None], sends, recvs,
                         sh.inter_edges)
        return _Carry(
            dist=dist, active=torch.zeros_like(carry.active), pruned=pruned,
            tri_cursor=cursor, last_sent=last_sent,
            done=carry.done | done, rounds=carry.rounds + 1,
            q_rounds=carry.q_rounds + (~carry.done).to(torch.int32),
            relaxations=carry.relaxations + nrel,
            msgs_sent=carry.msgs_sent + sends,
            msgs_recv=carry.msgs_recv + recvs,
            comm_bytes=carry.comm_bytes + nbytes,
            incoming=incoming, front_any=any_imp)

    return round_fn


class RoundPipeline(NamedTuple):
    """The round's stages, resolved once per (shards, config) from the
    backend registry: ``local``, ``send`` and ``merge`` take the stacked
    shards, ``exchange`` the payload, ``toka`` the termination stage's
    arguments."""
    local: Any
    send: Any
    exchange: Any
    merge: Any
    toka: Any


def build_pipeline(sh: SsspShards, cfg: SsspConfig) -> RoundPipeline:
    """Resolve every phase backend for these shards. The reference's
    fallbacks for shards without tile layouts (ROADMAP Queue 1 item 5b)
    and its fault-injecting exchange (item 7) are not ported: the port's
    shards always carry every layout, and ``SsspConfig`` rejects faults."""
    return RoundPipeline(
        local=partial(_phase_local, cfg=cfg),
        send=phases.resolve("send", cfg.send_backend),
        exchange=phases.resolve("exchange", cfg.exchange),
        merge=phases.resolve("merge", cfg.merge_backend),
        toka=phases.resolve("toka", cfg.toka))


def make_round(sh: SsspShards, cfg: SsspConfig):
    """Returns round(carry) -> carry for the config's round pipeline."""
    if _round_mode(sh, cfg) == "fused":
        return _make_round_fused(sh, cfg)
    comm = SimComm()
    pipe = build_pipeline(sh, cfg)

    def round_fn(carry: _Carry) -> _Carry:
        # finished queries stop relaxing and sending while stragglers run
        act = carry.active & ~carry.done[..., None]
        dist, pruned, cursor, nrel = pipe.local(
            sh, carry.dist, act, carry.pruned, carry.tri_cursor)
        payload, last_sent, sends = pipe.send(sh, dist, pruned,
                                              carry.last_sent)
        payload, nbytes = _mask_payload(payload)
        dist, new_active, recvs = pipe.merge(sh, dist,
                                             pipe.exchange(payload))
        done = pipe.toka(comm, carry, new_active, sends, recvs,
                         sh.inter_edges)
        return _Carry(
            dist=dist, active=new_active, pruned=pruned, tri_cursor=cursor,
            last_sent=last_sent,
            done=carry.done | done, rounds=carry.rounds + 1,
            q_rounds=carry.q_rounds + (~carry.done).to(torch.int32),
            relaxations=carry.relaxations + nrel,
            msgs_sent=carry.msgs_sent + sends,
            msgs_recv=carry.msgs_recv + recvs,
            comm_bytes=carry.comm_bytes + nbytes)

    return round_fn


def init_carry(sh: SsspShards, sources, cfg: SsspConfig,
               q_valid=None, seed_dist=None) -> _Carry:
    """Stacked start state for K sources [K] int32. ``q_valid`` masks padded
    bucket rows: an invalid query starts with no frontier and done=True, so
    it never relaxes, sends or counts.

    ``seed_dist`` [P, K, block] (None: the cold +inf start) holds
    per-vertex upper bounds from a ``warm_init`` stage. The source bit is
    min-scattered to 0 on top of it, and every finitely seeded vertex of a
    valid query starts ACTIVE: a seeded value must still be relaxed from,
    or a neighbour whose shortest path runs through it could stay above
    its true distance. The monotone round then reaches the cold start's
    fixpoint from a closer start."""
    dev = sh.device
    sources = torch.as_tensor(sources, dtype=torch.int32, device=dev)
    nq = sources.shape[0]
    q_valid = (torch.ones(nq, dtype=torch.bool, device=dev) if q_valid is None
               else torch.as_tensor(q_valid, dtype=torch.bool, device=dev))
    P, block = sh.n_parts, sh.block
    owner, local = (sources // block).long(), (sources % block).long()
    qi = torch.arange(nq, device=dev)
    if seed_dist is None:
        dist = torch.full((P, nq, block), INF, device=dev)
        dist[owner, qi, local] = torch.where(q_valid, 0.0, INF)
        active = torch.zeros((P, nq, block), dtype=torch.bool, device=dev)
        active[owner, qi, local] = q_valid
    else:
        dist = seed_dist.clone()
        dist[owner, qi, local] = torch.minimum(
            dist[owner, qi, local],
            torch.where(q_valid, 0.0, INF))
        active = torch.isfinite(dist) & q_valid[None, :, None]
    if cfg.prune_offline_passes > 0:
        pruned = trishla.prune_offline(sh.loc_w, sh.cut_w, sh.tri_uj,
                                       sh.tri_ui, sh.tri_ij, sh.tri_valid,
                                       cfg.prune_offline_passes)
    else:
        pruned = torch.zeros((P, sh.e_loc + sh.e_cut), dtype=torch.bool,
                             device=dev)
    zero = torch.zeros((P, nq), dtype=torch.int32, device=dev)
    incoming = front_any = None
    if _round_mode(sh, cfg) == "fused":
        # an all-+inf batch makes round 0's merge the identity (the base
        # case of the fused round's equality with the staged one)
        incoming = torch.full((P, nq, P, sh.bucket_cap), INF, device=dev)
        front_any = active.any(-1)
    return _Carry(
        dist=dist, active=active, pruned=pruned,
        tri_cursor=torch.zeros((P,), dtype=torch.int32, device=dev),
        last_sent=torch.full((P, nq, sh.n_slots), INF, device=dev),
        done=(~q_valid)[None, :].expand(P, nq).clone(),
        rounds=0, q_rounds=zero, relaxations=zero, msgs_sent=zero,
        msgs_recv=zero,
        comm_bytes=torch.zeros((), dtype=torch.int32, device=dev),
        incoming=incoming, front_any=front_any)


def certificate_improved_sim(sh: SsspShards, dist):
    """Fixpoint certificate over the stacked state: one unmasked relaxation
    of EVERY edge (local and cut, ignoring frontiers, ``last_sent`` and
    Trishla pruning). ``dist`` [P, K, block] -> improved [K] bool (True =
    NOT at the fixpoint)."""
    P, K, block = dist.shape
    cand = take_fill(dist, sh.loc_src[:, None, :], INF) + sh.loc_w[:, None, :]
    new = scatter_min_drop(dist, sh.loc_dst[:, None, :], cand)
    d_cut = take_fill(dist, sh.cut_src[:, None, :], INF) + sh.cut_w[:, None, :]
    slot_val = scatter_min_drop(
        torch.full((P, K, sh.n_slots), INF, device=dist.device),
        sh.cut_seg[:, None, :], d_cut)
    slot_val = torch.where(sh.slot_valid[:, None, :], slot_val, INF)
    # dense [P_src, K, P_owner, block] rows addressed by (owner, dst_local),
    # then the per-owner min over senders
    flat = (sh.slot_owner.long() * block + sh.slot_dstl.long())[:, None, :]
    dense = torch.full((P, K, P * block), INF, device=dist.device)
    dense.scatter_reduce_(-1, flat.expand(P, K, -1), slot_val, "amin")
    incoming = dense.reshape(P, K, P, block).amin(0).transpose(0, 1)
    merged = torch.minimum(new, incoming)
    return (merged < dist).any(-1).any(0)


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
