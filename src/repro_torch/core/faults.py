"""Fault injection for the SP-Async exchange: the paper's robustness claim
made executable (port of the reference's ``core/faults.py``).

The asynchronous mode is safe because the scatter-min merge is monotone and
idempotent: a dropped, delayed, duplicated or reordered message can change
round counts but never the fixpoint. :class:`FaultPlan` describes a message
failure model, and :func:`wrap_exchange` decorates any resolved
``ExchangeStage`` with a receiver-side injector, so every pipeline runs
under faults via ``SsspConfig(faults=FaultPlan(...))``.

Fault model (per message position, per round, receiver side). The draws
come from ``core/prng.py``, equal to ``jax.random``'s bit for bit: one key
per (plan seed, round, receiving shard) by ``fold_in``, so a seeded run
replays the reference's faults exactly. Each finite incoming value draws
one uniform and lands in one regime:

- ``drop``: the message is lost. If it would have improved the receiver
  (``val < d_target``) the loss matters and latches ``unhealed`` until the
  next anti-entropy resend retransmits every ``last_sent`` minimum
  (``FaultPlan.resend_period``; the resend is wired in ``core/sssp.py``).
- ``delay``: the message is withheld into a bounded queue (depth
  ``max_delay``) at a random slot, and re-merges 1..max_delay rounds later.
- ``duplicate``: delivered now and a copy queued at the head slot.
- ``reorder``: withheld and queued at the head slot, so it arrives one round
  late, after messages sent a round later.

The queue's oldest slot is released every round and min-merged with the
fresh deliveries: position ``m`` always addresses the same destination, so
the release is a stale scatter-min merge. ``pending`` reports, per query,
whether the shard still holds undelivered state (a non-empty queue, or an
unhealed drop when anti-entropy is on); the round ORs it into the
termination view, so no detector declares quiescence over it.

Every function here runs on a stack of R shards (all P under the sim
backend, a rank's one under shmap): the state is ``[R, D, K, M]`` and
``[R, K]``, the draws ``[R, K, M]`` under ``[R, 2]`` keys, one a shard
id. The queue, the latches and the draws stay on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels.common import INF, take_fill

_PROBS = ("drop", "delay", "duplicate", "reorder")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Message failure model and recovery knobs (hashable: it rides in
    ``SsspConfig``).

    ``drop``/``delay``/``duplicate``/``reorder`` are per-message
    probabilities of disjoint regimes, summing to at most 1. ``seed`` roots
    the per-round stream. ``max_delay`` bounds the delay queue.
    ``resend_period > 0`` turns on anti-entropy: every N-th round senders
    retransmit all their ``last_sent`` minima for the queries some receiver
    lost an improvement on; with ``resend_period=0`` drops are permanent and
    the engine's certificate reports the solve ``degraded``."""

    drop: float = 0.0
    delay: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    seed: int = 0
    max_delay: int = 3
    resend_period: int = 0

    def __post_init__(self):
        for name in _PROBS:
            p = float(getattr(self, name))
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"FaultPlan.{name}={p!r} must be in [0, 1]")
        total = sum(float(getattr(self, n)) for n in _PROBS)
        if total > 1.0:
            raise ValueError(
                f"FaultPlan probabilities sum to {total:.3f} > 1 (each "
                "message lands in exactly one fault regime)")
        if self.max_delay < 1:
            raise ValueError("FaultPlan.max_delay must be >= 1")
        if self.resend_period < 0:
            raise ValueError("FaultPlan.resend_period must be >= 0")

    @property
    def active(self) -> bool:
        """Any fault probability non-zero (an all-zero plan is the
        fault-free pipeline)."""
        return any(float(getattr(self, n)) > 0.0 for n in _PROBS)

    @property
    def fault_slack(self) -> int:
        """Extra rounds toka3's timeout must absorb: a message can hide in
        the queue for ``max_delay`` rounds, and a mattering drop is healed
        ``resend_period`` rounds later at the latest."""
        return int(self.max_delay) + int(self.resend_period)

    def thresholds(self) -> tuple[float, float, float, float]:
        """The regimes' cumulative bounds: summed in float64 as the
        reference sums them, then rounded to f32 once, as JAX rounds a
        Python float it compares with an f32 draw. A bound that is exact in
        f32 compares the same in any wider type."""
        p0 = self.drop
        p1 = p0 + self.delay
        p2 = p1 + self.duplicate
        return tuple(float(np.float32(p)) for p in (p0, p1, p2,
                                                     p2 + self.reorder))


class FaultState(NamedTuple):
    """In-carry fault state of the stacked shards. ``queue[p, d, k, m]``
    holds a withheld value for query ``k`` at flat payload position ``m``
    of shard ``p``, due in ``d + 1`` rounds (+inf = empty);
    ``unhealed[p, k]`` latches a dropped improvement until the next
    resend."""
    queue: torch.Tensor     # [P, D, K, M] f32
    unhealed: torch.Tensor  # [P, K] bool


def init_state(plan: FaultPlan, nq: int, n_msgs: int,
               n_parts: int | None = None, device=None) -> FaultState:
    """Empty fault state for ``nq`` queries and ``n_msgs`` payload
    positions a query: one shard's (``queue`` [D, K, M], ``unhealed``
    [K]) when ``n_parts`` is None, as the reference's, else the stack of
    ``n_parts`` shards."""
    lead = () if n_parts is None else (n_parts,)
    return FaultState(
        queue=torch.full(lead + (plan.max_delay, nq, n_msgs), INF,
                         device=device),
        unhealed=torch.zeros(lead + (nq,), dtype=torch.bool, device=device))


def round_keys(plan: FaultPlan, rounds: int, ranks, device=None
               ) -> torch.Tensor:
    """The [R, 2] keys of round ``rounds``, one a shard of ``ranks`` (an
    int P: shards 0..P-1; a rank of the shmap backend passes its own):
    ``fold_in(fold_in(prng_key(seed), rounds), rank)``, hashed on the host
    (a few words) and copied without a stream sync."""
    rkey = prng.fold_in(prng.prng_key(plan.seed), rounds)
    if isinstance(ranks, int):
        ranks = range(ranks)
    keys = [prng.fold_in(rkey, r) for r in ranks]
    return torch.tensor(keys, dtype=torch.int64).to(device, non_blocking=True)


def inject(plan: FaultPlan, incoming, d_target, state: FaultState, key):
    """One round of receiver-side faults over flattened messages
    ``incoming`` [P, K, M]. ``d_target`` [P, K, M] is the receiver's
    distance at each message's destination (+inf for unaddressed
    positions): it decides whether a drop mattered and whether a released
    value is a real (improving) stale merge. ``key`` [P, 2]: a shard's
    key a row.

    One shard's call, the reference's form, passes ``incoming`` and
    ``d_target`` [K, M], its state (``init_state`` with no ``n_parts``)
    and one key (a [2] tensor or a pair of ints, ``prng.fold_in``'s); it
    draws what the stack's row of that key draws.

    Returns ``(delivered [P, K, M], state', stale [P, K] int32,
    pending [P, K] bool)``, without the leading [P] for one shard;
    ``delivered`` already min-merges this round's queue release."""
    if incoming.dim() == 2:
        one = FaultState(queue=state.queue[None],
                         unhealed=state.unhealed[None])
        out, st, stale, pending = inject(
            plan, incoming[None], d_target[None], one,
            torch.as_tensor(key, dtype=torch.int64,
                            device=incoming.device).reshape(1, 2))
        return (out[0], FaultState(queue=st.queue[0],
                                   unhealed=st.unhealed[0]), stale[0],
                pending[0])
    kmode, kslot = prng.split(key)
    shape = tuple(incoming.shape[1:])
    u = prng.uniform(kmode, shape)
    finite = torch.isfinite(incoming)
    p0, p1, p2, p3 = plan.thresholds()
    m_drop = finite & (u < p0)
    m_delay = finite & (p0 <= u) & (u < p1)
    m_dup = finite & (p1 <= u) & (u < p2)
    m_reorder = finite & (p2 <= u) & (u < p3)

    now = torch.where(m_drop | m_delay | m_reorder, INF, incoming)

    # release the oldest slot, age the rest, enqueue this round's delayed
    # (at a random slot), duplicated and reordered values (at the head)
    D = state.queue.shape[1]
    release = state.queue[:, 0]
    enq = m_delay | m_dup | m_reorder
    if plan.delay > 0:
        slot = torch.where(m_delay, prng.randint(kslot, shape, 0, D), 0)
    else:
        slot = torch.zeros_like(incoming, dtype=torch.int32)
    queue = torch.empty_like(state.queue)
    for d in range(D):
        # slot d: what this round enqueues at d, and slot d + 1 aged
        enq_d = torch.where(enq & (slot == d), incoming, INF)
        queue[:, d] = (enq_d if d + 1 == D
                       else torch.minimum(enq_d, state.queue[:, d + 1]))

    delivered = torch.minimum(now, release)
    stale = (torch.isfinite(release) & (release < d_target)).sum(
        -1, dtype=torch.int32)
    # a lost message matters only while it would still improve the
    # receiver; distances only fall, so once it stops it never matters again
    lost = m_drop & (incoming < d_target)
    unhealed = state.unhealed | lost.any(-1)
    pending = torch.isfinite(queue).any(-1).any(1)
    if plan.resend_period > 0:
        # anti-entropy will heal the drop: hold termination open for it;
        # without resend the drop is permanent and the certificate says so
        pending = pending | unhealed
    return (delivered, FaultState(queue=queue, unhealed=unhealed), stale,
            pending)


class FaultyExchange(NamedTuple):
    """An ``ExchangeStage`` decorated with fault delivery: ``run`` and the
    deferred protocol (``deferred``/``recv``/``push``/``init_inflight``/
    ``flush``) pass through untouched; ``deliver(sh, dist, incoming, state,
    keys) -> (incoming', state', stale, pending)`` is the injector the round
    applies to whatever the exchange delivered. Under a deferred exchange it
    applies when a lagged batch leaves the in-flight buffer, so a resent
    copy rides the pipe and heals ``lag`` rounds later."""
    name: str
    dense: bool
    run: Any
    plan: FaultPlan
    deliver: Any
    deferred: bool = False
    recv: Any = None
    push: Any = None
    init_inflight: Any = None
    flush: Any = None


def wrap_exchange(stage, plan: FaultPlan) -> FaultyExchange:
    """Decorate a resolved exchange stage with receiver-side injection
    under ``plan``. Dense incoming rows [P, K, block] are owner-addressed,
    so ``d_target`` is the local distance row itself; bucketed incoming
    [P, K, P, C] flattens to message positions whose targets come from
    ``recv_idx``, the sentinel ``block`` gathering +inf."""
    if stage.dense:
        def deliver(sh, dist, incoming, state, keys):
            return inject(plan, incoming, dist, state, keys)
    else:
        def deliver(sh, dist, incoming, state, keys):
            P, K = dist.shape[:2]
            flat = incoming.reshape(P, K, -1)
            d_t = take_fill(dist, sh.recv_idx.reshape(P, 1, -1), INF)
            out, st, stale, pending = inject(plan, flat, d_t, state, keys)
            return out.reshape(incoming.shape), st, stale, pending

    return FaultyExchange(name=f"{stage.name}+faults", dense=stage.dense,
                          run=stage.run, plan=plan, deliver=deliver,
                          deferred=stage.deferred, recv=stage.recv,
                          push=stage.push, init_inflight=stage.init_inflight,
                          flush=stage.flush)
