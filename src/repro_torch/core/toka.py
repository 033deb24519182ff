"""Termination detectors (port of the reference's ``core/toka.py``).

- ``toka1``'s vote (paper Algorithm 4): stop once a shard has received
  ``n_parts * inter_edges`` messages.
- ``toka2`` (paper Algorithm 5): the Dijkstra-Feijen-van Gasteren / Safra
  token ring. Shards are white or black and count sent minus received
  messages; a (state, count, hops) token moves one hop a round around the
  shard ring; a full white circuit with a zero count turns it red, and the
  run ends once every shard has seen red.
- ``toka3`` (the paper's timeout): stop after ``toka3_bound`` consecutive
  rounds with no global activity.

The reference runs one detector per shard and query, vmapped; here every
state field is a ``[P, K]`` tensor of the stacked shards, so the functions
are elementwise and ``rank`` is ``[P, 1]``. Integer fields are int32 and
flags bool, as in the reference.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

WHITE, BLACK, RED = 0, 1, 2


class Toka2State(NamedTuple):
    color: torch.Tensor      # [P, K] int32 (WHITE/BLACK)
    count: torch.Tensor      # [P, K] int32 (recv - send, cumulative)
    has_token: torch.Tensor  # [P, K] bool
    tok_state: torch.Tensor  # [P, K] int32
    tok_count: torch.Tensor  # [P, K] int32
    tok_hops: torch.Tensor   # [P, K] int32
    seen_red: torch.Tensor   # [P, K] bool


class Token(NamedTuple):
    present: torch.Tensor
    state: torch.Tensor
    count: torch.Tensor
    hops: torch.Tensor


def empty_token(device=None) -> Token:
    """No token: absent, white, zero count and hops (0-d tensors)."""
    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    return Token(torch.tensor(False, device=device), i32(WHITE), i32(0),
                 i32(0))


def toka2_init(rank, nq: int | None = None) -> Toka2State:
    """K token-ring states a shard, ``rank`` [P, 1]: shard 0 holds all K
    tokens. With no ``nq``, the reference's form: one state of ``rank``'s
    shape (a scalar rank: a state of scalars)."""
    rank = torch.as_tensor(rank)
    shape = tuple(rank.shape) if nq is None else (rank.shape[0], nq)
    zero = torch.zeros(shape, dtype=torch.int32, device=rank.device)
    return Toka2State(
        color=zero, count=zero, has_token=(rank == 0).expand(shape).clone(),
        tok_state=zero, tok_count=zero, tok_hops=zero,
        seen_red=torch.zeros(shape, dtype=torch.bool, device=rank.device))


def toka2_account(state: Toka2State, sends, recvs) -> Toka2State:
    """Per-round accounting: blacken and count down on a send, count up on
    a receive."""
    sends = sends.to(torch.int32)
    recvs = recvs.to(torch.int32)
    color = torch.where(sends > 0, BLACK, state.color)
    return state._replace(color=color, count=state.count - sends + recvs)


def toka2_forward(state: Toka2State, rank, idle, *, n_parts: int
                  ) -> tuple[Toka2State, Token]:
    """Whether and what each shard forwards this round. Returns (state',
    outgoing)."""
    is_init = rank == 0
    holder = state.has_token

    # a red token: marked seen, always forwarded (the run is quiescent)
    red_case = holder & (state.tok_state == RED)
    # the initiator with a returned token (a full circuit), locally idle
    returned = (holder & is_init & idle & (state.tok_hops >= n_parts)
                & ~red_case)
    terminate = (returned & (state.tok_state == WHITE)
                 & ((state.tok_count + state.count) == 0)
                 & (state.color == WHITE))
    reinit = returned & ~terminate
    # the initiator launching the first probe (hops == 0), idle
    launch = holder & is_init & idle & (state.tok_hops == 0) & ~red_case
    # an ordinary shard forwarding: merge color and count, reset to white
    ordinary = holder & ~is_init & idle & ~red_case
    forwarding = red_case | terminate | reinit | launch | ordinary

    zero = torch.zeros_like(state.tok_count)
    out_state = torch.where(
        red_case | terminate, RED,
        torch.where(reinit | launch, WHITE,
                    torch.maximum(state.tok_state, state.color)))
    out_count = torch.where(red_case | terminate | reinit | launch, zero,
                            state.tok_count + state.count)
    out_hops = torch.where(terminate | reinit | launch, zero + 1,
                           state.tok_hops + 1)
    outgoing = Token(present=forwarding, state=out_state, count=out_count,
                     hops=out_hops)
    # forwarding resets the shard to white (DFG) and gives the token away
    new_state = state._replace(
        color=torch.where(ordinary | reinit | launch, WHITE, state.color),
        has_token=holder & ~forwarding,
        seen_red=(state.seen_red | (holder & (state.tok_state == RED))
                  | terminate))
    return new_state, outgoing


def toka2_absorb(state: Toka2State, incoming: Token) -> Toka2State:
    """Adopt an incoming token (at most one is live in the ring)."""
    take = incoming.present
    return state._replace(
        has_token=state.has_token | take,
        tok_state=torch.where(take, incoming.state, state.tok_state),
        tok_count=torch.where(take, incoming.count, state.tok_count),
        tok_hops=torch.where(take, incoming.hops, state.tok_hops),
        seen_red=state.seen_red | (take & (incoming.state == RED)))


def toka1_vote(msg_count: torch.Tensor, inter_edges: torch.Tensor,
               n_parts: int) -> torch.Tensor:
    """Paper Algorithm 4: stop when ``msg_count >= n_parts * inter_edges``
    (the inter-partition edge count clamped to at least 1), in int32 as the
    reference computes it."""
    bound = inter_edges.to(torch.int32).clamp(min=1) * n_parts
    return msg_count >= bound


def toka3_bound(inter_edges, n_parts: int, safety: float,
                fault_slack: int = 0) -> torch.Tensor:
    """Quiet-streak timeout in rounds: ``ceil(safety * (1 + log2(1 + P) +
    log2(1 + inter_edges / P))) + fault_slack``, in float32 as the
    reference computes it, then int32."""
    ie = torch.as_tensor(inter_edges).to(torch.float32)
    pf = torch.tensor(float(n_parts), dtype=torch.float32, device=ie.device)
    t = torch.ceil(safety * (1.0 + torch.log2(1.0 + pf)
                             + torch.log2(1.0 + ie / pf)))
    return t.to(torch.int32) + fault_slack


@functools.lru_cache(maxsize=64)
def toka3_timeout(inter_edges_total: int, n_parts: int, safety: float = 2.0,
                  fault_slack: int = 0) -> int:
    """The toka3 bound of the total inter-edge count on the host, for the
    round (cached: it is read every round), tests and tooling. Computed on
    the CPU, so every device reads the same bound."""
    return int(toka3_bound(torch.tensor(inter_edges_total, dtype=torch.int32),
                           n_parts, safety, fault_slack))
