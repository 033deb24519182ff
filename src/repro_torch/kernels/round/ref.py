"""Plain oracle for one fused SP-Async round, over the original-order edge
lists (the reference's ``kernels/round/ref.py``).

Replays the round as the staged pipeline would: scatter-min merge of the
delivered messages, frontier derivation, Jacobi Bellman–Ford local
fixpoint, then the segment-min send pack against ``last_sent``. The
relaxation COUNT depends on the sweep schedule (Jacobi here, Gauss–Seidel
in the kernel) and is not part of the oracle; the fixpoint itself is
schedule-independent, so distances and send outputs are bit-comparable
with the kernel's once it has converged.

Self-contained (no ``repro_torch.core`` imports). ``fused_round_ref``
takes one shard, as the reference's does; ``_fused_round_ref_stacked``
takes the ``sim`` backend's stack, every array with a leading shard axis
``[P, ...]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import INF, scatter_min_drop, take_fill


def _local_fixpoint(dist, front, loc_src, loc_dst, loc_w, max_iters: int):
    """Jacobi Bellman–Ford to the fixpoint, each (shard, query) row until
    its frontier is empty or it has taken ``max_iters`` steps."""
    src, dst, w = loc_src[:, None, :], loc_dst[:, None, :], loc_w[:, None, :]
    it = torch.zeros(dist.shape[:2], dtype=torch.int32, device=dist.device)
    while True:
        run = front.any(-1) & (it < max_iters)               # [P, K]
        if not bool(run.any()):
            return dist
        ok = take_fill(front, src, False)
        cand = torch.where(ok, take_fill(dist, src, INF) + w, INF)
        new = scatter_min_drop(dist, dst, cand)
        front = torch.where(run[..., None], new < dist, front)
        dist = torch.where(run[..., None], new, dist)
        it += run.to(torch.int32)


def _fused_round_ref_stacked(dist, front_in, live, incoming, recv_idx,
                             last_sent, slot_valid, loc_src, loc_dst, loc_w,
                             pruned_loc, cut_src, cut_seg, cut_w, pruned_cut,
                             *, dense: bool = False,
                             max_iters: int = 10_000):
    """dist/front_in: [P, K, block]; live: [P, K] bool; incoming:
    [P, K, M] flat bucket messages (with ``recv_idx`` [P, M] flat targets,
    sentinel = block) or [P, K, block] dense remote minima (recv_idx
    ignored); last_sent / slot_valid: [P, K, S] / [P, S]; loc_* / cut_*:
    [P, E] original-order edge lists; pruned_*: bool masks. Returns
    (new_dist [P, K, block], send_val [P, K, S], new_last [P, K, S],
    sends [P, K] int32)."""
    P, K = dist.shape[:2]
    if dense:
        merged = torch.minimum(dist, incoming)
    else:
        merged = scatter_min_drop(dist, recv_idx.reshape(P, 1, -1),
                                  incoming.reshape(P, K, -1))
    front = ((merged < dist) & live[..., None]) | front_in
    w_loc = torch.where(pruned_loc, INF, loc_w)
    new_dist = _local_fixpoint(merged, front, loc_src, loc_dst, w_loc,
                               max_iters)

    w_cut = torch.where(pruned_cut, INF, cut_w)
    cand = take_fill(new_dist, cut_src[:, None, :], INF) + w_cut[:, None, :]
    slot_val = scatter_min_drop(
        torch.full(last_sent.shape, INF, device=dist.device),
        cut_seg[:, None, :], cand)
    improved = slot_valid[:, None, :] & (slot_val < last_sent)
    send_val = torch.where(improved, slot_val, INF)
    new_last = torch.where(improved, slot_val, last_sent)
    return new_dist, send_val, new_last, improved.sum(-1, dtype=torch.int32)


def fused_round_ref(dist, front_in, live, incoming, recv_idx, last_sent,
                    slot_valid, loc_src, loc_dst, loc_w, pruned_loc, cut_src,
                    cut_seg, cut_w, pruned_cut, *, dense: bool = False,
                    max_iters: int = 10_000):
    """The oracle on one shard, the reference's form: dist/front_in
    [K, block]; live [K]; incoming [K, M] (recv_idx [M]) or dense
    [K, block]; last_sent / slot_valid [K, S] / [S]; the shard's
    original-order edge lists [E]. Returns (new_dist [K, block], send_val
    [K, S], new_last [K, S], sends [K] int32)."""
    args = (dist, front_in, live, incoming, recv_idx, last_sent, slot_valid,
            loc_src, loc_dst, loc_w, pruned_loc, cut_src, cut_seg, cut_w,
            pruned_cut)
    out = _fused_round_ref_stacked(*(a[None] for a in args), dense=dense,
                                   max_iters=max_iters)
    return tuple(t[0] for t in out)
