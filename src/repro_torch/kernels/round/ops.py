"""Solver-facing wrappers of the fused round (the reference's
``kernels/round/ops.py``).

``fused_round_pallas`` pads the solver-facing state into tile-aligned rows,
gathers the Trishla pruned mask into both tiled edge orders, and runs the
fused round kernel. It does NOT resolve the residual frontier: the caller
inspects ``resid`` and, only when some query's fixpoint escaped the
``n_sweeps`` in-kernel sweeps, runs ``fused_round_rescue``, which finishes
the relaxation with the relax kernels and re-packs the sends against the
ORIGINAL ``last_sent`` (the kernel's send outputs were computed from
unconverged distances and are discarded wholesale).

The public wrappers take one shard, as the reference's do (dist
``[K, block]``, the shard's layouts, ``interpret=`` accepted and
ignored): a one-shard stack of the stacked bodies ``_fused_round_stacked``
and ``_fused_round_rescue_stacked``, whose arrays carry the ``sim``
backend's leading shard axis ``[P, ...]`` and which the solver calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import INF, live_chunks, pad_last, take_fill
from repro_torch.kernels.relax.ops import fixpoint_operands, relax_to_fixpoint
from repro_torch.kernels.round.round import (fused_round_ragged,
                                            fused_round_tiled)
from repro_torch.kernels.send.ops import send_pack


def _padded_widths(block: int, n_slots: int, relax_layout, send_layout, *,
                   vb: int, sb: int):
    """(block_pad, S_pad): a dense layout's rows encode its tile counts; a
    ragged one's do not, so its widths round block and S up to the tiles."""
    if len(relax_layout) == 5:
        return (max(-(-block // vb), 1) * vb, max(-(-n_slots // sb), 1) * sb)
    return relax_layout[0].shape[1] * vb, send_layout[0].shape[1] * sb


def _pad_state(dist, front_in, live, last_sent, slot_valid, *, bp: int,
               sp: int):
    """dist [P, K, block] -> +inf-padded [P, K, bp]; front_in to 0/1 f32;
    live [P, K] to f32; last_sent [P, K, S] -> +inf-padded [P, K, sp];
    slot_valid [P, S] -> int32 0/1 [P, sp]."""
    return (pad_last(dist, bp, INF), pad_last(front_in.float(), bp, 0.0),
            live.float(), pad_last(last_sent, sp, INF),
            pad_last(slot_valid.to(torch.int32), sp, 0))


def _gather_pruned(pruned, eid_t):
    """A [P, E] pruned mask in a layout's edge order (int32; the padding
    sentinel E reads 0 = not pruned)."""
    P = eid_t.shape[0]
    return take_fill(pruned.to(torch.int32), eid_t.reshape(P, -1),
                     0).reshape(eid_t.shape)


def fused_round_operands(dist, front_in, live, incoming, last_sent,
                         slot_valid, relax_layout, send_layout, merge_layout,
                         pruned_loc, pruned_cut, *, vb: int, sb: int,
                         dense: bool):
    """The fused round kernel's operands, in its argument order: the rows
    padded to the tiles (``_pad_state``; a dense incoming padded with +inf),
    and the layouts with the Trishla masks gathered into their edge order
    (merge layout None when dense). Arguments as ``fused_round_pallas``."""
    bp, sp = _padded_widths(dist.shape[-1], last_sent.shape[-1],
                            relax_layout, send_layout, vb=vb, sb=sb)
    rows = _pad_state(dist, front_in, live, last_sent, slot_valid, bp=bp,
                      sp=sp)
    rx = (*relax_layout[:3], _gather_pruned(pruned_loc, relax_layout[3]),
          *relax_layout[4:])
    tx = (*send_layout[:3], _gather_pruned(pruned_cut, send_layout[3]),
          *send_layout[4:])
    inc = pad_last(incoming, bp, INF) if dense else incoming.contiguous()
    return (*rows[:3], inc, *rows[3:], None if dense else merge_layout, rx,
            tx)


def _fused_round_stacked(dist, front_in, live, incoming, last_sent,
                         slot_valid, relax_layout, send_layout, merge_layout,
                         pruned_loc, pruned_cut, *, vb: int = 128,
                         sb: int = 128, n_sweeps: int = 8,
                         dense: bool = False, chunks=None):
    """One fused merge + local-fixpoint + send-pack round on every shard.

    dist/front_in: [P, K, block]; live: [P, K] bool; incoming: [P, K, M]
    flattened bucket messages or [P, K, block] dense remote minima;
    last_sent/slot_valid: [P, K, S] / [P, S]; relax_layout/send_layout: the
    shards' tiled edge layouts (src, w, rel, eid); merge_layout: (pos,
    dstrel, valid) (ignored when dense); pruned_loc/pruned_cut: [P, e_loc] /
    [P, e_cut] Trishla masks in original edge order. Ragged shards pass
    5-tuple relax/send and 4-tuple merge layouts (+ the chunk->tile map);
    the tuple arity selects the ragged kernel. ``chunks``: the dense
    layouts' live chunks (``SsspShards.round_chunks``), which kernel 7
    needs on CUDA tensors; None for ragged layouts and on the CPU.

    Returns (new_dist [P, K, block], send_val [P, K, S], new_last
    [P, K, S], nrel [P, K], sends [P, K], resid [P, K, block] f32: a
    non-empty row means the in-kernel sweeps did not converge and the
    caller must rescue)."""
    block, n_slots = dist.shape[-1], last_sent.shape[-1]
    ops = fused_round_operands(
        dist, front_in, live, incoming, last_sent, slot_valid, relax_layout,
        send_layout, merge_layout, pruned_loc, pruned_cut, vb=vb, sb=sb,
        dense=dense)
    kw = dict(vb=vb, sb=sb, n_sweeps=n_sweeps, dense=dense)
    if len(relax_layout) == 5:
        out, resid, sval, nlast, nrel, sends = fused_round_ragged(*ops, **kw)
    else:
        out, resid, sval, nlast, nrel, sends = fused_round_tiled(
            *ops, **kw, chunks=chunks)
    return (out[..., :block], sval[..., :n_slots], nlast[..., :n_slots],
            nrel, sends, resid[..., :block])


def _fused_round_rescue_stacked(dist, resid, last_sent, slot_valid,
                                relax_layout, send_layout, pruned_loc,
                                pruned_cut, *, vb: int = 128, sb: int = 128,
                                n_sweeps: int = 8, max_iters: int = 10_000,
                                send_bounds=None, relax_chunks=None):
    """Finish a round whose in-kernel sweeps left a residual frontier.

    ``dist``/``resid`` are the fused kernel's merged-and-partially-relaxed
    distances and its final-sweep residual, [P, K, block]. Continues the
    fixpoint with the relax kernels (each shard's sweep budget starts at
    ``n_sweeps``, exactly like the staged pipeline's outer loop) and
    re-packs the sends against the original ``last_sent``
    (``send_bounds``: the ragged send layout's precomputed tile -> chunk
    ranges; ``relax_chunks``: the dense relax layout's live chunks, which
    kernel 1 walks, ``SsspShards.round_chunks[1]``). Returns (new_dist
    [P, K, block], send_val [P, K, S], new_last [P, K, S], nrel_extra
    [P, K], sends [P, K])."""
    block = dist.shape[-1]
    bp, _ = _padded_widths(block, last_sent.shape[-1], relax_layout,
                           send_layout, vb=vb, sb=sb)
    d, front, prn_rx = fixpoint_operands(dist, resid, pruned_loc,
                                         relax_layout[3], bp)
    d2, nrel_extra = relax_to_fixpoint(d, front, relax_layout, prn_rx, vb=vb,
                                       n_sweeps=n_sweeps,
                                       max_iters=max_iters, spent=n_sweeps,
                                       chunks=relax_chunks)
    d2 = d2[..., :block]
    sval, nlast, sends = send_pack(
        d2, last_sent, slot_valid, *send_layout[:3],
        _gather_pruned(pruned_cut, send_layout[3]), sb=sb,
        ctile=send_layout[4] if len(send_layout) == 5 else None,
        bounds=send_bounds)
    return d2, sval, nlast, nrel_extra, sends


def _stack(layout):
    return tuple(a[None] for a in layout)


def _shard_chunks(dist, relax_layout, send_layout, merge_layout,
                  dense: bool):
    """A dense shard's live chunks (merge, relax, send; no merge's with a
    dense incoming), as ``SsspShards.round_chunks`` derives them for the
    stack; None on the CPU (the plain versions walk every chunk) and for
    ragged layouts."""
    if not dist.is_cuda or len(relax_layout) == 5:
        return None
    return (None if dense else live_chunks(merge_layout[2][None] > 0),
            live_chunks(relax_layout[1][None] < INF),
            live_chunks(send_layout[1][None] < INF))


def fused_round_pallas(dist, front_in, live, incoming, last_sent, slot_valid,
                       relax_layout, send_layout, merge_layout, pruned_loc,
                       pruned_cut, *, vb: int = 128, sb: int = 128,
                       n_sweeps: int = 8, dense: bool = False,
                       interpret: bool = True):
    """One fused merge + local-fixpoint + send-pack round on one shard,
    the reference's per-shard wrapper: dist/front_in [K, block]; live [K];
    incoming [K, M] or, dense, [K, block]; last_sent/slot_valid [K, S] /
    [S]; one shard's layouts; pruned_loc/pruned_cut [e_loc] / [e_cut].
    Kernel 7 (dense layouts) or 8 (ragged) on CUDA tensors, their plain
    versions on CPU tensors. ``interpret`` is accepted and ignored.
    Returns the six outputs of ``_fused_round_stacked`` for the shard
    ([K, ...])."""
    out = _fused_round_stacked(
        dist[None], front_in[None], live[None], incoming[None],
        last_sent[None], slot_valid[None], _stack(relax_layout),
        _stack(send_layout), None if dense else _stack(merge_layout),
        pruned_loc[None], pruned_cut[None], vb=vb, sb=sb, n_sweeps=n_sweeps,
        dense=dense, chunks=_shard_chunks(dist, relax_layout, send_layout,
                                          merge_layout, dense))
    return tuple(t[0] for t in out)


def fused_round_rescue(dist, resid, last_sent, slot_valid, relax_layout,
                       send_layout, pruned_loc, pruned_cut, *, vb: int = 128,
                       sb: int = 128, n_sweeps: int = 8,
                       max_iters: int = 10_000, interpret: bool = True):
    """``_fused_round_rescue_stacked`` on one shard, the reference's
    per-shard wrapper: dist/resid [K, block], last_sent [K, S], slot_valid
    [S], one shard's layouts and Trishla masks. ``interpret`` is accepted
    and ignored. Returns (new_dist [K, block], send_val [K, S], new_last
    [K, S], nrel_extra [K], sends [K])."""
    relax_chunks = None
    if dist.is_cuda and len(relax_layout) == 4:
        relax_chunks = live_chunks(relax_layout[1][None] < INF)
    out = _fused_round_rescue_stacked(
        dist[None], resid[None], last_sent[None], slot_valid[None],
        _stack(relax_layout), _stack(send_layout), pruned_loc[None],
        pruned_cut[None], vb=vb, sb=sb, n_sweeps=n_sweeps,
        max_iters=max_iters, relax_chunks=relax_chunks)
    return tuple(t[0] for t in out)
