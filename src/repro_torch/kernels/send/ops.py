"""Host-side slot-tiled layout builders (dense and ragged), the
solver-facing send wrapper and the bucketed payload gather (the
reference's ``kernels/send/ops.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import INF, pad_last, take_fill
from repro_torch.kernels.relax.ops import (build_dst_ragged_layout,
                                           build_dst_tiled_layout)
from repro_torch.kernels.send.send import send_pack_ragged, send_pack_tiled

LANE = 128   # the distance row is padded to a multiple of this, as in the reference


def build_slot_tiled_layout(cut_src, cut_seg, cut_w, n_slots: int, *,
                            sb: int = 128, eb: int = 512):
    """One-time host preprocessing: cut edges -> [n_stiles, n_chunks, EB]
    grouped by message-slot tile: the dst-tiled relax layout with the SLOT
    id in the destination role. Padding sources are restamped to 0 (any
    in-range vertex; their +inf weight keeps them inert).

    Returns (src_t, w_t, segrel_t, eid_t, S_pad); eid_t maps tiled slots
    back to cut-edge positions (sentinel = len(cut_src))."""
    src_t, w_t, segrel_t, eid_t, s_pad = build_dst_tiled_layout(
        cut_src, cut_seg, cut_w, n_slots, vb=sb, eb=eb, with_eid=True)
    src_t = torch.where(eid_t == len(np.asarray(cut_src)), 0, src_t)
    return src_t, w_t, segrel_t, eid_t, s_pad


def build_slot_ragged_layout(cut_src, cut_seg, cut_w, n_slots: int, *,
                             sb: int = 128, eb: int = 512):
    """Ragged (CSR-chunked) slot layout: cut edges -> flat [total_chunks,
    EB] rows plus the [total_chunks] chunk->tile map, with padding sources
    restamped to 0 as in the dense form.

    Returns (src_r, w_r, segrel_r, eid_r, ctile, S_pad)."""
    src_r, w_r, segrel_r, eid_r, ctile, s_pad = build_dst_ragged_layout(
        cut_src, cut_seg, cut_w, n_slots, vb=sb, eb=eb, with_eid=True)
    src_r = torch.where(eid_r == len(np.asarray(cut_src)), 0, src_r)
    return src_r, w_r, segrel_r, eid_r, ctile, s_pad


def send_operands(dist, last_sent, slot_valid, n_stiles: int, sb: int):
    """Rows in the kernel's form: dist [P, K, block] padded to a multiple of
    128 with +inf, last_sent [P, K, S] to S_pad with +inf, slot_valid
    [P, S] to S_pad as int32 0/1."""
    block = dist.shape[-1]
    sp = n_stiles * sb
    return (pad_last(dist, -(-block // LANE) * LANE, INF),
            pad_last(last_sent, sp, INF),
            pad_last(slot_valid.to(torch.int32), sp, 0))


def send_pack(dist, last_sent, slot_valid, src_t, w_t, segrel_t, pruned_t, *,
              sb: int = 128, ctile=None, bounds=None):
    """Solver-facing wrapper: pads to the kernel's tile shapes, slices back.
    dist [P, K, block]; last_sent [P, K, S]; slot_valid [P, S] bool; the
    layout is dense [P, n_stiles, n_chunks, EB] or, with ``ctile`` [P,
    total_chunks] given, ragged [P, total_chunks, EB] (``bounds``: its
    precomputed tile -> chunk ranges); pruned_t is already in layout order.
    Returns (send_val [P, K, S], new_last [P, K, S], sends [P, K])."""
    S = last_sent.shape[-1]
    # a ragged layout's rows no longer encode the tile count: ceil(S / sb)
    n_stiles = src_t.shape[1] if ctile is None else max(-(-S // sb), 1)
    ops = send_operands(dist, last_sent, slot_valid, n_stiles, sb)
    if ctile is None:
        val, new_last, sends = send_pack_tiled(
            *ops, src_t, w_t, segrel_t, pruned_t, sb=sb)
    else:
        val, new_last, sends = send_pack_ragged(
            *ops, ctile, src_t, w_t, segrel_t, pruned_t, sb=sb, bounds=bounds)
    return val[..., :S], new_last[..., :S], sends


def send_pack_pallas(dist, last_sent, slot_valid, src_t, w_t, segrel_t,
                     pruned_t, ctile=None, *, sb: int = 128, eb: int = 512,
                     interpret: bool = True):
    """The reference's per-shard wrapper: dist [K, block]; last_sent
    [K, S]; slot_valid [S] bool; one shard's slot-tiled layout
    [n_stiles, n_chunks, EB] (pruned_t already in layout order) or, with
    ``ctile`` given, its flat ragged rows. Returns (send_val [K, S], +inf
    where not improved, new_last [K, S], sends [K]). One shard as a
    one-shard stack of ``send_pack``: kernel 3 or 4 on CUDA tensors, the
    plain versions on CPU tensors. ``interpret`` is accepted and
    ignored."""
    if src_t.shape[-1] != eb:
        raise ValueError(f"layout chunks hold {src_t.shape[-1]} edges, "
                         f"eb={eb}")
    val, new_last, sends = send_pack(
        dist[None], last_sent[None], slot_valid[None], src_t[None],
        w_t[None], segrel_t[None], pruned_t[None], sb=sb,
        ctile=None if ctile is None else ctile[None])
    return val[0], new_last[0], sends[0]


def send_payload_bucket(send_val, payload_slot):
    """Route masked slot values [P, K, S] into the bucketed payload
    [P, K, P, C]. ``payload_slot[p, d, c]`` is the static inverse of
    (slot_owner, slot_pos): the slot feeding position c of the row bound
    for shard d (sentinel S -> +inf), so the scatter becomes a gather."""
    P, K, _ = send_val.shape
    flat = payload_slot.reshape(P, 1, -1)
    return take_fill(send_val, flat, INF).reshape(P, K, *payload_slot.shape[1:])
