"""Plain-PyTorch oracle of the send phase's segment-min pack (the
reference's ``kernels/send/ref.py``).

Per query: slot_val[s] = min over cut edges e with seg[e] == s of
(dist[src[e]] + w[e]); only improvements over last_sent transmit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import INF, scatter_min_drop, take_fill


def send_pack_ref(dist, cut_src, cut_w, cut_seg, n_slots, slot_valid,
                  last_sent):
    """dist: [K, block]; cut_src/cut_w/cut_seg: [e_cut] (padding w = +inf,
    seg >= n_slots dropped); slot_valid: [S] bool; last_sent: [K, S].
    Returns (send_val [K, S], +inf where not improved, new_last [K, S],
    sends [K] int32)."""
    cand = take_fill(dist, cut_src, INF) + cut_w
    slot_val = scatter_min_drop(
        torch.full((dist.shape[0], n_slots), INF, device=dist.device),
        cut_seg, cand)
    improved = slot_valid & (slot_val < last_sent)
    send_val = torch.where(improved, slot_val, INF)
    new_last = torch.where(improved, slot_val, last_sent)
    return send_val, new_last, improved.sum(-1, dtype=torch.int32)
