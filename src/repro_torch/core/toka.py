"""Termination detectors' votes (port of the reference's ``core/toka.py``).

Only toka1's vote is ported: toka2 (the token ring) and toka3 (the
quiet-streak timeout) are ROADMAP Queue 1 item 7 and raise
``NotImplementedError`` through ``core/phases.py``.
"""
from __future__ import annotations

import torch


def toka1_vote(msg_count: torch.Tensor, inter_edges: torch.Tensor,
               n_parts: int) -> torch.Tensor:
    """Paper Algorithm 4: stop when ``msg_count >= n_parts * inter_edges``
    (the inter-partition edge count clamped to at least 1), in int32 as the
    reference computes it."""
    bound = inter_edges.to(torch.int32).clamp(min=1) * n_parts
    return msg_count >= bound
