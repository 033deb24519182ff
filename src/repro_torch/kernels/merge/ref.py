"""Plain-PyTorch oracle of the merge phase's scatter-min (the
reference's ``kernels/merge/ref.py``).

Per query: new[v] = min(dist[v], min over flat positions m with
idx[m] == v of incoming[m]); improved vertices are the next frontier.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import scatter_min_drop


def merge_scatter_ref(dist, incoming_flat, flat_idx):
    """dist: [K, block]; incoming_flat: [K, M] f32; flat_idx: [M] int32
    (sentinel >= block = dropped). Returns (new_dist [K, block],
    new_active [K, block] bool, recvs [K] int32, the finite messages)."""
    new = scatter_min_drop(dist, flat_idx, incoming_flat)
    recvs = torch.isfinite(incoming_flat).sum(-1, dtype=torch.int32)
    return new, new < dist, recvs
