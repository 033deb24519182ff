"""Plain PyTorch oracle for the fixed-length embedding bag (sum / mean),
the reference's ``kernels/embedding_bag/ref.py``: a take and a masked sum.
``indices`` use ``V`` (any index outside [-V, V)) as padding; an index in
[-V, 0) wraps to row V + i."""
from __future__ import annotations

import torch


def embedding_bag_ref(table, indices, *, mode: str = "sum"):
    """table: [V, D]; indices: [B, L] int (V = padding, [-V, 0) wraps).
    Returns [B, D] in
    the table's type (the sum taken in that type)."""
    V = table.shape[0]
    valid = (indices >= -V) & (indices < V)
    rows = table[torch.where(valid, indices.long() % V, 0)]
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype))
    out = rows.sum(dim=1)
    if mode == "mean":
        cnt = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        out = out / cnt.to(out.dtype)
    return out
