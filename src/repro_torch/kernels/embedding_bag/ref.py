"""Plain PyTorch oracle for the fixed-length embedding bag (sum / mean),
the reference's ``kernels/embedding_bag/ref.py``: a take and a masked sum.
``indices`` use ``V`` (any index outside [0, V)) as padding."""
from __future__ import annotations

import torch


def embedding_bag_ref(table, indices, *, mode: str = "sum"):
    """table: [V, D]; indices: [B, L] int (V = padding). Returns [B, D] in
    the table's type (the sum taken in that type)."""
    V = table.shape[0]
    valid = (indices >= 0) & (indices < V)
    rows = table[torch.where(valid, indices, 0).long()]
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=rows.dtype))
    out = rows.sum(dim=1)
    if mode == "mean":
        cnt = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
        out = out / cnt.to(out.dtype)
    return out
