"""The embedding-bag entry points (the reference's
``kernels/embedding_bag/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.embedding_bag import embedding_bag_p
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table, indices, *, mode: str = "sum", bb: int = 8,
                  interpret: bool = True):
    """The kernel path. Pads the bag axis to a multiple of ``bb`` with
    bags of the sentinel ``V`` and drops them from the result."""
    B, L = indices.shape
    pad = (-B) % bb
    if pad:
        indices = torch.cat([indices, torch.full(
            (pad, L), table.shape[0], dtype=indices.dtype,
            device=indices.device)])
    return embedding_bag_p(table, indices, mode=mode, bb=bb)[:B]


def embedding_bag_jnp(table, indices, *, mode: str = "sum"):
    """The plain-tensor path (take + masked sum), the reference's XLA
    path; the same function as ``embedding_bag_ref``."""
    return embedding_bag_ref(table, indices, mode=mode)
