"""The one-hot min-reduce shared by the relax, send and merge kernels.

Plain PyTorch version of the reference's ``kernels/tile_reduce.py``
(``tile_min`` / ``tile_min_batch``): a chunk of [EB] candidates, each tagged
with a tile-relative target in ``[0, width)``, reduced to per-target minima.
The CUDA kernels do the same move as a device function,
``tile_min_into`` in ``csrc/tile_reduce.cuh``: an ``atomicMin`` of the
candidate's order-preserving int key into a shared-memory tile.
"""
from __future__ import annotations

import torch

INF = float("inf")


def tile_min_batch(cand: torch.Tensor, rel: torch.Tensor, *,
                   width: int) -> torch.Tensor:
    """[..., EB] candidates -> [..., width] per-target minima. ``rel`` is
    broadcast against ``cand``, so one target vector serves a whole query
    batch (the reference's shared one-hot mask)."""
    lane = torch.arange(width, device=cand.device)
    onehot = rel.long().unsqueeze(-1) == lane               # [..., EB, width]
    masked = torch.where(onehot, cand.unsqueeze(-1), INF)
    return masked.amin(dim=-2)


def tile_min(cand: torch.Tensor, rel: torch.Tensor, *,
             width: int) -> torch.Tensor:
    """[EB] candidates -> [width] per-target minima."""
    return tile_min_batch(cand, rel, width=width)
