"""Tensor helpers shared by the kernel wrappers and the round phases.

The reference indexes with ``jnp.take(..., mode="fill")`` and
``.at[idx].min(..., mode="drop")``, whose out-of-range sentinels are part of
every layout (``block`` for padding sources and receive slots, ``e_loc`` /
``e_cut`` for padding edge ids, ``S`` for padding payload positions).
``torch.gather`` and ``scatter_reduce`` raise on such indices, so these
helpers append one sentinel column and clamp onto it. Stored indices stay
int32; the cast to int64 happens here, at the point of use.
"""
from __future__ import annotations

import torch

INF = float("inf")


def pad_last(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """``x`` [..., n] -> [..., width] with ``fill`` in the new columns."""
    out = torch.full((*x.shape[:-1], width), fill, dtype=x.dtype,
                     device=x.device)
    out[..., :x.shape[-1]] = x
    return out


def _clamped(idx: torch.Tensor, n: int, lead) -> torch.Tensor:
    idx = idx.long().clamp(max=n)
    return idx.expand(*lead, idx.shape[-1])


def take_fill(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(x, idx, axis=-1, mode="fill", fill_value=fill)`` with
    ``idx`` broadcast over x's leading dims; indices >= n give ``fill``."""
    n = x.shape[-1]
    ext = pad_last(x, n + 1, fill)
    return torch.gather(ext, -1, _clamped(idx, n, x.shape[:-1]))


def scatter_min_drop(x: torch.Tensor, idx: torch.Tensor,
                     val: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].min(val, mode="drop")`` along the last axis, batched over
    val's leading dims; indices >= n are dropped."""
    n = x.shape[-1]
    ext = pad_last(x.expand(*val.shape[:-1], n), n + 1, INF)
    ext.scatter_reduce_(-1, _clamped(idx, n, val.shape[:-1]), val, "amin")
    return ext[..., :n]


def chunk_bounds(ctile: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """A ragged layout's chunk->tile map ``ctile`` [P, total_chunks]
    (non-decreasing per shard, sentinel ``n_tiles`` on trailing padding
    chunks) -> the tile -> chunk ranges [P, n_tiles + 1] int32: tile i of
    shard p owns chunks ``[b[p, i], b[p, i + 1])``; padding chunks lie past
    ``b[p, n_tiles]`` and belong to no tile."""
    tiles = torch.arange(n_tiles + 1, dtype=ctile.dtype, device=ctile.device)
    return torch.searchsorted(ctile.contiguous(),
                              tiles.expand(ctile.shape[0], -1).contiguous(),
                              out_int32=True)


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous CUDA {dtype}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
