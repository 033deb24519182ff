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

from repro_torch.kernels import build

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


def live_chunks(live_slots: torch.Tensor):
    """The live chunks of a dense layout, the chunks kernels 7 and 9 walk.
    ``live_slots`` [P, n_tiles, n_chunks, EB] bool marks the slots that hold
    an edge (``w < +inf``) or a message (``valid > 0``); a chunk with none is
    an exact no-op in every stage of the round and the relax sweeps, so the
    kernels skip it. Returns (idx [P, n_tiles * n_chunks] int32: the live
    chunks' indices first, in layout order, then the dead ones; bounds
    [P, n_tiles + 1] int32: tile i's live chunks are
    ``idx[p, bounds[p, i]:bounds[p, i + 1]]``, and ``bounds[p, n_tiles]``
    is the shard's live count). Device ops only: no host sync, as the
    kernels read the count where it lies. Kernel 9's entry point derives
    the same list on the card (``csrc/relax.cu``: the pre-pass)."""
    P, n_tiles, n_chunks, _ = live_slots.shape
    live = live_slots.any(-1).reshape(P, -1)
    idx = torch.sort((~live).to(torch.int32), dim=-1,
                     stable=True).indices.to(torch.int32)
    pos = torch.arange(idx.shape[1], device=idx.device)
    tiles = torch.where(pos < live.sum(-1, keepdim=True), idx // n_chunks,
                        n_tiles).to(torch.int32)
    return idx, chunk_bounds(tiles, n_tiles)


def check_cuda(name: str, dtype: torch.dtype, *tensors: torch.Tensor):
    """Raise unless every tensor is a contiguous CUDA tensor of ``dtype``."""
    for t in tensors:
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous CUDA {dtype}, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def same_card(name: str, first: torch.Tensor, *rest):
    """Raise ``ValueError`` naming both cards unless every tensor among
    ``rest`` (tuples and lists walked, None skipped) lies on the card of
    ``first``, as a launch reads every operand on the card it runs on.
    Returns that card, the one the launch runs on. It runs before every
    launch, so it compares card indices (``get_device``) and makes no
    device objects but the one it returns."""
    _on_card(name, first, rest, first.get_device())
    return first.device


def _on_card(name: str, first, items, card: int):
    for x in items:
        if isinstance(x, (tuple, list)):
            _on_card(name, first, x, card)
        elif x is not None and x.get_device() != card:
            raise ValueError(f"{name}: operands on two cards, "
                             f"{first.device} and {x.device}; a kernel "
                             f"runs on the card that holds its operands")


def check_chain(name: str, eb: int, vb: int, *tensors: torch.Tensor):
    """Raise unless the Hopper chain (csrc/sweeps_ragged.cuh, kernels 2, 8,
    9 and 7) takes the operands: EB a multiple of 4 and 16-byte aligned
    layout planes (the ring is fed by bulk copies) and rows (read four
    floats at a time), VB a multiple of 32 (a warp's vertices are one word
    of the bitmasks)."""
    if eb % 4 or vb % 32 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: chunks of {eb} edges, tiles of {vb} "
                         f"vertices or storage not 16-byte aligned: the "
                         f"ragged chain needs EB % 4 == 0, VB % 32 == 0 and "
                         f"16-byte aligned rows and layout planes")


def ragged_scratch(name: str, lib, symbol: str, rows: int, dims, device):
    """The Hopper chain's frontier and improved bitmasks in device memory,
    [rows, bytes / 4] int32, when they do not fit beside the ring in shared
    memory; None when they do. ``symbol`` (called with ``dims``: bp,
    n_vtiles, eb, vb[, sb]) gives the bytes a row needs, 0 when they fit and
    -1 when the row is past the chain's cap (the ring, window and a byte a
    vertex tile must fit in shared memory), which raises."""
    nbytes = build.call(lib, symbol, device, *dims)
    if nbytes < 0:
        raise ValueError(
            f"{name}: a row of {dims[1]} vertex tiles of {dims[3]} is past the "
            f"ragged chain's cap (its shared memory holds a byte a vertex "
            f"tile beside the ring and window); use more shards")
    if nbytes == 0:
        return None
    return torch.empty((rows, nbytes // 4), dtype=torch.int32, device=device)
