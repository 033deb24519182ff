"""One SP-Async round in one launch: merge, local fixpoint and send pack,
dense and ragged layouts.

Port of the reference's ``kernels/round/round.py: fused_round_tiled`` and
``fused_round_ragged``. Each wrapper runs the CUDA kernel
(``csrc/round.cu``) on CUDA tensors and its plain PyTorch version on CPU
tensors; the ``*_plain`` functions are the plain versions, callable on
either device.

The Pallas grid walks three stages over a shard's distance rows: stage 0
merges the delivered messages and derives the round's frontier
``((merged < dist) & live) | front``; stages 1..S are the relax sweeps;
stage S+1 packs the sends against ``last_sent``. Each stage computes what
one staged kernel computes, in the same tile and chunk order, so the plain
versions run those kernels' plain versions in stage order. The Pallas
kernel's shard-wide early-out flag is a per-row one here: a row with no
frontier relaxes nothing, so both give the same rows and counts.

Shapes carry the ``sim`` backend's leading shard axis: dist/front
``[P, K, bp]``; live ``[P, K]`` f32 0/1; incoming ``[P, K, M]`` bucket
messages (``dense=False``) or ``[P, K, bp]`` remote minima
(``dense=True``); last ``[P, K, S_pad]``; valid ``[P, S_pad]`` int32.
``mx_layout`` = (pos, dstrel, valid) or None when dense; ``rx_layout`` =
(src, w, dstrel, pruned); ``tx_layout`` = (src, w, segrel, pruned). Dense
layouts are ``[P, n_tiles, n_chunks, EB]``; ragged ones are
``[P, total_chunks, EB]`` and each tuple ends with its chunk->tile map
``[P, total_chunks]``. Returns (out ``[P, K, bp]``, resid ``[P, K, bp]``
f32 0/1, send_val ``[P, K, S_pad]`` +inf where not improved, new_last
``[P, K, S_pad]``, nrel ``[P, K]`` int32, sends ``[P, K]`` int32).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import (check_chain, check_cuda,
                                        chunk_bounds, ragged_scratch,
                                        same_card)
from repro_torch.kernels.merge.merge import (merge_scatter_ragged_plain,
                                            merge_scatter_tiled_plain)
from repro_torch.kernels.relax.relax import (
    relax_dst_ragged_fixpoint_batch_plain,
    relax_dst_tiled_fixpoint_batch_plain)
from repro_torch.kernels.send.send import (send_pack_ragged_plain,
                                          send_pack_tiled_plain)

INF = float("inf")


def _frontier(dist, merged, front, live):
    """Stage 0's frontier: vertices the merge improved in live queries,
    plus the injected ``front``."""
    newf = (merged < dist) & (live[..., None] > 0)
    return torch.maximum(newf.float(), front)


def fused_round_tiled_plain(dist, front, live, incoming, last, valid,
                            mx_layout, rx_layout, tx_layout, *, vb: int,
                            sb: int, n_sweeps: int, dense: bool):
    """Transliteration of the Pallas grid (stage, tile, chunk) over dense
    layouts (see the module doc for shapes and returns)."""
    if dense:
        merged = torch.minimum(dist, incoming)
    else:
        merged = merge_scatter_tiled_plain(dist, incoming, *mx_layout,
                                           vb=vb)[0]
    out, resid, nrel = relax_dst_tiled_fixpoint_batch_plain(
        merged, _frontier(dist, merged, front, live), *rx_layout, vb=vb,
        n_sweeps=n_sweeps)
    val, new_last, sends = send_pack_tiled_plain(out, last, valid,
                                                 *tx_layout, sb=sb)
    return out, resid, val, new_last, nrel, sends


def fused_round_ragged_plain(dist, front, live, incoming, last, valid,
                             mx_layout, rx_layout, tx_layout, *, vb: int,
                             sb: int, n_sweeps: int, dense: bool):
    """Transliteration of the Pallas ragged grid (stage, flat chunk): chunk
    c of a stage lands in tile ``min(ctile[c], n_tiles - 1)``, and init and
    finalize run once over the whole row (see the module doc)."""
    if dense:
        merged = torch.minimum(dist, incoming)
    else:
        *mx, mx_ct = mx_layout
        merged = merge_scatter_ragged_plain(dist, incoming, mx_ct, *mx,
                                            vb=vb)[0]
    *rx, rx_ct = rx_layout
    out, resid, nrel = relax_dst_ragged_fixpoint_batch_plain(
        merged, _frontier(dist, merged, front, live), rx_ct, *rx, vb=vb,
        n_sweeps=n_sweeps)
    *tx, tx_ct = tx_layout
    val, new_last, sends = send_pack_ragged_plain(out, last, valid, tx_ct,
                                                  *tx, sb=sb)
    return out, resid, val, new_last, nrel, sends


_SIGNATURES = {"fused_round_tiled": build.signature(30, 16),
               "fused_round_ragged": build.signature(27, 16),
               "round_ragged_scratch_bytes": [ctypes.c_int] * 5}


def _check(name, dist, front, live, incoming, last, valid, mx_layout,
           rx_layout, tx_layout, *, vb, sb, dense):
    """Raise unless the rows, slots and layouts fit the kernel: shapes,
    contiguous CUDA float32 rows and weights, int32 indices and masks."""
    P, K, bp = dist.shape
    sp = last.shape[-1]
    if (front.shape != dist.shape or live.shape != (P, K)
            or incoming.shape[:2] != (P, K) or last.shape[:2] != (P, K)
            or valid.shape != (P, sp) or bp % vb or sp % sb
            or (dense and incoming.shape[-1] != bp)):
        raise ValueError(f"{name}: rows {tuple(dist.shape)}, incoming "
                         f"{tuple(incoming.shape)}, slots "
                         f"{tuple(last.shape)} / {tuple(valid.shape)} do not "
                         f"match tiles of {vb} / {sb}")
    check_cuda(name, torch.float32, dist, front, live, incoming, last,
               rx_layout[1], tx_layout[1])
    check_cuda(name, torch.int32, valid, *rx_layout[:1], *rx_layout[2:],
               *tx_layout[:1], *tx_layout[2:], *(mx_layout or ()))


def _outputs(dist, last):
    """out, resid, send_val, new_last, nrel, sends."""
    P, K, _ = dist.shape
    return (torch.empty_like(dist), torch.empty_like(dist),
            torch.empty_like(last), torch.empty_like(last),
            torch.empty((P, K), dtype=torch.int32, device=dist.device),
            torch.empty((P, K), dtype=torch.int32, device=dist.device))


def _launch(lib, symbol, counter, rows, layouts, outs, scratch, ints):
    """Launch one block per (shard, query) with ``rows``, ``layouts`` (None
    for a null pointer), ``outs`` and ``scratch`` in the C argument order,
    then ``ints``, on the rows' card; count the launch."""
    ptrs = [build.ptr_or_null(a) for a in (*rows, *layouts, *outs, *scratch)]
    build.call(lib, symbol, rows[0].device, *ptrs, *ints, launch=counter)
    build.count_launch(counter)
    return outs


def fused_round_tiled(dist, front, live, incoming, last, valid, mx_layout,
                      rx_layout, tx_layout, *, vb: int, sb: int,
                      n_sweeps: int, dense: bool, chunks):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one block per (shard, query):
    the relax stage on the chain of ``csrc/sweeps_ragged.cuh`` over the
    relax layout's live chunks, merge and send over warps by tile, dead
    chunks skipped). ``chunks``: the layouts' live chunks (merge, relax,
    send), each the (idx, bounds) pair of ``live_chunks``, as the shards
    derive them once (``SsspShards.round_chunks``); the plain version
    walks every chunk and ignores them."""
    if not dist.is_cuda:
        return fused_round_tiled_plain(
            dist, front, live, incoming, last, valid, mx_layout, rx_layout,
            tx_layout, vb=vb, sb=sb, n_sweeps=n_sweeps, dense=dense)
    return _launch_tiled(dist, front, live, incoming, last, valid, mx_layout,
                         rx_layout, tx_layout, vb=vb, sb=sb,
                         n_sweeps=n_sweeps, dense=dense, chunks=chunks)


def _launch_tiled(dist, front, live, incoming, last, valid, mx_layout,
                  rx_layout, tx_layout, *, vb: int, sb: int, n_sweeps: int,
                  dense: bool, chunks, hazard: bool = True):
    """Kernel 7's launch. ``hazard=False`` is a planted fault for the checks
    alone (every source of the relax stage read from its early gather),
    which must differ from the plain version."""
    mx_layout = None if dense else mx_layout
    dev = same_card("round", dist, front, live, incoming, last, valid,
                    mx_layout, rx_layout, tx_layout, chunks)
    _check("round", dist, front, live, incoming, last, valid, mx_layout,
           rx_layout, tx_layout, vb=vb, sb=sb, dense=dense)
    P, K, bp = dist.shape
    sp = last.shape[-1]
    if (rx_layout[0].shape[1] * vb != bp or tx_layout[0].shape[1] * sb != sp
            or (not dense and mx_layout[0].shape[1] * vb != bp)):
        raise ValueError(f"round: layouts do not tile rows of {bp} by {vb} "
                         f"and slots of {sp} by {sb}")
    if chunks is None:
        raise ValueError("round: the layouts' live chunks are required "
                         "(SsspShards.round_chunks)")
    for lay, ch in zip((mx_layout, rx_layout, tx_layout), chunks):
        if lay is None:
            continue
        n_tiles, n_chunks = lay[0].shape[1:3]
        if (ch[0].shape != (P, n_tiles * n_chunks)
                or ch[1].shape != (P, n_tiles + 1)):
            raise ValueError(f"round: live chunks {tuple(ch[0].shape)} / "
                             f"{tuple(ch[1].shape)} do not match the layout "
                             f"{tuple(lay[0].shape)}")
        check_cuda("round", torch.int32, *ch)
    eb = rx_layout[0].shape[-1]
    check_chain("round", eb, vb, dist, front, incoming, *rx_layout)
    lib = build.load("round", _SIGNATURES)
    vstate = ragged_scratch("round", lib, "round_ragged_scratch_bytes",
                            P * K, (bp, bp // vb, eb, vb, sb), dev)
    # the C entry point takes each layout after its live chunks
    mx = (None,) * 5 if dense else (*chunks[0], *mx_layout)
    dims = ((1, 1) if dense else mx_layout[0].shape[2:]) + (
        rx_layout[0].shape[2:] + tx_layout[0].shape[2:])
    return _launch(lib, "fused_round_tiled", "round",
                   (dist, front, live, incoming, last, valid),
                   (*mx, *chunks[1], *rx_layout, *chunks[2], *tx_layout),
                   _outputs(dist, last), (vstate,),
                   (P, K, bp, sp, incoming.shape[-1], int(dense), *dims, vb,
                    sb, n_sweeps, int(hazard)))


def fused_round_ragged(dist, front, live, incoming, last, valid, mx_layout,
                       rx_layout, tx_layout, *, vb: int, sb: int,
                       n_sweeps: int, dense: bool):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (one block per (shard, query):
    the relax stage on the chain of ``csrc/sweeps_ragged.cuh``, merge and
    send over warps by tile). Each chunk->tile map must be non-decreasing
    per shard, as the shard builders make and check it."""
    if not dist.is_cuda:
        return fused_round_ragged_plain(
            dist, front, live, incoming, last, valid, mx_layout, rx_layout,
            tx_layout, vb=vb, sb=sb, n_sweeps=n_sweeps, dense=dense)
    return _launch_ragged(dist, front, live, incoming, last, valid,
                          mx_layout, rx_layout, tx_layout, vb=vb, sb=sb,
                          n_sweeps=n_sweeps, dense=dense)


def _launch_ragged(dist, front, live, incoming, last, valid, mx_layout,
                   rx_layout, tx_layout, *, vb: int, sb: int, n_sweeps: int,
                   dense: bool, hazard: bool = True):
    """Kernel 8's launch. Its merge and send take the tile -> chunk ranges
    of their layouts (``chunk_bounds``, two small searches a launch).
    ``hazard=False`` is a planted fault for the checks alone (every source
    of the relax stage read from its early gather), which must differ from
    the plain version."""
    mx_layout = None if dense else mx_layout
    dev = same_card("round_ragged", dist, front, live, incoming, last, valid,
                    mx_layout, rx_layout, tx_layout)
    _check("round_ragged", dist, front, live, incoming, last, valid,
           mx_layout, rx_layout, tx_layout, vb=vb, sb=sb, dense=dense)
    lays = (rx_layout, tx_layout) + ((mx_layout,) if mx_layout else ())
    for lay in lays:
        if lay[-1].shape != lay[0].shape[:2]:
            raise ValueError(f"round_ragged: ctile {tuple(lay[-1].shape)} "
                             f"does not match chunks {tuple(lay[0].shape)}")
    P, K, bp = dist.shape
    sp = last.shape[-1]
    n_vtiles, n_stiles = bp // vb, sp // sb
    send_bounds = chunk_bounds(tx_layout[-1], n_stiles)
    eb = rx_layout[0].shape[-1]
    check_chain("round_ragged", eb, vb, dist, front, incoming,
                *rx_layout[:4])
    lib = build.load("round", _SIGNATURES)
    vstate = ragged_scratch("round_ragged", lib,
                            "round_ragged_scratch_bytes", P * K,
                            (bp, n_vtiles, eb, vb, sb), dev)
    # the C entry point takes the merge and send layouts after their tile
    # ranges, the relax layout after its chunk->tile map
    mx = (None,) * 4 if dense else (chunk_bounds(mx_layout[-1], n_vtiles),
                                    *mx_layout[:-1])
    dims = ((1, 1) if dense else mx_layout[0].shape[1:]) + (
        rx_layout[0].shape[1:] + tx_layout[0].shape[1:])
    return _launch(lib, "fused_round_ragged", "round_ragged",
                   (dist, front, live, incoming, last, valid),
                   (*mx, rx_layout[-1], *rx_layout[:-1], send_bounds,
                    *tx_layout[:-1]),
                   _outputs(dist, last), (vstate,),
                   (P, K, bp, sp, incoming.shape[-1], int(dense), *dims, vb,
                    sb, n_sweeps, int(hazard)))
