"""Trishla: triangle-inequality edge elimination (paper Algorithm 1).

For a triangle u→v_i, v_i→v_j, u→v_j: if ``w(u,v_j) > w(u,v_i) + w(v_i,v_j)``
the direct edge (u, v_j) lies on no shortest path and is deleted. Every
deletion is replaced by a strictly shorter 2-edge path, so distances are
preserved exactly.

All functions take the shard-stacked arrays of the ``sim`` backend: a
leading [P] axis on every argument. Edge ids index the shard's combined
edge view ``[loc_w ++ cut_w]``.
"""
from __future__ import annotations

import torch

INF = float("inf")


def _take(x, idx):
    """Row-wise gather ``x[p, idx[p, t]]`` (indices always in range)."""
    return torch.gather(x, 1, idx.long())


def _drop_mask(w_all, pruned, uj, ui, ij, valid):
    w = torch.where(pruned, INF, w_all)
    return valid & (_take(w, uj) > _take(w, ui) + _take(w, ij))


def _or_scatter(pruned, uj, drop):
    """``pruned.at[uj].max(drop)``: set the candidates that lost."""
    out = pruned.to(torch.uint8)
    out.scatter_reduce_(1, uj.long(), drop.to(torch.uint8), "amax")
    return out.bool()


def effective_weights(loc_w, cut_w, pruned):
    """The combined edge view ``[loc_w ++ cut_w]`` with pruned edges at
    +inf."""
    return torch.where(pruned, INF, torch.cat([loc_w, cut_w], dim=-1))


def prune_pass(w_all, pruned, tri_uj, tri_ui, tri_ij, tri_valid):
    """One full vectorized Trishla pass. Returns the new pruned mask."""
    drop = _drop_mask(w_all, pruned, tri_uj, tri_ui, tri_ij, tri_valid)
    return _or_scatter(pruned, tri_uj, drop)


def prune_offline(loc_w, cut_w, tri_uj, tri_ui, tri_ij, tri_valid,
                  n_passes: int = 1):
    """Vectorized offline pruning. Returns pruned [P, e_loc + e_cut]."""
    w_all = torch.cat([loc_w, cut_w], dim=1)
    pruned = torch.zeros(w_all.shape, dtype=torch.bool, device=w_all.device)
    for _ in range(n_passes):
        pruned = prune_pass(w_all, pruned, tri_uj, tri_ui, tri_ij, tri_valid)
    return pruned


def prune_chunk(w_all, pruned, cursor, tri_uj, tri_ui, tri_ij, tri_valid,
                chunk: int):
    """Evaluate triangles [cursor, cursor+chunk) per shard: the idle-work
    unit. Returns (pruned', cursor' [P] int32, n_pruned [P] int32). Wraps
    around, so repeated idleness keeps re-checking."""
    T = max(tri_uj.shape[1], 1)
    steps = torch.arange(chunk, dtype=torch.int32, device=cursor.device)
    idx = (cursor[:, None] + steps[None, :]) % T
    drop = _drop_mask(w_all, pruned, _take(tri_uj, idx), _take(tri_ui, idx),
                      _take(tri_ij, idx), _take(tri_valid, idx))
    new_pruned = _or_scatter(pruned, _take(tri_uj, idx), drop)
    n_pruned = (new_pruned.sum(1) - pruned.sum(1)).to(torch.int32)
    return new_pruned, ((cursor + chunk) % T).to(torch.int32), n_pruned
