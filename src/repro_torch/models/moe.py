"""Top-k routed MoE FFN with sort-based dispatch (the reference's
``models/moe.py``).

Tokens are viewed as ``[G, Tg, D]``; the routing (a stable sort of the
``(token, k)`` assignments by expert), the capacity masking and the
expert buffers are per group, with group-local capacity
``Cg = max(int(Tg * k / E * capacity_factor), 1)``: a floor, as the
reference's code computes it (its docstring says ceil). Assignments past
an expert's capacity are dropped, in ``(token, k)`` order. One gather
builds the expert buffers ``[E, Cg, D]`` (its backward a scatter-add),
batched products run every expert, and one gather of each token's ``k``
slots with a weighted sum combines them.

The port runs on one device. The reference splits the tokens into one
group per data shard and places the buffers and weights over the mesh;
here ``moe_ffn`` takes the number of groups (``groups``, halved until it
divides the tokens, as the reference's ``gspmd`` branch does) and the
model passes 1. On one model shard the reference's two impls compute the
same function (its ``shmap`` body with ``E_loc = E``, ``e0 = 0`` and a
psum over one shard), so the port has one code path and ``impl`` only
keeps the reference's check that ``shmap`` gets whole groups.

The routing keeps the reference's bits: top-k in ``lax.top_k``'s order
(the lower expert first among equal probabilities, ``top_k``), a stable
argsort, the left ``searchsorted``; ``slot_token``, ``pos``, ``keep`` and
``topi`` are int32 and cast to int64 only where they index.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F


def top_k(probs, k: int):
    """(values, int32 indices) of the ``k`` largest entries of each row of
    ``probs`` in ``lax.top_k``'s order: descending, the lower index first
    among equal values. ``torch.topk`` breaks ties another way; the first
    ``k`` of a stable descending sort keep the index order of equals."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].int()


def _routing_group(topi_g, E: int, k: int, Cg: int):
    """Index-level routing for one group. topi_g: [Tg, k] int. Returns
    slot_token [E*Cg] (the source token of each expert buffer slot, Tg when
    empty), pos [Tg, k] and keep [Tg, k] (each assignment's capacity slot
    and whether it survives), slot_token and pos int32."""
    Tg = topi_g.shape[0]
    dev = topi_g.device
    flat_e = topi_g.reshape(Tg * k).int()
    sorted_e, order = torch.sort(flat_e, stable=True)
    token_of = (order // k).int()
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=torch.int32, device=dev))
    pos_sorted = (torch.arange(Tg * k, device=dev)
                  - starts[sorted_e.long()]).int()
    kept_sorted = pos_sorted < Cg
    # the inverse map, expert-buffer slot -> token; dropped assignments go
    # to one extra slot that is cut off (the reference's mode="drop")
    slot_of = torch.where(kept_sorted, sorted_e * Cg + pos_sorted, E * Cg)
    slot_token = torch.full((E * Cg + 1,), Tg, dtype=torch.int32,
                            device=dev)
    slot_token[slot_of.long()] = token_of
    pos = torch.zeros(Tg * k, dtype=torch.int32, device=dev)
    pos[order] = pos_sorted
    pos = pos.reshape(Tg, k)
    return slot_token[:E * Cg], pos, pos < Cg


def _dispatch_group(xg, slot_token, E: int, Cg: int):
    """One D-wide gather builds the expert buffers [E, Cg, D] (its backward
    one scatter-add); empty slots read a zero row."""
    xz = torch.cat([xg, xg.new_zeros((1, xg.shape[1]))])
    return xz[slot_token.long()].reshape(E, Cg, xg.shape[1])


def _combine_group(out_buf, topi_g, pos, keep, topv_g, k: int):
    """One gather of every (token, k) slot and the weighted sum over k, a
    multiply then a sum (the reference's form); the weights are cast to the
    buffer's type before the product."""
    E, Cg, D = out_buf.shape
    flat = torch.cat([out_buf.reshape(E * Cg, D), out_buf.new_zeros((1, D))])
    idx = torch.where(keep, topi_g * Cg + pos, E * Cg)      # [Tg, k]
    got = flat[idx.long()]                                  # [Tg, k, D]
    w = torch.where(keep, topv_g, 0.0).to(out_buf.dtype)
    return (got * w[..., None]).sum(dim=1)


def moe_ffn(x, lp, moe_cfg, activation: str, groups: int = 1,
            impl: str = "gspmd"):
    """x: [B, S, D]. lp: w_router [D, E], w_gate / w_up [E, D, F], w_down
    [E, F, D]. Returns (y [B, S, D], aux_loss f32 scalar). ``groups``: the
    token groups with their own capacity (the reference's data shards);
    under ``impl="shmap"`` it must divide B * S, otherwise it is halved
    until it does."""
    B, S, D = x.shape
    E, k = moe_cfg.n_experts, moe_cfg.top_k
    T = B * S
    G = max(int(groups), 1)
    if impl == "shmap":
        if T % G:   # the reference asserts one token group per data shard
            raise ValueError(f"moe_impl='shmap' needs the {T} tokens to "
                             f"split into {G} equal groups")
    else:
        while T % G:
            G //= 2
    Tg = T // G
    Cg = max(int(Tg * k / E * moe_cfg.capacity_factor), 1)

    xf = x.reshape(T, D)
    logits = (xf @ lp["w_router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)
    if moe_cfg.norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)

    act = (F.silu if activation == "silu"
           else partial(F.gelu, approximate="tanh"))
    ys = []
    for g in range(G):
        rows = slice(g * Tg, (g + 1) * Tg)
        slot_token, pos, keep = _routing_group(topi[rows], E, k, Cg)
        buf = _dispatch_group(xf[rows], slot_token, E, Cg)
        h = act(torch.bmm(buf, lp["w_gate"])) * torch.bmm(buf, lp["w_up"])
        out = torch.bmm(h, lp["w_down"])                    # [E, Cg, D]
        ys.append(_combine_group(out, topi[rows], pos, keep, topv[rows], k))
    y = torch.cat(ys).reshape(B, S, D)

    # bincount's counts as a fixed-size scatter-add: bincount has no meta
    # kernel, and this runs on meta tensors (the dry run)
    top1 = topi[:, 0].long()
    frac = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, top1, torch.ones_like(top1)).float() / T
    prob = probs.mean(dim=0)
    aux = (frac * prob).sum() * E
    return y, aux
