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

Under a mesh of processes (``launch.mesh.use_mesh``) the tokens of a
``data`` rank are its ``G / d`` groups (``G = ax.data_shards`` token
groups over the whole batch, as the reference's ``G``), and the experts
are split over ``model``: ``_expert_block_shmap`` (the reference's
``shard_map`` body) has each ``model`` rank run only its own ``E / m``
experts on its data row's tokens, combine the ``(token, k)`` slots that
fall to them (``mine``) into a partial ``[Tg, D]``, and one ``psum`` over
``model`` finishes the combine. The reference's ``gspmd`` impl computes
the same function (GSPMD places the buffers ``[G, E, Cg, D]`` over
``(data, model)`` and all-reduces the gathered partials), so both impls
take this code path here; ``impl`` keeps the reference's check that
``shmap`` gets whole groups. With one process, or one ``model`` rank,
the block is the reference's with ``E_loc = E`` and ``e0 = 0``. The
router's statistics for the aux loss are over the whole batch.

The routing keeps the reference's bits: top-k in ``lax.top_k``'s order
(the lower expert first among equal probabilities, ``top_k``), a stable
argsort, the left ``searchsorted``; ``slot_token``, ``pos``, ``keep`` and
``topi`` are int32 and cast to int64 only where they index.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (copy_to_group, psum_named,
                                                 reduce_from_group)
from repro_torch.distributed.sharding import placement, use_weight


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


def _expert_block_shmap(xg, slot_token, topi_g, pos, keep, topv_g,
                        w_gate, w_up, w_down, act, e0: int, Cg: int):
    """One group's expert compute and combine on this ``model`` rank's
    experts ``[e0, e0 + E_loc)`` (``w_*`` hold just those): their buffers
    from the group's slots, the batched products, and the weighted sum of
    the ``(token, k)`` slots that fall to them (``mine``), a partial
    ``[Tg, D]`` that the ``psum`` over ``model`` completes."""
    E_loc = w_gate.shape[0]
    buf = _dispatch_group(xg, slot_token[e0 * Cg:(e0 + E_loc) * Cg], E_loc,
                          Cg)
    h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.bmm(h, w_down)                              # [E_loc, Cg, D]
    e_rel = topi_g - e0
    mine = keep & (e_rel >= 0) & (e_rel < E_loc)
    flat = torch.cat([out.reshape(E_loc * Cg, -1),
                      out.new_zeros((1, out.shape[-1]))])
    got = flat[torch.where(mine, e_rel * Cg + pos, E_loc * Cg).long()]
    w = torch.where(mine, topv_g, 0.0).to(out.dtype)
    return (got * w[..., None]).sum(dim=1)


def moe_ffn(x, lp, moe_cfg, activation: str, ax, impl: str = "gspmd"):
    """x: [B, S, D]. lp: w_router [D, E], w_gate / w_up [E, D, F], w_down
    [E, F, D]. Returns (y [B, S, D], aux_loss f32 scalar). ``ax``: the
    ``MeshAxes``; its ``data_shards`` are the token groups with their own
    capacity; under ``impl="shmap"`` they must divide B * S, otherwise
    they are halved until they do. Under a mesh ``x`` is this rank's rows
    and ``lp`` its shards (``models/transformer.py: param_defs``)."""
    B, S, D = x.shape
    E, k = moe_cfg.n_experts, moe_cfg.top_k
    pl = placement(ax)
    d, m = (1, 1) if pl is None else (pl.d, pl.m)
    T = B * S * d                                   # the whole batch's
    G = max(int(ax.data_shards), 1)
    if impl == "shmap":
        if T % G:   # the reference asserts one token group per data shard
            raise ValueError(f"moe_impl='shmap' needs the {T} tokens to "
                             f"split into {G} equal groups")
    else:
        while T % G:
            G //= 2
    if G % d or E % m:
        raise ValueError(f"the MoE FFN splits {G} token groups over {d} "
                         f"data ranks and {E} experts over {m} model ranks")
    G //= d                                         # this rank's groups
    Tg = T // d // G
    Cg = max(int(Tg * k / E * moe_cfg.capacity_factor), 1)

    def use(name, spec):
        return use_weight(lp[name], spec, pl, ax, D)

    xf = x.reshape(B * S, D)
    logits = (xf @ use("w_router", (ax.data, None)).to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, k)
    if moe_cfg.norm_topk:
        topv = topv / topv.sum(dim=-1, keepdim=True)

    act = (F.silu if activation == "silu"
           else partial(F.gelu, approximate="tanh"))
    w_gate = use("w_gate", (ax.model, ax.data, None))
    w_up = use("w_up", (ax.model, ax.data, None))
    w_down = use("w_down", (ax.model, None, ax.data))
    model = None if pl is None else pl.model
    e0 = 0 if pl is None else pl.mi * (E // m)
    xe, we = copy_to_group(xf, model), copy_to_group(topv, model)
    ys = []
    for g in range(G):
        rows = slice(g * Tg, (g + 1) * Tg)
        slot_token, pos, keep = _routing_group(topi[rows], E, k, Cg)
        if model is None:
            buf = _dispatch_group(xe[rows], slot_token, E, Cg)
            h = act(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
            out = torch.bmm(h, w_down)                      # [E, Cg, D]
            ys.append(_combine_group(out, topi[rows], pos, keep, we[rows],
                                     k))
        else:
            ys.append(_expert_block_shmap(
                xe[rows], slot_token, topi[rows], pos, keep, we[rows],
                w_gate, w_up, w_down, act, e0, Cg))
    y = torch.cat(ys).reshape(B, S, D)
    if model is not None:   # the EP combine
        y = reduce_from_group(y, model)

    # bincount's counts as a fixed-size scatter-add: bincount has no meta
    # kernel, and this runs on meta tensors (the dry run)
    top1 = topi[:, 0].long()
    counts = torch.zeros(E, dtype=torch.int64, device=x.device).scatter_add_(
        0, top1, torch.ones_like(top1))
    data = None if pl is None else pl.data
    if data is None:
        frac = counts.float() / T
        prob = probs.mean(dim=0)
    else:
        frac = psum_named(counts, data).float() / T
        prob = reduce_from_group(probs.sum(dim=0), data) / T
    aux = (frac * prob).sum() * E
    return y, aux

