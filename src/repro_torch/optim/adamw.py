"""AdamW with global-norm clipping (the reference's ``optim/adamw.py``).

The optimizer state mirrors the parameter tree (nested dicts of tensors,
as ``models/params.py`` makes them): f32 first and second moments per
leaf, and the step count. Each update runs in f32 and casts the new
parameter back to its own type, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: object            # the parameter tree's shape, f32 leaves
    v: object


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        m=tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                                  for p in leaves]),
        v=tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device)
                                  for p in leaves]))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, in f32, the
    norm before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_unflatten(tree, [g.float() * scale
                                 for g in tree_leaves(tree)]), norm


def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step on the clipped gradients. Returns (params',
    state', the gradients' global norm before clipping). Each gradient
    is clipped in f32 as its leaf is updated (``clip_by_global_norm``'s
    values), so no f32 copy of the whole gradient tree is held."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.full_like(t, cfg.b1), t)
    bc2 = 1.0 - torch.pow(torch.full_like(t, cfg.b2), t)
    lr = cfg.lr * lr_scale
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v),
                          strict=True):
        g32 = g.float() * clip
        m2 = cfg.b1 * m + (1 - cfg.b1) * g32
        v2 = cfg.b2 * v + (1 - cfg.b2) * g32.square()
        mh = m2 / bc1
        vh = v2 / bc2
        p32 = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        new_p.append((p32 - lr * delta).to(p.dtype))
        new_m.append(m2)
        new_v.append(v2)
    return (tree_unflatten(params, new_p),
            AdamWState(step=step, m=tree_unflatten(params, new_m),
                       v=tree_unflatten(params, new_v)), gnorm)
