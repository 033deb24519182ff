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

from repro_torch.distributed.collectives import psum_named
from repro_torch.distributed.sharding import ambient_mesh
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


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32. Under a mesh of
    processes (the ambient one, ``launch.mesh.use_mesh``, given ``specs``,
    the tree of the leaves' ``PartitionSpec``s) the leaves are this rank's
    shards: each rank's squares are summed once over the whole mesh, a
    leaf's copies on the ranks its spec does not split counted once (on
    the rank at coordinate 0 of every axis the spec does not name)."""
    mesh = None if specs is None else ambient_mesh()
    leaves = tree_leaves(tree)
    if mesh is None:
        total = 0
        for leaf in leaves:
            total = total + leaf.float().square().sum()
        return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
    coords = dict(zip(mesh.axis_names, mesh.coords()))
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf, spec in zip(leaves, tree_leaves(specs), strict=True):
        named = {a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        if all(c == 0 for a, c in coords.items() if a not in named):
            total = total + leaf.float().square().sum()
    total = psum_named(total, mesh.axis_group(mesh.axis_names))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float, specs=None):
    """(tree scaled to a global norm of at most ``max_norm``, in f32, the
    norm before scaling); ``specs`` as in ``global_norm``."""
    norm = global_norm(tree, specs)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_unflatten(tree, [g.float() * scale
                                 for g in tree_leaves(tree)]), norm


def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr_scale=1.0, *, specs=None):
    """One AdamW step on the clipped gradients. Returns (params',
    state', the gradients' global norm before clipping). Each gradient
    is clipped in f32 as its leaf is updated (``clip_by_global_norm``'s
    values), so no f32 copy of the whole gradient tree is held. Under a
    mesh the leaves are this rank's shards and ``specs`` their
    ``PartitionSpec``s (``global_norm``); the update is elementwise."""
    gnorm = global_norm(grads, specs)
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
