"""Declarative parameter trees (the reference's ``models/params.py``).

A model declares its parameters once as a nested dict of ``ParamDef``;
``materialize`` makes the tensors from a seeded ``torch.Generator`` by the
reference's init rule, ``params_from_numpy`` carries a tree of arrays
(the JAX package's parameters read out as numpy) across leaf for leaf, and
``abstract`` gives the tree as shape-only ``meta`` tensors (nothing
allocated) and ``n_params`` counts. The port runs on one device, so a
``ParamDef`` has no partition spec; the reference's ``specs`` serves its
sharding and is not ported.

Trees are nested dicts, tuples, lists and NamedTuples (an optimizer
state) with tensors at the leaves; ``tree_leaves`` flattens them in
``jax.tree_util``'s order, so leaf *i* of a tree is the same leaf in both
packages (what a checkpoint's file names rely on).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"       # normal | zeros | ones | embed
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: torch.dtype | None = None  # None -> model default


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the reference's name of one ("float32", ...)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _leaves(tree, path=()):
    """(path, leaf) pairs in ``jax.tree_util``'s order: a dict by sorted
    key, a tuple, list or NamedTuple in its order; None holds no leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, key))
    elif isinstance(tree, (tuple, list)):
        for i, child in enumerate(tree):
            yield from _leaves(child, (*path, i))
    elif tree is not None:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``jax.tree_util.tree_leaves``' order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` (``tree_leaves``'
    order)."""
    return _fill(like, iter(leaves))


def _fill(node, it):
    # a module-level recursion: a self-referencing closure would be a
    # reference cycle holding ``leaves`` until the collector runs
    if isinstance(node, dict):
        return {key: _fill(node[key], it) for key in sorted(node)}
    if isinstance(node, list):
        return [_fill(child, it) for child in node]
    if isinstance(node, tuple):
        children = [_fill(child, it) for child in node]
        return (type(node)(*children) if hasattr(node, "_fields")
                else tuple(children))
    return None if node is None else next(it)


def _map(fn, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def materialize(defs, generator: torch.Generator, *, device=None,
                default_dtype=torch.float32):
    """Tensors for ``defs`` on ``device``: zeros, ones, or a standard normal
    drawn in float32 times ``scale`` (else ``fan_in ** -0.5``, fan_in the
    second-last axis, the last for a vector), cast to the leaf's type. The
    leaves draw from ``generator`` one after another in sorted-key order;
    the generator must live on ``device``. ``device=None`` means ``cuda``,
    and raises without a CUDA device."""
    device = resolve_device(device)

    def make(d: ParamDef):
        dt = as_dtype(d.dtype or default_dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else fan_in ** -0.5
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dt)

    out = {}
    for path, d in _leaves(defs):   # draw in a fixed order
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = make(d)
    return out


def params_from_numpy(tree, *, device=None, dtype=None):
    """A nested dict of numpy arrays -> the same tree of tensors on
    ``device``, cast to ``dtype`` when given. A bfloat16 array (numpy sees
    ml_dtypes' type, which torch cannot read) passes through float32, which
    holds every bfloat16 value exactly, and comes back as bfloat16.
    ``device=None`` means ``cuda``, and raises without a CUDA device."""
    device = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        bf16 = a.dtype.name == "bfloat16"
        t = torch.from_numpy(np.array(a.astype(np.float32) if bf16 else a))
        t = t.to(as_dtype(dtype) or (torch.bfloat16 if bf16 else t.dtype))
        return t.to(device)

    return _map(conv, tree)


def abstract(defs, default_dtype=torch.float32):
    """The tree ``defs`` declares as ``meta`` tensors of its shapes and
    types: nothing is allocated (the reference's ``ShapeDtypeStruct``
    tree)."""
    return _map(lambda d: torch.empty(
        d.shape, dtype=as_dtype(d.dtype or default_dtype), device="meta"),
        defs)


def n_params(defs) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(defs))
