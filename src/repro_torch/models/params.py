"""Declarative parameter trees (the reference's ``models/params.py``).

A model declares its parameters once as a nested dict of ``ParamDef``;
``materialize`` makes the tensors from a seeded ``torch.Generator`` by the
reference's init rule, ``params_from_numpy`` carries a tree of arrays
(the JAX package's parameters read out as numpy) across leaf for leaf, and
``n_params`` counts. The port runs on one device, so a ``ParamDef`` has no
partition spec; the reference's ``abstract`` and ``specs`` serve its dry run
and sharding and are not ported.
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
    """(path, leaf) pairs in sorted-key order, as jax.tree_util flattens a
    dict."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, key))
    else:
        yield path, tree


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order, as
    ``jax.tree_util.tree_leaves`` flattens a dict."""
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
    return next(it)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {key: _map(fn, val) for key, val in tree.items()}
    return fn(tree)


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


def n_params(defs) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(defs))
