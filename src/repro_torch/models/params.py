"""Declarative parameter trees (the reference's ``models/params.py``).

A model declares its parameters once as a nested dict of ``ParamDef``;
``materialize`` makes the tensors by the reference's init rule from a
threefry key (``core/prng.py``), as the reference's ``materialize`` does
from ``jax.random.key``: equal seeds give the reference's weights, within
a few ulp (or, for today's callers, from a seeded ``torch.Generator``,
which gives others). ``params_from_numpy`` carries a tree of arrays
(the JAX package's parameters read out as numpy) across leaf for leaf, and
``abstract`` gives the tree as shape-only ``meta`` tensors (nothing
allocated) and ``n_params`` counts. Each ``ParamDef`` carries its
``PartitionSpec`` (``distributed/sharding.py``) and ``specs`` gives the
tree of them. Under a mesh of processes (``launch.mesh.use_mesh``)
``materialize`` draws only this process's shard of every leaf and
``abstract`` gives the shards' shapes; the shards laid together are the
one-process tensors bit for bit.

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

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              ambient_mesh, shard_ranges)

# elements of a leaf drawn at a time: the hash's int32 and f64 transients
# stay near 1 GB however large the leaf
DRAW_SLICE = 1 << 24


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    pspec: PartitionSpec = PartitionSpec()
    init: str = "normal"       # normal | zeros | ones | embed
    scale: float | None = None  # None -> 1/sqrt(fan_in)
    dtype: torch.dtype | None = None  # None -> model default


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype, or the reference's name of one ("float32", ...)."""
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _leaves(tree, path=()):
    """(path, leaf) pairs in ``jax.tree_util``'s order: a dict by sorted
    key, a tuple, list or NamedTuple in its order; None holds no leaf; a
    ``PartitionSpec`` is a leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], (*path, key))
    elif isinstance(tree, (tuple, list)) and not isinstance(tree,
                                                            PartitionSpec):
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
    if isinstance(node, tuple) and not isinstance(node, PartitionSpec):
        children = [_fill(child, it) for child in node]
        return (type(node)(*children) if hasattr(node, "_fields")
                else tuple(children))
    return None if node is None else next(it)


def _map(fn, tree):
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])


def materialize(defs, key, default_dtype=torch.float32, *, device=None):
    """Tensors for ``defs`` on ``device``: zeros, ones, or a standard normal
    drawn in float32 times ``scale`` (else ``fan_in ** -0.5``, fan_in the
    second-last axis, the last for a vector), cast to the leaf's type
    (``default_dtype`` where the leaf names none, the reference's third
    argument); the
    leaves in ``jax.tree_util``'s order, lists of layers kept as lists.
    ``device=None`` means ``cuda``, and raises without a CUDA device.

    ``key`` is a threefry key (``prng.key(seed)``), as the reference's
    ``materialize`` (``src/repro/models/params.py``) takes one: it is split
    into one key a leaf, zeros and ones leaves included, and leaf ``i``
    draws ``prng.normal`` of key ``i``, in slices of ``DRAW_SLICE``
    elements that equal one whole draw bit for bit. Under a mesh of more
    than one process (``launch.mesh.use_mesh``) each leaf is this
    process's shard by the leaf's ``pspec``, and a threefry leaf draws only
    the shard's elements, each at its index in the whole leaf
    (``prng.normal_at``). Or ``key`` is a ``torch.Generator`` living on
    ``device``, which the normal leaves draw from one after another (one
    process only)."""
    device = resolve_device(device)
    leaves = [d for _, d in _leaves(defs)]
    gen = key if isinstance(key, torch.Generator) else None
    keys = (None if gen is not None
            else prng.split(key.to(device), len(leaves)))
    mesh = ambient_mesh()
    if mesh is not None and gen is not None:
        raise ValueError("materialize under a mesh of processes draws "
                         "from a threefry key (prng.key), not a Generator")

    def make(i, d: ParamDef):
        dt = as_dtype(d.dtype or default_dtype)
        ranges = ([(0, s) for s in d.shape] if mesh is None
                  else shard_ranges(d.shape, d.pspec, mesh))
        shape = tuple(hi - lo for lo, hi in ranges)
        if d.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = d.scale if d.scale is not None else fan_in ** -0.5
        if gen is not None:
            x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device)
            return x.mul_(scale).to(dt)
        # scale rounds to f32 first, as JAX's weakly typed product does
        scale = torch.tensor(scale, dtype=torch.float32, device=device)
        out = torch.empty(shape, dtype=dt, device=device)
        flat = out.view(-1)
        whole = shape == tuple(d.shape)
        for o in range(0, flat.numel(), DRAW_SLICE):
            m = min(DRAW_SLICE, flat.numel() - o)
            if whole and o + m < 1 << 31:
                x = prng.normal(keys[i], (m,), o)
            else:   # a shard, or a leaf past 2**31 elements
                x = prng.normal_at(keys[i], torch.arange(
                    o, o + m, dtype=torch.int64, device=device) if whole
                    else _whole_index(d.shape, ranges, o, m, device))
            flat[o:o + m] = (x * scale).to(dt)
        return out

    return tree_unflatten(defs, [make(i, d) for i, d in enumerate(leaves)])


def _whole_index(shape, ranges, o: int, m: int, device) -> torch.Tensor:
    """Flat indices in a whole tensor of ``shape`` of elements ``[o, o +
    m)`` of its block ``ranges`` (row-major both), int64."""
    p = torch.arange(o, o + m, dtype=torch.int64, device=device)
    idx = torch.zeros_like(p)
    stride = 1
    for size, (lo, hi) in zip(reversed(shape), reversed(ranges)):
        p, c = p.div(hi - lo, rounding_mode="floor"), p % (hi - lo)
        idx += (c + lo) * stride
        stride *= size
    return idx


def value_and_grad(loss_f, params, *args):
    """(loss, grads) of ``loss_f(params, *args)``: the gradient of every
    leaf of ``params`` (a tree of tensors, left as it is) in its leaf's
    type; a leaf the loss does not reach gets zeros, as ``jax.grad``
    gives it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_f(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])


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
    tree). Under a mesh of processes, the shapes of this process's
    shards."""
    mesh = ambient_mesh()

    def one(d):
        shape = d.shape if mesh is None else tuple(
            hi - lo for lo, hi in shard_ranges(d.shape, d.pspec, mesh))
        return torch.empty(shape, dtype=as_dtype(d.dtype or default_dtype),
                           device="meta")

    return _map(one, defs)


def specs(defs):
    """The tree of every leaf's ``PartitionSpec``."""
    return _map(lambda d: d.pspec, defs)


def shardings(defs, mesh):
    """The tree of every leaf's ``NamedSharding`` on ``mesh`` (what a
    sharded checkpoint's save and restore take)."""
    return _map(lambda d: NamedSharding(mesh, d.pspec), defs)


def n_params(defs) -> int:
    return sum(math.prod(d.shape) for _, d in _leaves(defs))
