"""Fault-tolerant tree checkpointing (the reference's
``checkpoint/checkpoint.py``), on the reference's on-disk layout.

Layout (one directory per step, atomic via rename-on-commit):

  <dir>/step_00000123.tmp/...   while writing
  <dir>/step_00000123/
      meta.json                 {step, n_leaves, treedef, shapes, dtypes}
      leaf_00000.npy ...        one .npy per leaf

Leaves are numbered in ``jax.tree_util``'s flattening order
(``models.params.tree_leaves``: dicts by sorted key, tuples and NamedTuples
in field order), so leaf *i* of ``(params, AdamWState(step, m, v))`` is
the same tensor in a checkpoint of either package. A bfloat16 leaf is
stored as the reference stores it (numpy sees ml_dtypes' bfloat16 and
writes raw 2-byte words, ``'<V2'``): its bits, read back as bits; the meta
names it ``"bfloat16"``.

Restart semantics:
  - save is crash-safe: a partially written step never has the committed
    name, so ``latest_step`` only ever sees complete checkpoints;
  - ``restore_checkpoint`` takes the target tree (tensors, or the
    ``meta`` tensors of ``params.abstract``) and puts each leaf, cast to
    the target leaf's type, on ``device``: by default the target leaf's
    own, which a ``meta`` target has not, so it then needs ``device``;
  - ``CheckpointManager`` keeps the newest K steps and prunes older ones.

Elastic restore: a tree sharded over a mesh of processes is saved whole,
on the same layout, given ``shardings`` (a matching tree of
``NamedSharding``; ``PartitionSpec()`` for a leaf every rank holds
whole): every rank gathers each leaf (``sharding.gather_full``), rank 0
writes, and the save returns on every rank once the step is committed. The
checkpoint is layout-agnostic, so ``restore_checkpoint(...,
shardings=...)`` puts each rank's shard of every leaf onto any mesh
(``sharding.local_shard``), whatever mesh, or none, wrote it.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import gather_full, local_shard
from repro_torch.models.params import tree_leaves, tree_unflatten


def _treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure(tree))``
    writes it (the meta's ``treedef``; nothing reads it back)."""
    def walk(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{key!r}: {walk(node[key])}"
                                   for key in sorted(node)) + "}"
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(walk(c) for c in node) + "])")
        if isinstance(node, (tuple, list)):
            inner = ", ".join(walk(c) for c in node)
            if isinstance(node, list):
                return f"[{inner}]"
            return f"({inner},)" if len(node) == 1 else f"({inner})"
        return "None" if node is None else "*"
    return f"PyTreeDef({walk(tree)})"


def _to_numpy(leaf):
    """(array to save, dtype name): a bfloat16 tensor as its 2-byte words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def _shardings(tree, shardings) -> list:
    """One ``NamedSharding`` (or None: no mesh) a leaf of ``tree``."""
    if shardings is None:
        return [None] * len(tree_leaves(tree))
    return tree_leaves(shardings)


def _mesh_of(shardings):
    """The mesh of more than one process the shardings place leaves on,
    else None."""
    if shardings is not None:
        for sh in tree_leaves(shardings):
            if sh.mesh.size > 1:
                return sh.mesh
    return None


def save_checkpoint(directory: str, step: int, tree, shardings=None) -> str:
    """Write ``tree`` as step ``step`` (crash-safe). With ``shardings``
    the leaves are this rank's shards: every rank of the mesh calls this,
    each leaf is gathered whole, rank 0 alone writes, and every rank
    returns once the step is committed."""
    leaves = tree_leaves(tree)
    mesh = _mesh_of(shardings)
    if mesh is not None:
        leaves = [gather_full(leaf, sh.spec, sh.mesh) for leaf, sh in zip(
            leaves, _shardings(tree, shardings), strict=True)]
    if mesh is None or mesh.rank == 0:
        _write(directory, step, tree, leaves)
    if mesh is not None:
        dist.barrier()
    return os.path.join(directory, f"step_{step:08d}")


def _write(directory: str, step: int, tree, leaves):
    os.makedirs(directory, exist_ok=True)
    name = f"step_{step:08d}"
    final = os.path.join(directory, name)
    tmp = os.path.join(directory, name + ".tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shapes, dtypes = [], []
    for i, leaf in enumerate(leaves):
        arr, dt = _to_numpy(leaf)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
        shapes.append(list(arr.shape))
        dtypes.append(dt)
    meta = {"step": step, "n_leaves": len(leaves),
            "treedef": _treedef(tree), "shapes": shapes, "dtypes": dtypes}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic commit


def _steps(directory: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target_tree,
                       shardings=None, device=None):
    """The checkpoint of ``step`` shaped as ``target_tree`` (tensors, or the
    ``meta`` tensors of ``params.abstract``), each leaf cast to its target
    leaf's type and put on ``device``, by default the target leaf's device.
    A ``meta`` target leaf, or one that is no tensor, needs ``device``
    (``None`` then means ``cuda``, as everywhere in the port).
    ``shardings`` (a matching tree of ``NamedSharding``) gives each leaf as
    this rank's shard on its mesh: the elastic restore onto the live
    mesh."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        names = json.load(f)["dtypes"]
    out = []
    for i, (t, sh) in enumerate(zip(tree_leaves(target_tree),
                                    _shardings(target_tree, shardings),
                                    strict=True)):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        leaf = _from_numpy(arr, names[i])
        if sh is not None:
            leaf = local_shard(leaf, sh.spec, sh.mesh).contiguous()
        if isinstance(t, torch.Tensor):
            dev = t.device if device is None and not t.is_meta else (
                resolve_device(device))
            leaf = leaf.to(device=dev, dtype=t.dtype)
        else:
            leaf = leaf.to(resolve_device(device))
        out.append(leaf)
    return tree_unflatten(target_tree, out)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree, shardings=None):
        path = save_checkpoint(self.directory, step, tree, shardings)
        mesh = _mesh_of(shardings)
        if mesh is None or mesh.rank == 0:     # the writer prunes
            self._prune()
        return path

    def _prune(self):
        for s in sorted(_steps(self.directory))[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"))

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def restore(self, target_tree, shardings=None, step: int | None = None,
                device=None):
        s = step if step is not None else self.latest()
        if s is None:
            return None, None
        return restore_checkpoint(self.directory, s, target_tree, shardings,
                                  device), s
