"""Mesh-axis conventions shared by the LM family, and the placement of a
tensor over a mesh of processes (the reference's
``distributed/sharding.py``).

Single-pod mesh: (data=16, model=16). Multi-pod: (pod=2, data=16, model=16)
— the pod axis joins the data/FSDP group. ``MeshAxes`` names the axes that
carry the batch and the FSDP shards (``data``) and the one that carries
tensor and expert parallelism (``model``).

A ``PartitionSpec`` says, dimension by dimension, which mesh axes split a
tensor: ``None`` (whole), an axis name, or a tuple of axis names (their
row-major product). It is the port's own: a plain tuple, nothing of JAX.
Where the reference's GSPMD places a dimension that does not divide by its
axes, it pads; here rank ``i`` of ``n`` along a dimension of size ``s``
holds the block ``[i * b, min((i + 1) * b, s))`` with ``b = ceil(s / n)``,
the same blocks, so a trailing rank may hold fewer rows or none.
``local_shard`` takes this process's block of a whole tensor and
``gather_full`` puts the whole back together from every rank's block (an
all-gather a sharded dimension, over ``HostMesh.axis_group``). An axis a
spec names that the mesh lacks counts as size 1, as on the reference's
smaller meshes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed.collectives import (AxisGroup, all_gather_dim,
                                                 all_gather_tiled,
                                                 copy_to_group)


class PartitionSpec(tuple):
    """``PartitionSpec(None, "model", ("pod", "data"))``: one entry a
    dimension, trailing dimensions whole; an entry of one axis name is that
    name, as JAX's spec writes it (``("data",)`` -> ``"data"``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: tuple          # axes carrying batch/FSDP shards, e.g. ("pod","data")
    model: str = "model"
    data_shards: int = 1  # product of data-axis sizes (static hierarchy hint
                          # for shard-local algorithms, e.g. MoE dispatch)

    @property
    def all(self):
        return (*self.data, self.model)

    # common activation/param specs
    def batch(self, *rest):
        return P(self.data, *rest)

    def fsdp_tp(self, *, prefix=()):
        """[..., fsdp_dim, tp_dim] param spec."""
        return P(*prefix, self.data, self.model)


SINGLE_POD = MeshAxes(data=("data",), data_shards=16)
MULTI_POD = MeshAxes(data=("pod", "data"), data_shards=32)


def mesh_axes(multi_pod: bool) -> MeshAxes:
    return MULTI_POD if multi_pod else SINGLE_POD


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor's placement: ``spec`` over ``mesh`` (a ``HostMesh``)."""
    mesh: object
    spec: PartitionSpec


def entry_axes(entry, mesh) -> tuple:
    """The axes of ``mesh`` a spec entry names, in the mesh's order."""
    if entry is None:
        return ()
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    return tuple(a for a in mesh.axis_names if a in names)


def axes_group(mesh, axes) -> AxisGroup | None:
    """The group spanning ``axes`` of ``mesh`` (None when they hold one
    process: nothing to exchange)."""
    axes = tuple(a for a in mesh.axis_names if a in axes)
    if not axes or math.prod(mesh.shape[mesh.axis_names.index(a)]
                             for a in axes) == 1:
        return None
    return mesh.axis_group(axes)


def block(size: int, n: int, i: int) -> tuple[int, int]:
    """Rank ``i`` of ``n``'s rows ``[lo, hi)`` of a dimension of ``size``."""
    b = -(-size // n)
    return min(i * b, size), min((i + 1) * b, size)


def whole_size(n_local: int, ag: AxisGroup, device) -> int:
    """The whole length of a dimension that the ranks of ``ag`` hold in
    ``block``'s blocks, ``n_local`` rows of it here: the blocks' lengths
    summed over the group (a collective, read on the host). On the
    ``meta`` device, where tensors carry no values (the dry run), the
    blocks are even: ``n_local`` times the group's size, which the
    registry's cells make exact (their node, edge and candidate counts
    divide both production meshes)."""
    if torch.device(device).type == "meta":
        return n_local * ag.size
    n = torch.tensor([n_local], dtype=torch.int64, device=device)
    return int(all_gather_tiled(n, ag).sum())


def _position(mesh, axes) -> tuple[int, int]:
    """(this process's row-major index over ``axes``, their size)."""
    coords = mesh.coords()
    i, n = 0, 1
    for a in axes:
        k = mesh.axis_names.index(a)
        i, n = i * mesh.shape[k] + coords[k], n * mesh.shape[k]
    return i, n


def shard_ranges(shape, spec, mesh) -> list[tuple[int, int]]:
    """This process's ``[lo, hi)`` along every dimension of a tensor of
    ``shape`` placed by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, spec):
        i, n = _position(mesh, entry_axes(entry, mesh))
        out.append(block(size, n, i))
    return out


def local_shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This process's row-major block of the whole tensor ``x`` along every
    dimension ``spec`` shards (a view when it can be one)."""
    for d, (lo, hi) in enumerate(shard_ranges(x.shape, spec, mesh)):
        if (lo, hi) != (0, x.shape[d]):
            x = x.narrow(d, lo, hi - lo)
    return x


def gather_full(x: torch.Tensor, spec, mesh, shape=None) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` (the inverse of
    ``local_shard``): an all-gather over the axes of each sharded
    dimension. ``shape`` is the whole tensor's; without it the ranks
    first gather the sizes of their blocks. A collective: every rank of
    the mesh calls it, in the same order."""
    spec = tuple(spec)
    for d in range(len(spec)):
        ag = axes_group(mesh, entry_axes(spec[d], mesh))
        if ag is None:
            continue
        if shape is None:
            n = torch.tensor([x.shape[d]], dtype=torch.int64,
                             device=x.device)
            size = int(all_gather_tiled(n, ag).sum())
        else:
            size = shape[d]
        x = all_gather_dim(x, ag, d, size)
    return x


# --------------------------------------------------------------------------
# the LM steps' view of the ambient mesh
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Placement:
    """Where this process sits for ``MeshAxes`` ``ax`` on a mesh: the group
    of its ``data`` axes and of its ``model`` axis (None where one process),
    their sizes ``d`` and ``m``, and its index along each."""
    data: AxisGroup | None
    model: AxisGroup | None
    d: int
    m: int
    di: int
    mi: int


def ambient_mesh():
    """The mesh ``launch.mesh.use_mesh`` made ambient when it holds more
    than one process, else None (nothing to shard or exchange)."""
    from repro_torch.launch.mesh import current_mesh
    mesh = current_mesh()
    return None if mesh is None or mesh.size == 1 else mesh


def placement(ax: MeshAxes) -> Placement | None:
    """``ax`` on the ambient mesh; None with no mesh or a mesh of one
    process, where the steps issue no collective."""
    mesh = ambient_mesh()
    if mesh is None:
        return None
    data = entry_axes(tuple(ax.data), mesh)
    model = entry_axes(ax.model, mesh)
    di, d = _position(mesh, data)
    mi, m = _position(mesh, model)
    return Placement(axes_group(mesh, data), axes_group(mesh, model), d, m,
                     di, mi)


def is_data_sharded(entry, ax: MeshAxes) -> bool:
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return any(a in names for a in ax.data)


def use_weight(w: torch.Tensor, spec, pl: Placement | None, ax: MeshAxes,
               size: int, model_partial: bool = False) -> torch.Tensor:
    """A stored weight in its use layout (the reference's ``_use``, the
    ZeRO-3 gather where it is used): every dimension ``spec`` shards over
    the ``data`` axes gathered whole (``size`` rows; the backward
    reduce-scatters its gradient over ``data``); the ``model`` shard stays
    local. A weight ``data`` does not shard has its gradient summed over
    ``data`` instead, and one each ``model`` rank uses on a part of the
    work (``model_partial``: QK-norm on a rank's own heads) over
    ``model``."""
    if pl is None:
        return w
    sharded = False
    for dim, entry in enumerate(spec):
        if is_data_sharded(entry, ax):
            w = all_gather_dim(w, pl.data, dim, size)
            sharded = True
    if not sharded:
        w = copy_to_group(w, pl.data)
    return copy_to_group(w, pl.model) if model_partial else w
