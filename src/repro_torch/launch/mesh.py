"""Process meshes of the multi-process ``shmap`` backend.

Port of the reference's ``launch/mesh.py: make_host_mesh``. A JAX mesh
lays devices out on named axes; here each process of a
``torch.distributed`` job is one point of the mesh, at the row-major
coordinates of its global rank, and a tuple of axis names selects the
process group that spans those axes (``HostMesh.axis_group``).

The communication backend is always the caller's: ``make_host_mesh``
takes it as a required keyword and never picks or changes one. NCCL needs
a card per process on a host, so NCCL with more processes on a host than
CUDA devices raises, naming ``backend="gloo"``, which is how several
processes share one card (gloo collectives on CUDA tensors). A mesh of one
process needs no process group: with none to join, ``make_host_mesh()``
of shape (1, 1) starts none, and nothing on it issues a collective.

``use_mesh(mesh)`` makes a mesh the ambient one for the code inside it (the
reference's ``jax.set_mesh``): the LM steps read it (``current_mesh``),
so they keep the reference's signatures.

``make_production_mesh`` is the reference's (16, 16) or (2, 16, 16) mesh
over the default process group of 256 or 512 ranks: torchrun's over NCCL,
or the production-mesh dry run's stand-in (``launch/dryrun.py``), whose
subgroups are made on its ``fake`` backend while the steps see
``"nccl"``, as they would on the cards.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import AxisGroup

BACKENDS = ("gloo", "nccl")
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


@dataclasses.dataclass(eq=False)
class HostMesh:
    """This process's place in a mesh of ``torch.distributed`` processes:
    the mesh shape and axis names, the communication backend, and this
    process's global rank (row-major over the axes)."""
    shape: tuple
    axis_names: tuple
    backend: str
    rank: int
    _groups: dict = dataclasses.field(default_factory=dict, repr=False)
    # the backend subgroups are made on, when it is not ``backend`` (the
    # dry run's stand-in group)
    group_backend: str | None = dataclasses.field(default=None, repr=False)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self) -> tuple:
        """This process's index along each axis."""
        return tuple(int(c) for c in np.unravel_index(self.rank, self.shape))

    def axis_group(self, axis_names) -> AxisGroup:
        """The processes spanning ``axis_names`` (distinct axes of this
        mesh, in the mesh's order) that share this process's coordinates
        on the other axes, with this process's row-major rank over
        ``axis_names``. All axes: the default group. A collective call on
        the first use of a proper subset (every process makes every
        subgroup), cached afterwards."""
        axes = tuple(axis_names)
        pos = [self.axis_names.index(a) if a in self.axis_names else -1
               for a in axes]
        if not axes or -1 in pos or pos != sorted(set(pos)):
            raise ValueError(
                f"axis_names {axes} must be distinct axes of the mesh "
                f"{self.axis_names}, in the mesh's order")
        sizes = tuple(self.shape[p] for p in pos)
        size = math.prod(sizes)
        rank = 0
        coords = self.coords()
        for p in pos:
            rank = rank * self.shape[p] + coords[p]
        if len(axes) == len(self.axis_names):
            return AxisGroup(None, rank, size, self.backend, sizes)
        if axes not in self._groups:
            grid = np.arange(self.size).reshape(self.shape)
            rest = [i for i in range(len(self.shape)) if i not in pos]
            members = np.moveaxis(grid, rest, list(range(len(rest))))
            members = members.reshape(-1, size)
            mine, _ = dist.new_subgroups_by_enumeration(
                [[int(r) for r in row] for row in members],
                backend=self.group_backend or self.backend)
            self._groups[axes] = mine
        return AxisGroup(self._groups[axes], rank, size, self.backend, sizes)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), *, backend: str,
                   init_method: str | None = None, rank: int | None = None,
                   world_size: int | None = None,
                   timeout: float | None = None) -> HostMesh:
    """A mesh of ``prod(shape)`` processes on named ``axes``, one of which
    is this one.

    Joins the default process group when it exists (its backend and size
    must match), else starts it: from ``init_method`` with ``rank`` and
    ``world_size`` when given (``tcp://localhost:<port>``,
    ``file://<path>``), else from the environment ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).
    ``timeout`` (seconds) bounds every collective, so a rank that never
    joins one fails the others instead of hanging them.

    ``backend`` is ``"nccl"`` (one CUDA device per process on a host; the
    process's current device becomes ``LOCAL_RANK``'s) or ``"gloo"``
    (any number of processes per card, CUDA or CPU tensors). A mesh of
    one process, with no group to join and neither ``init_method`` nor
    torchrun's environment, starts no group."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown communication backend {backend!r}; "
                         f"valid: {list(BACKENDS)}")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must pair up, "
                         "with distinct axis names")
    n = math.prod(shape)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()!r}, not the "
                f"backend={backend!r} asked for")
        world = dist.get_world_size()
    elif n == 1 and init_method is None and any(k not in os.environ
                                                for k in _ENV):
        return HostMesh(shape=shape, axis_names=axes, backend=backend,
                        rank=0)                # one process: no group
    else:
        if init_method is None:
            missing = [k for k in _ENV if k not in os.environ]
            if missing:
                raise RuntimeError(
                    "no process group to join: run under torchrun, or pass "
                    "init_method=, rank= and world_size= (missing "
                    f"environment: {', '.join(missing)})")
            world = int(os.environ["WORLD_SIZE"])
        else:
            if rank is None or world_size is None:
                raise ValueError("init_method= needs rank= and world_size=")
            world = int(world_size)
    if world != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} processes; the "
                         f"process group has {world}")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local > cards:
            raise ValueError(
                f"backend='nccl' needs one CUDA device per process: {local} "
                f"processes on this host, {cards} CUDA device(s); pass "
                "backend='gloo' to share a device between processes")
    if not dist.is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=float(timeout))
        if init_method is None:
            dist.init_process_group(backend, **kw)
        else:
            dist.init_process_group(backend, init_method=init_method,
                                    rank=int(rank), world_size=world, **kw)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank())))
    return HostMesh(shape=shape, axis_names=axes, backend=backend,
                    rank=dist.get_rank())


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The reference's production mesh: (16, 16) on ("data", "model"), or
    (2, 16, 16) on ("pod", "data", "model") with ``multi_pod``, over the
    default process group, which must hold 256 or 512 ranks: torchrun's
    (joined, or started from its environment, over NCCL: one card a
    rank), or the dry run's stand-in, a ``fake`` group (the mesh's
    subgroups are made on it, and the steps see ``"nccl"``). Raises,
    naming the sizes, when the group has another size."""
    shape, axes = PRODUCTION[bool(multi_pod)]
    n = math.prod(shape)
    if dist.is_initialized() and dist.get_world_size() != n:
        raise ValueError(
            f"the production mesh {shape} needs a process group of {n} "
            f"ranks; this one has {dist.get_world_size()}")
    if dist.is_initialized() and dist.get_backend() == "fake":
        return HostMesh(shape=shape, axis_names=axes, backend="nccl",
                        rank=dist.get_rank(), group_backend="fake")
    if not dist.is_initialized() and os.environ.get("WORLD_SIZE", str(n)) \
            != str(n):
        raise ValueError(
            f"the production mesh {shape} needs {n} ranks; torchrun "
            f"started {os.environ['WORLD_SIZE']}")
    return make_host_mesh(shape, axes, backend="nccl")


_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: HostMesh | None):
    """Within the block, ``mesh`` is the ambient mesh (``current_mesh``)
    that the LM steps shard over; None means one process."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> HostMesh | None:
    return _MESH.get()
