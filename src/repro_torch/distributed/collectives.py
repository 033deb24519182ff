"""Collectives of the ``shmap`` backend over ``torch.distributed``.

Port of the reference's ``distributed/collectives.py``. The reference's
helpers run inside a ``shard_map`` body and name the mesh axes they reduce
over; here each process is one shard, and the helpers take an
``AxisGroup``: the process group spanning those axes with this process's
flat rank in it (``launch/mesh.py: HostMesh.axis_group``). Ranks follow
the reference's row-major order over the axes, which is the order of the
group's ranks, so a ``[P, ...]``-leading array of the sim backend is laid
out one row a rank.

Every helper is functional (its input is left as it was) and is a
collective: every rank of the group must call it, in the same order.

Three collectives carry everything: ``all_reduce``, ``all_to_all_single``
and ``all_gather_single``. Gloo takes CUDA tensors in all three (PyTorch
2.11 on an H100, 4 and 8 processes sharing the card), so under gloo a CUDA
tensor goes to the collective as it is and nothing is staged through host
memory. Gloo's point-to-point send of a CUDA tensor aborts the process
there (``writev: Bad address``), so the rings are an ``all_to_all_single``
whose split sizes send the whole operand to one neighbour, not an
``isend``/``irecv`` pair.

``recording()`` switches on a record of the collectives the helpers
issue (kind, bytes, group size), which the production-mesh dry run reads
(``launch/hlo_analysis.py: collective_bytes``); off, it costs each call
one ``None`` check.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple

import torch
import torch.distributed as dist


class Collective(NamedTuple):
    """One collective as issued: its kind (the reference's HLO names:
    ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``), its bytes (the all-reduce's operand, the
    all-gather's result, the reduce-scatter's input, the all-to-all's and
    the permute's operand: what the reference's wire formulas take) and
    the size of its group."""
    kind: str
    nbytes: int
    group_size: int


_RECORD: list | None = None


@contextlib.contextmanager
def recording():
    """Within the block, every collective the helpers of this module
    issue is appended, as a ``Collective``, to the list this yields."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(kind: str, x: torch.Tensor, ag) -> None:
    if _RECORD is not None:
        _RECORD.append(Collective(kind, x.numel() * x.element_size(),
                                  ag.size))

class AxisGroup(NamedTuple):
    """The processes spanning a tuple of mesh axes: their process group
    (None for the default group), this process's row-major flat rank over
    the axes, their number, the communication backend, and the size of
    each axis (empty when not known: then one axis of ``size``)."""
    group: Any
    rank: int
    size: int
    backend: str
    sizes: tuple = ()


def axis_sizes(ag: AxisGroup) -> tuple[int, ...]:
    """The size of each mesh axis the group spans, in the mesh's order."""
    return tuple(ag.sizes) or (ag.size,)


def flat_rank(ag: AxisGroup) -> int:
    """Row-major flattened rank over the group's mesh axes."""
    return ag.rank


def flat_size(ag: AxisGroup) -> int:
    return ag.size


def _all_reduce(x: torch.Tensor, ag: AxisGroup, op) -> torch.Tensor:
    _note("all-reduce", x, ag)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=ag.group)
    return y


def pmin_named(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    return _all_reduce(x, ag, dist.ReduceOp.MIN)


def pmax_named(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    return _all_reduce(x, ag, dist.ReduceOp.MAX)


def psum_named(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Sum over the group in x's dtype (int32 wraps as the reference's
    ``lax.psum`` of int32 does)."""
    return _all_reduce(x, ag, dist.ReduceOp.SUM)


def all_reduce_min(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    return pmin_named(x, ag)


def or_reduce(flag: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Logical OR across shards (any), as an int32 max."""
    return pmax_named(flag.to(torch.int32), ag) > 0


def and_reduce(flag: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Logical AND across shards (all), as an int32 min."""
    return pmin_named(flag.to(torch.int32), ag) > 0


def _all_to_all(out, x, ag: AxisGroup, out_splits=None, in_splits=None,
                kind: str = "all-to-all"):
    _note(kind, x, ag)
    dist.all_to_all_single(out, x, out_splits, in_splits, group=ag.group)
    return out


def all_to_all_uneven(x: torch.Tensor, ag: AxisGroup, send_sizes,
                      recv_sizes) -> torch.Tensor:
    """``x`` [sum(send_sizes), ...] on each rank: rows ``send_sizes[j]``
    (in order) go to rank j -> [sum(recv_sizes), ...], the rows from rank
    i (``recv_sizes[i]`` of them) in rank order."""
    x = x.contiguous()
    out = x.new_empty((sum(recv_sizes), *x.shape[1:]))
    return _all_to_all(out, x, ag, list(recv_sizes), list(send_sizes))


def all_to_all_tiled(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """All-to-all where dim 0 of ``x`` is the partition dim: ``x`` [P, ...]
    on each rank -> [P, ...] whose row p came from rank p's row for this
    rank."""
    x = x.contiguous()
    return _all_to_all(torch.empty_like(x), x, ag)


def _ring_shift(x: torch.Tensor, ag: AxisGroup, step: int) -> torch.Tensor:
    """The whole of ``x`` to rank ``(r + step) mod P``, from rank
    ``(r - step) mod P``: one ``all_to_all_single`` whose split sizes are
    1 row for that neighbour and 0 for every other rank."""
    P, r = ag.size, ag.rank
    send = [0] * P
    recv = [0] * P
    send[(r + step) % P] = 1
    recv[(r - step) % P] = 1
    x1 = x.contiguous().unsqueeze(0)
    return _all_to_all(torch.empty_like(x1), x1, ag, recv, send,
                       kind="collective-permute")[0]


def ring_permute(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Advance ``x`` one hop along the row-major ring: afterwards the value
    rank r held lives on rank (r + 1) mod P (toka2's token transport, and
    the forward ring of ``async_ppermute``)."""
    return _ring_shift(x, ag, 1)


def ring_permute_rev(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """Retreat ``x`` one hop: the value rank r held lives on rank
    (r - 1) mod P afterwards (the backward ring of ``async_ppermute``)."""
    return _ring_shift(x, ag, -1)


def all_gather_tiled(x: torch.Tensor, ag: AxisGroup) -> torch.Tensor:
    """``x`` [n, ...] on each rank -> [P * n, ...], rank p's rows at
    ``p * n``: the shard-stacked array the sim backend holds."""
    x = x.contiguous()
    out = torch.empty((ag.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # all_gather_single where this PyTorch has it (all_gather_into_tensor
    # is its deprecated name)
    _note("all-gather", out, ag)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=ag.group)
    return out


# --------------------------------------------------------------------------
# differentiable collectives of the sharded LM steps
# --------------------------------------------------------------------------
#
# ``ag`` is None where the axes hold one process: then each is the
# identity and issues no collective.

def _gather_rows(x: torch.Tensor, ag: AxisGroup, dim: int, size: int):
    """Every rank's block of a dimension of ``size`` (``sharding.block``'s
    blocks), padded to the block size for the collective, laid end to end
    and cut back to ``size``."""
    b = -(-size // ag.size)
    x = x.movedim(dim, 0)
    if x.shape[0] < b:
        x = torch.cat([x, x.new_zeros((b - x.shape[0], *x.shape[1:]))])
    return all_gather_tiled(x, ag)[:size].movedim(0, dim)


def _scatter_sum(g: torch.Tensor, ag: AxisGroup, dim: int, lo: int,
                 hi: int):
    """The sum over the group of ``g`` (whole along ``dim``), rows
    ``[lo, hi)`` of it: a reduce-scatter. Gloo has no reduce-scatter of
    CUDA tensors in every PyTorch, so under gloo it is an all-reduce
    followed by this rank's slice."""
    if ag.backend != "nccl":
        return psum_named(g, ag).narrow(dim, lo, hi - lo)
    size = g.shape[dim]
    b = -(-size // ag.size)
    g = g.movedim(dim, 0)
    if size < b * ag.size:
        g = torch.cat([g, g.new_zeros((b * ag.size - size, *g.shape[1:]))])
    out = torch.empty((b, *g.shape[1:]), dtype=g.dtype, device=g.device)
    _note("reduce-scatter", g, ag)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, g.contiguous(), group=ag.group)
    return out[:hi - lo].movedim(0, dim)


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim, size):
        ctx.args = (ag, dim, x.shape[dim])
        return _gather_rows(x, ag, dim, size)

    @staticmethod
    def backward(ctx, g):
        ag, dim, n = ctx.args
        b = -(-g.shape[dim] // ag.size)
        lo = min(ag.rank * b, g.shape[dim])
        return _scatter_sum(g, ag, dim, lo, lo + n), None, None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag, dim):
        size = x.shape[dim]
        b = -(-size // ag.size)
        lo = min(ag.rank * b, size)
        hi = min(lo + b, size)
        ctx.args = (ag, dim, size)
        return _scatter_sum(x, ag, dim, lo, hi)

    @staticmethod
    def backward(ctx, g):
        ag, dim, size = ctx.args
        return _gather_rows(g, ag, dim, size), None, None


def reduce_scatter_dim(x: torch.Tensor, ag: AxisGroup | None,
                       dim: int) -> torch.Tensor:
    """This rank's block (``sharding.block``'s) of a dimension of the sum
    over the group of every rank's whole ``x``: a reduce-scatter, the
    adjoint of ``all_gather_dim`` (its backward gathers the blocks'
    gradients whole)."""
    if ag is None:
        return x
    return _ReduceScatterDim.apply(x, ag, dim)


def all_gather_dim(x: torch.Tensor, ag: AxisGroup | None, dim: int,
                   size: int) -> torch.Tensor:
    """The whole of a dimension of ``size`` from every rank's block ``x``
    (the FSDP gather of a weight where it is used); the backward sums the
    whole gradient over the group and hands each rank its block (a
    reduce-scatter)."""
    if ag is None:
        return x
    return _AllGatherDim.apply(x, ag, dim, size)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        ctx.ag = ag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_named(g, ctx.ag), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ag):
        return psum_named(x, ag)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, ag: AxisGroup | None) -> torch.Tensor:
    """Identity forward, all-reduce backward: where a tensor every rank of
    the group holds whole enters work that each rank does a part of (the
    input of a column-parallel product), the parts' gradients add up."""
    return x if ag is None else _CopyToGroup.apply(x, ag)


def reduce_from_group(x: torch.Tensor, ag: AxisGroup | None
                      ) -> torch.Tensor:
    """All-reduce forward, identity backward: the sum of every rank's
    partial (the row-parallel ``psum``)."""
    return x if ag is None else _ReduceFromGroup.apply(x, ag)


def max_over_group(x: torch.Tensor, ag: AxisGroup | None) -> torch.Tensor:
    """Elementwise max over the group, no gradient."""
    return x.detach() if ag is None else pmax_named(x.detach(), ag)
