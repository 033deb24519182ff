"""Fixed-length embedding bag (sum / mean), kernel 13.

Port of the reference's ``kernels/embedding_bag/embedding_bag.py:
embedding_bag_p``. The wrapper runs the CUDA kernel
(``csrc/embedding_bag.cu``) on CUDA tensors and its plain PyTorch version
on CPU tensors; ``embedding_bag_p_plain`` is the plain version, callable on
either device.

table [V, D] f32 or bf16; indices [B, L] int32. An index in [-V, 0) wraps to
row V + i, as in every path of the reference; an index outside [-V, V) (the
sentinel ``V`` in particular) is padding and is skipped, not counted (below
-V the reference's own paths disagree: its Pallas kernel reads row 0 and
counts it, its XLA path adds 0 and counts it);
B % bb == 0, as the reference's grid of B / bb bag tiles requires. Rows are
added in ``l`` order in float32, the mean divides by max(count, 1), and the
result is cast once to the table's type.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import check_cuda, same_card

MODES = ("sum", "mean")


def _check(indices, mode: str, bb: int):
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} is not one of {MODES}")
    if indices.dim() != 2 or indices.shape[0] % bb:
        raise ValueError(f"embedding_bag: indices {tuple(indices.shape)} are "
                         f"not [B, L] with B a multiple of bb={bb}")


def embedding_bag_p_plain(table, indices, *, mode: str = "sum", bb: int = 8):
    """The Pallas kernel's loop: per bag, the valid rows added in ``l``
    order in float32 (an index in [-V, 0) wraps, one outside [-V, V) adds
    0.0), the count beside them. Returns [B, D] in the table's type."""
    _check(indices, mode, bb)
    V, D = table.shape
    B, L = indices.shape
    acc = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    cnt = torch.zeros(B, dtype=torch.float32, device=table.device)
    for l in range(L):
        ix = indices[:, l].long()
        valid = (ix >= -V) & (ix < V)
        rows = table[torch.where(valid, ix % V, 0)].float()
        acc = acc + torch.where(valid[:, None], rows, 0.0)
        cnt = cnt + valid.float()
    if mode == "mean":
        acc = acc / torch.clamp(cnt, min=1.0)[:, None]
    return acc.to(table.dtype)


_SIGNATURES = {"embedding_bag": build.signature(3, 7)}


def embedding_bag_p(table, indices, *, mode: str = "sum", bb: int = 8,
                    interpret: bool = True):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch the kernel (a group of lanes per bag).
    ``interpret`` is the reference's keyword, accepted and ignored."""
    if not table.is_cuda:
        return embedding_bag_p_plain(table, indices, mode=mode, bb=bb)
    dev = same_card("embedding_bag", table, indices)
    _check(indices, mode, bb)
    if table.dim() != 2 or table.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} "
                         f"{table.dtype} is not [V, D] f32 or bf16")
    check_cuda("embedding_bag", table.dtype, table)
    check_cuda("embedding_bag", torch.int32, indices)
    V, D = table.shape
    B, L = indices.shape
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    size = table.element_size()
    wide = (D * size % 16 == 0 and table.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    lib = build.load("embedding_bag", _SIGNATURES)
    build.call(lib, "embedding_bag", dev, build.ptr(table),
               build.ptr(indices), build.ptr(out), B, L, V, D,
               int(table.dtype == torch.bfloat16), 16 // size if wide else 1,
               int(mode == "mean"), launch="embedding_bag")
    build.count_launch("embedding_bag")
    return out
