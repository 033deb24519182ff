"""Flash attention forward (online softmax, GQA-aware), kernel 12.

Port of the reference's ``kernels/flash_attention/flash_attention.py:
flash_attention_p``. On CUDA tensors the wrapper launches one of two CUDA
kernels on Hopper's tensor cores (TMA loads, ``wgmma`` products, a producer
warpgroup and consumer warpgroups), chosen by the inputs' type alone: bf16
takes ``csrc/flash_attention_tc.cu`` (bf16 products, P split into bf16 hi +
lo; counter ``flash_attention_tc``), f32 ``csrc/flash_attention.cu`` (every
product in 3xTF32; counter ``flash_attention``). On CPU tensors it runs the
plain PyTorch version, ``flash_attention_p_plain``, which is callable on
either device and is the plain version of both kernels.

q [B, Hq, Sq, D]; k/v [B, Hkv, Skv, D], pre-padded: Sq a multiple of
``block_q`` and Skv of ``block_k`` (the reference's grid of whole tiles).
Key columns ``>= kv_len`` are padding. Query head h reads kv head
``h // (Hq // Hkv)``; no repeated KV is made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import same_card

HEAD_DIMS = (16, 32, 64, 128, 256)   # the head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, kv_len: int, block_q: int, block_k: int):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"[B, Hq, Sq, D] and two equal [B, Hkv, Skv, D]")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in B or D, or Hq % Hkv")
    if Sq % block_q or Skv % block_k or not 0 <= kv_len <= Skv:
        raise ValueError(f"flash_attention: Sq {Sq}, Skv {Skv} are not "
                         f"multiples of block_q {block_q}, block_k {block_k}, "
                         f"or kv_len {kv_len} is not in [0, Skv]")


def flash_attention_p_plain(q, k, v, *, scale: float, causal: bool,
                            q_offset: int, kv_len: int, block_q: int,
                            block_k: int):
    """The Pallas kernel's loop: for each kv tile of ``block_k`` in order,
    f32 scores times ``scale``, the masks ``kj < kv_len`` and (causal)
    ``qi + q_offset >= kj``, and the online-softmax update with the same
    ``isfinite`` guards; then acc / l where l > 0, else acc / 1. Every q
    tile runs the same update, so all rows go at once. Returns q's shape
    and type."""
    _check(q, k, v, kv_len, block_q, block_k)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    dev = q.device
    qh = q.float().reshape(B, Hkv, g, Sq, D)       # head h = (h // g, h % g)
    qi = torch.arange(Sq, device=dev)[:, None] + q_offset
    acc = torch.zeros((B, Hkv, g, Sq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Hkv, g, Sq), -torch.inf, device=dev)
    l = torch.zeros((B, Hkv, g, Sq), device=dev)
    for j in range(Skv // block_k):
        kb = k[:, :, j * block_k:(j + 1) * block_k].float()
        vb = v[:, :, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qh, kb) * scale
        kj = j * block_k + torch.arange(block_k, device=dev)[None, :]
        valid = kj < kv_len
        if causal:
            valid = valid & (qi >= kj)
        s = torch.where(valid, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - torch.where(torch.isfinite(m_new), m_new,
                                      0.0)[..., None])
        p = torch.where(valid, p, 0.0)
        fin = torch.isfinite(m)
        alpha = torch.exp(torch.where(fin, m - m_new, -torch.inf))
        alpha = torch.where(fin, alpha, 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    denom = torch.where(l > 0, l, 1.0)
    return (acc / denom[..., None]).to(q.dtype).reshape(B, Hq, Sq, D)


_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 12 + [ctypes.c_float])
# each C entry point: the arguments, then split (0: a planted fault), stream
_SIGNATURE = _ARGTYPES + [ctypes.c_int, ctypes.c_void_p]


def _tma_strides(t):
    """The batch, head and sequence strides of ``t`` for a TMA map. Raises
    unless its pointer and the strides of its axes longer than 1 are
    multiples of 16 bytes, as TMA needs; an axis of length 1 gets a stride
    that TMA takes (it is never stepped along)."""
    shape, stride = t.shape[:3], t.stride()[:3]
    per16 = 16 // t.element_size()
    if t.data_ptr() % 16 or any(n > 1 and s % per16
                                for n, s in zip(shape, stride)):
        raise ValueError(
            f"flash_attention: an operand's pointer and strides must be "
            f"16-byte aligned for TMA, got pointer {t.data_ptr():#x}, "
            f"strides {t.stride()}")
    span = max([t.shape[3]] + [n * s for n, s in zip(shape, stride)
                               if n > 1])
    return [s if n > 1 else span for n, s in zip(shape, stride)]


def _launch(name, q, k, v, out, *, scale: float, causal: bool,
            q_offset: int, kv_len: int, split: bool):
    """Launch kernel ``name`` on checked CUDA tensors, without counting it."""
    dev = same_card(name, q, k, v, out)
    strides = [s for t in (q, k, v) for s in _tma_strides(t)]
    strides += list(out.stride()[:3])
    B, Hq, Sq, D = q.shape
    lib = build.load(name, {name: _SIGNATURE})
    build.call(lib, name, dev, build.ptr(q), build.ptr(k), build.ptr(v),
               build.ptr(out), B, Hq, k.shape[1], Sq, D, int(causal),
               int(q_offset), int(kv_len), *strides, float(scale),
               int(split), launch=name)


def _launch_tc(q, k, v, out, *, scale: float, causal: bool, q_offset: int,
               kv_len: int, split_p: bool = True):
    """Launch the bf16 kernel on checked bf16 CUDA tensors, without counting
    it. ``split_p=False`` drops the kernel's P_lo products, a planted fault
    for the checks; the wrapper never sets it."""
    _launch("flash_attention_tc", q, k, v, out, scale=scale, causal=causal,
            q_offset=q_offset, kv_len=kv_len, split=split_p)


def _launch_f32(q, k, v, out, *, scale: float, causal: bool, q_offset: int,
                kv_len: int, split: bool = True):
    """Launch the f32 kernel on checked f32 CUDA tensors, without counting
    it. ``split=False`` drops the lo products (one TF32 product, 1xTF32), a
    planted fault for the checks; the wrapper never sets it."""
    _launch("flash_attention", q, k, v, out, scale=scale, causal=causal,
            q_offset=q_offset, kv_len=kv_len, split=split)


def flash_attention_p(q, k, v, *, scale: float, causal: bool, q_offset: int,
                      kv_len: int, block_q: int, block_k: int,
                      interpret: bool = True):
    """Same contract as the plain version. CPU tensors take the plain
    version; CUDA tensors launch a kernel, the bf16 one or the f32 one,
    which reads q, k and v through their strides (the last axis contiguous,
    16-byte aligned pointers and strides) and writes an output laid out as
    q is. ``interpret`` is the reference's keyword, accepted and ignored."""
    if not q.is_cuda:
        return flash_attention_p_plain(
            q, k, v, scale=scale, causal=causal, q_offset=q_offset,
            kv_len=kv_len, block_q=block_q, block_k=block_k)
    same_card("flash_attention", q, k, v)
    _check(q, k, v, kv_len, block_q, block_k)
    for t in (q, k, v):
        if (not t.is_cuda or t.dtype != q.dtype
                or t.dtype not in DTYPES or t.stride(-1) != 1):
            raise ValueError(
                f"flash_attention: expected CUDA f32 or bf16 tensors of one "
                f"type with a contiguous last axis, got "
                f"{t.dtype} on {t.device}, strides {t.stride()}")
    B, Hq, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not one of "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)   # q's layout when dense, else contiguous
    kw = dict(scale=scale, causal=causal, q_offset=q_offset, kv_len=kv_len)
    if q.dtype == torch.bfloat16:
        _launch_tc(q, k, v, out, **kw)
        build.count_launch("flash_attention_tc")
    else:
        _launch_f32(q, k, v, out, **kw)
        build.count_launch("flash_attention")
    return out
