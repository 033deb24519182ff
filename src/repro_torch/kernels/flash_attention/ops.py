"""The flash-attention entry point (the reference's
``kernels/flash_attention/ops.py``): padding, GQA checks, decode offsets."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_p)


def _pad_seq(x, block: int):
    """Zero-pad axis 2 of a 4-D tensor to a multiple of ``block``."""
    pad = (-x.shape[2]) % block
    return x if pad == 0 else F.pad(x, (0, 0, 0, pad))


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, block_q: int = 128, block_k: int = 128,
                    interpret: bool = True):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]. Returns [B, Hq, Sq, D].

    ``q_offset`` positions queries for causal decode (q_offset = Skv - Sq).
    ``interpret`` is the reference's keyword, accepted and ignored: the
    kernel runs on CUDA tensors, its plain version on CPU tensors."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_attention: Hq {Hq} is not a multiple of "
                         f"Hkv {Hkv}")
    if scale is None:
        scale = float(D) ** -0.5
    bq = min(block_q, max(Sq, 1))
    bk = min(block_k, max(Skv, 1))
    out = flash_attention_p(_pad_seq(q, bq), _pad_seq(k, bk), _pad_seq(v, bk),
                            scale=scale, causal=causal, q_offset=q_offset,
                            kv_len=Skv, block_q=bq, block_k=bk)
    return out[:, :, :Sq, :]
