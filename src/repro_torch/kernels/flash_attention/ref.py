"""Plain PyTorch oracle: softmax attention with GQA and an optional causal
mask, the reference's ``kernels/flash_attention/ref.py``. A row with no
valid key (causal with a negative ``q_offset``) comes out NaN here, as in
the reference; the kernel gives 0 there."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None,
                  q_offset: int = 0):
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Skv, D]. Hq % Hkv == 0.

    ``q_offset``: absolute position of q[0] (decode: Skv - Sq)."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(qi >= kj, s, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)
