"""Decoder-only transformer LM family, dense and MoE (the reference's
``models/transformer.py``).

One implementation covers the five LM configs: GQA/MQA/MHA, RoPE,
RMSNorm, optional per-head QK-norm (Qwen3), GeGLU/SwiGLU, explicit
head_dim (Gemma's 256), embedding scaling (Gemma) and a top-k routed MoE
FFN (OLMoE / Qwen3-MoE, ``models/moe.py``). Parameters are a nested dict
of tensors with the layers stacked on a leading ``[L, ...]`` axis, as the
reference's.

Sharding (the reference's MaxText-style fsdp + tensor): every function
takes the reference's ``MeshAxes`` (``ax``) and runs over the ambient mesh
of processes (``launch.mesh.use_mesh``; ``distributed/sharding.py``),
each rank holding its shards of the weights (``param_defs``' specs) and
its rows of the batch. The reference's ``_use`` is ``use_weight``: the
ZeRO-3 gather of a weight's ``data``-sharded dimension where it is used,
its gradient reduce-scattered. ``wq``/``wk``/``wv``/``w_gate``/``w_up``
are column-parallel over ``model`` (a rank's query heads and the KV heads
they read, ``_Mesh``); ``wo``/``w_down`` row-parallel, their partials
summed over ``model`` (``_row``); the embedding and the
logits are vocab-sharded, the loss a distributed log-softmax; the MoE
FFN runs each rank's experts (``moe.moe_ffn``). The KV caches are laid
out as the reference constrains them, ``P(None, data, model, None,
None)``: a rank holds its rows of the batch and its block of the sequence
over ``model`` (``sharding.block``'s ceil blocks), every KV head. The
prefill runs each rank's query heads over the whole prompt, then hands
each layer's KV heads to the owners of the sequence blocks (one
all-to-all over ``model``, ``_to_seq_blocks``). A decode step gathers the
new token's q, k and v over ``model``, writes k and v on the rank whose
block holds the position, runs every query head against each rank's
block and combines the partial softmax sums over ``model`` (log-sum-exp,
in float32) into each rank's own heads (``_attn_seq_sharded``).
``grow_caches`` pads the caches for decode and re-blocks them. With no
mesh, or a mesh of one process, no collective is issued and the steps
compute what one process does.
The layer loop is a Python loop over the stacked parameters;
``scan_layers`` and ``remat`` are accepted and change nothing (the
training step keeps every layer's activations for the backward). MoE
capacity counts the tokens of the call, so a decode step (T = B) routes
with another capacity than the forward over the whole sequence: decode
equals the forward only for dense configs, in both packages.

Training: ``loss_fn`` and ``make_train_step`` (AdamW, ``optim/``, with
gradient accumulation over microbatches) differentiate through autograd.
``_attn_chunked`` is an ``autograd.Function`` whose backward recomputes
the probabilities chunk by chunk from ``(out, lse)``, FlashAttention-2
style, as the reference's custom VJP does, and ``dtype_fence`` casts the
cotangent on the residual stream to the model's type.

Attention impls: "xla" (materialized scores), "chunked" (online softmax
over kv chunks, with the flash backward) and "pallas" (kernel 12: on CUDA
tensors a CUDA flash kernel on the tensor cores, one for bf16 and one for
f32 (in 3xTF32); its plain version on CPU tensors). Kernel 12 has no
backward, in either package: asking for a gradient through it raises (the
reference fails in ``pallas_call``'s JVP rule), on both devices. Decode,
with a cache, always takes the materialized-scores path, as in the
reference. Caches passed in are left intact unless the caller donates
them (``donate=True``).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.collectives import (all_gather_dim,
                                                 all_gather_tiled,
                                                 all_to_all_uneven,
                                                 copy_to_group,
                                                 max_over_group, psum_named,
                                                 reduce_from_group,
                                                 reduce_scatter_dim)
from repro_torch.distributed.sharding import (MeshAxes, P, block,
                                              placement, use_weight)
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import (ParamDef, as_dtype, n_params, specs,
                                      tree_leaves, tree_unflatten,
                                      value_and_grad)


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # None -> d_model // n_heads
    activation: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    moe: MoeConfig | None = None
    moe_impl: str = "shmap"              # shmap | gspmd: the same
                                         # function (models/moe.py)
    qk_norm: bool = False                # Qwen3
    embed_scale: bool = False            # Gemma: x *= sqrt(d_model)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16          # a torch dtype or its name
    remat: bool = True                   # no effect in serving
    scan_layers: bool = True             # no effect: the loop is Python's
    attn_impl: str = "chunked"           # xla | chunked | pallas
    attn_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return as_dtype(self.dtype)

    def n_params(self) -> int:
        return n_params(param_defs(self, MeshAxes(data=("data",))))

    def n_active_params(self) -> int:
        """Params touched per token (MoE counts top_k experts only)."""
        total = self.n_params()
        if self.moe is None:
            return total
        e, k = self.moe.n_experts, self.moe.top_k
        expert = 3 * self.d_model * self.moe.d_expert * self.n_layers
        return total - expert * e + expert * k


# --------------------------------------------------------------------------
# parameter declaration
# --------------------------------------------------------------------------

def param_defs(cfg: TransformerConfig, ax: MeshAxes):
    D, H, Hkv, Dh, Fd, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.n_layers)
    fsdp, tp = ax.data, ax.model

    def ld(shape, pspec, **kw):  # layer-stacked param (leading L dim)
        return ParamDef((L, *shape), P(None, *pspec), **kw)

    layer = dict(
        attn_norm=ld((D,), (None,), init="ones"),
        wq=ld((D, H * Dh), (fsdp, tp)),
        wk=ld((D, Hkv * Dh), (fsdp, tp)),
        wv=ld((D, Hkv * Dh), (fsdp, tp)),
        wo=ld((H * Dh, D), (tp, fsdp)),
        mlp_norm=ld((D,), (None,), init="ones"),
    )
    if cfg.qk_norm:
        layer["q_norm"] = ld((Dh,), (None,), init="ones")
        layer["k_norm"] = ld((Dh,), (None,), init="ones")
    if cfg.moe is None:
        layer.update(
            w_gate=ld((D, Fd), (fsdp, tp)),
            w_up=ld((D, Fd), (fsdp, tp)),
            w_down=ld((Fd, D), (tp, fsdp)),
        )
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_expert
        layer.update(
            w_router=ld((D, E), (fsdp, None)),
            w_gate=ld((E, D, Fe), (tp, fsdp, None)),
            w_up=ld((E, D, Fe), (tp, fsdp, None)),
            w_down=ld((E, Fe, D), (tp, None, fsdp)),
        )
    return dict(
        embed=ParamDef((V, D), P(tp, fsdp), init="embed", scale=1.0),
        layers=layer,
        final_norm=ParamDef((D,), P(None), init="ones"),
        unembed=ParamDef((D, V), P(fsdp, tp)),
    )


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

class _DtypeFence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.to(ctx.dtype), None


def dtype_fence(x, dtype):
    """Identity forward; the backward casts the cotangent to ``dtype``
    (autograd then hands it to ``x`` in ``x``'s type). Placed on the
    residual stream at layer boundaries, as in the reference."""
    return _DtypeFence.apply(x, as_dtype(dtype))


def rmsnorm(x, g, eps):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * g.float()).to(x.dtype)


def rope(x, positions, theta):
    """x: [B, S, H, Dh]; positions: [B, S] int. Rotates the two halves of
    the head axis (not even/odd pairs); frequencies in float32, each the
    correctly rounded ``theta ** e`` (as XLA gives it: torch's float32 pow
    is off by an ulp for a few exponents, which position 2000 turns into
    1e-4 of the output), so the power is taken in float64 and rounded."""
    half = x.shape[-1] // 2
    e = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(theta, e.double()).float()
    ang = positions[..., None].float() * freq                  # [B, S, half]
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attn_xla(q, k, v, *, causal, q_offset, scale):
    """q: [B, S, H, Dh]; k/v: [B, Skv, Hkv, Dh] (materialized scores)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    qh = q.reshape(B, S, Hkv, H // Hkv, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh.float(), k.float()) * scale
    if causal:
        qi = torch.arange(S, device=q.device)[:, None] + q_offset
        kj = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(qi >= kj, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, S, H, Dh).to(q.dtype)


def _chunk_kv(x, chunk):
    """[B, Skv, Hkv, Dh] -> ([nc, B, chunk, Hkv, Dh] zero-padded, nc)."""
    B, Skv, Hkv, Dh = x.shape
    nc = -(-Skv // chunk)
    xp = F.pad(x, (0, 0, 0, 0, 0, nc * chunk - Skv))
    return xp.reshape(B, nc, chunk, Hkv, Dh).transpose(0, 1), nc


def _attn_fwd_scan(q, k, v, causal, q_offset, scale, chunk):
    """Online softmax over kv chunks. Returns (out [B, Hkv, g, S, Dh] f32,
    lse [B, Hkv, g, S])."""
    B, S, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    kc, nc = _chunk_kv(k, chunk)
    vc, _ = _chunk_kv(v, chunk)
    qh = q.reshape(B, S, Hkv, g, Dh).float()
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    acc = torch.zeros((B, Hkv, g, S, Dh), dtype=torch.float32, device=q.device)
    m = torch.full((B, Hkv, g, S), -torch.inf, device=q.device)
    l = torch.zeros((B, Hkv, g, S), device=q.device)
    for j in range(nc):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kc[j].float()) * scale
        kj = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = kj < Skv
        if causal:
            valid = valid & (qi >= kj)
        s = torch.where(valid, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - torch.where(torch.isfinite(m_new), m_new,
                                      0.0)[..., None])
        p = torch.where(valid, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vc[j].float())
        m = m_new
    l_safe = torch.where(l > 0, l, 1.0)
    out = acc / l_safe[..., None]                       # [B, Hkv, g, S, Dh]
    lse = torch.where(torch.isfinite(m), m + torch.log(l_safe), -torch.inf)
    return out, lse


class _AttnChunked(torch.autograd.Function):
    """The online-softmax forward; the backward recomputes each chunk's
    probabilities from the saved ``(q, k, v, out, lse)`` instead of keeping
    the forward scan's f32 accumulator of every chunk step (the reference's
    ``_attn_chunked_fwd`` / ``_attn_chunked_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, scale, chunk):
        out, lse = _attn_fwd_scan(q, k, v, causal, q_offset, scale, chunk)
        B, S, H, Dh = q.shape
        o = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out.to(q.dtype), lse)
            ctx.args = (causal, q_offset, scale, chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, q_offset, scale, chunk = ctx.args
        dq, dk, dv = _attn_chunked_bwd(q, k, v, out, lse, do, causal,
                                       q_offset, scale, chunk)
        return dq, dk, dv, None, None, None, None


def _attn_chunked_bwd(q, k, v, out, lse, do, causal, q_offset, scale,
                      chunk):
    """FlashAttention-2 backward, chunk by chunk over kv: p from the saved
    lse, then dv = p^T do, ds = p (dp - delta) scale, dq += ds k,
    dk = ds^T q. Returns (dq, dk, dv) in their inputs' types."""
    B, S, H, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    qh = q.reshape(B, S, Hkv, g, Dh).float()
    doh = do.reshape(B, S, Hkv, g, Dh).permute(0, 2, 3, 1, 4).float()
    delta = (doh * out.float()).sum(dim=-1)             # [B, Hkv, g, S]
    kc, nc = _chunk_kv(k, chunk)
    vc, _ = _chunk_kv(v, chunk)
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    lse_safe = torch.where(torch.isfinite(lse), lse, 0.0)
    dq = torch.zeros((B, S, Hkv, g, Dh), dtype=torch.float32,
                     device=q.device)
    dks, dvs = [], []
    for j in range(nc):
        kb32, vb32 = kc[j].float(), vc[j].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kb32) * scale
        kj = j * chunk + torch.arange(chunk, device=q.device)[None, :]
        valid = kj < Skv
        if causal:
            valid = valid & (qi >= kj)
        p = torch.where(valid, torch.exp(s - lse_safe[..., None]), 0.0)
        dvs.append(torch.einsum("bhgqk,bhgqd->bkhd", p, doh))
        dp = torch.einsum("bhgqd,bkhd->bhgqk", doh, vb32)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhgqk,bkhd->bqhgd", ds, kb32)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qh))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return (dq.reshape(B, S, H, Dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _attn_chunked(q, k, v, causal, q_offset, scale, chunk):
    """Flash-style attention in plain tensor ops with a flash backward:
    autograd through the online-softmax scan would keep the f32
    accumulator of every chunk step; the backward recomputes the
    probabilities chunk by chunk from ``(out, lse)`` instead."""
    return _AttnChunked.apply(q, k, v, causal, q_offset, scale, chunk)


def attention(q, k, v, cfg: TransformerConfig, *, causal=True, q_offset=0):
    """q: [B, S, H, Dh]; k/v: [B, Skv, Hkv, Dh]."""
    scale = cfg.hd ** -0.5
    if cfg.attn_impl == "pallas":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise NotImplementedError(
                "attn_impl='pallas' has no backward: kernel 12 "
                "(flash_attention_p) is forward-only, as in the reference; "
                "train with attn_impl='chunked' or 'xla'")
        from repro_torch.kernels.flash_attention import flash_attention
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            q_offset=q_offset)
        return o.transpose(1, 2)
    if cfg.attn_impl == "chunked" and q.shape[1] > 1:
        return _attn_chunked(q, k, v, causal, q_offset, scale, cfg.attn_chunk)
    return _attn_xla(q, k, v, causal=causal, q_offset=q_offset, scale=scale)


class _Mesh:
    """The sharded steps' plan on the ambient mesh: ``pl`` (the
    ``Placement``, None with no mesh or one process), every layer leaf's
    spec (``layers``) and this rank's heads. Query heads ``[q0, q0 + Hl)``
    are the column shard of ``wq``. A rank computes the KV heads its query
    heads read, ``[kv0, kv0 + hk)``: the column shard of ``wk``/``wv``
    when ``m`` divides ``Hkv``, else those heads of ``wk``/``wv`` gathered
    over ``model``. ``kv_of`` maps each local query head to its KV head
    when the local heads do not form a uniform GQA group (else None).

    The caches hold every KV head over a rank's block of the sequence.
    Each KV head has one owner, the first rank of ``model`` that computes
    it (``owned``: this rank's heads ``[lo, hi)``, a contiguous range, the
    ranks' ranges in rank order); the new token's heads are gathered from
    the ranks padded to ``hk_max`` heads each, and ``kv_pick`` indexes
    every head's owner's copy in the gathered ``[m * hk_max]`` heads."""

    def __init__(self, cfg: TransformerConfig, ax: MeshAxes):
        self.ax = ax
        self.pl = pl = placement(ax)
        defs = param_defs(cfg, ax)
        self.layers = {k: tuple(d.pspec)[1:]
                       for k, d in defs["layers"].items()}
        H, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.m, self.mi = m, mi = (1, 0) if pl is None else (pl.m, pl.mi)
        if H % m:
            raise ValueError(f"{cfg.name}: {H} query heads do not split "
                             f"over a model axis of {m}")
        g = H // Hkv
        self.Hl = Hl = H // m
        spans = [((j * Hl) // g, (j * Hl + Hl - 1) // g + 1)
                 for j in range(m)]                      # [kv0, kv0 + hk)
        self.q0 = mi * Hl
        self.kv0 = spans[mi][0]
        self.hk = spans[mi][1] - self.kv0
        self.kv_shard = Hkv % m == 0
        self.kv_of = None
        if Hl % g and g % Hl:
            self.kv_of = (torch.arange(self.q0, self.q0 + Hl) // g) - self.kv0
        self.vocab = block(cfg.vocab_size, m, mi)
        owner = [next(j for j, (a, b) in enumerate(spans) if a <= h < b)
                 for h in range(Hkv)]
        mine = [h for h in range(Hkv) if owner[h] == mi]
        self.owned = (mine[0], mine[-1] + 1) if mine else (0, 0)
        self.n_owned = [owner.count(j) for j in range(m)]
        self.hk_max = max(b - a for a, b in spans)
        self.kv_pick = torch.tensor([owner[h] * self.hk_max + h
                                     - spans[owner[h]][0]
                                     for h in range(Hkv)])

    def use(self, lp, name, size, model_partial=False):
        return use_weight(lp[name], self.layers[name], self.pl, self.ax,
                          size, model_partial)

    @property
    def model(self):
        return None if self.pl is None else self.pl.model

    @property
    def data(self):
        return None if self.pl is None else self.pl.data


def _row(h, w, sm: _Mesh):
    """A row-parallel product: each ``model`` rank's partial over its rows
    of ``w``, in the model's type, summed over ``model`` (the reference's
    ``psum``)."""
    return h @ w if sm.model is None else reduce_from_group(h @ w, sm.model)


def _ffn_dense(x, lp, cfg, sm: _Mesh):
    act = (F.silu if cfg.activation == "silu"
           else partial(F.gelu, approximate="tanh"))
    D = cfg.d_model
    x = copy_to_group(x, sm.model)
    h = act(x @ sm.use(lp, "w_gate", D)) * (x @ sm.use(lp, "w_up", D))
    return _row(h, sm.use(lp, "w_down", D), sm)


def _kv_weight(lp, name, cfg, sm: _Mesh):
    """This rank's columns of ``wk`` or ``wv`` for its KV heads."""
    w = sm.use(lp, name, cfg.d_model)
    if sm.model is None or sm.kv_shard:
        return w
    Dh = cfg.hd
    w = all_gather_dim(w, sm.model, 1, cfg.n_kv_heads * Dh)
    return w[:, sm.kv0 * Dh:(sm.kv0 + sm.hk) * Dh]


def _expand(t, sm: _Mesh):
    """KV heads [B, S, hk, Dh] -> one a local query head, where the local
    heads form no uniform GQA group."""
    return t if sm.kv_of is None else t[:, :, sm.kv_of.to(t.device)]


# --------------------------------------------------------------------------
# KV caches over the sequence: P(None, data, model, None, None)
# --------------------------------------------------------------------------

def _to_seq_blocks(k, v, sm: _Mesh):
    """This rank's KV heads over the whole prompt ([B, S, hk, Dh] each) ->
    its block of the sequence with every KV head ([B, n, Hkv, Dh] each):
    one all-to-all over ``model``, each rank sending the heads it owns
    (``_Mesh.owned``) in every rank's block of rows."""
    B, S, _, Dh = k.shape
    a, b = (h - sm.kv0 for h in sm.owned)
    kv = torch.stack([k, v])[:, :, :, a:b]              # [2, B, S, no, Dh]
    sends = [kv[:, :, lo:hi].reshape(-1)
             for lo, hi in (block(S, sm.m, j) for j in range(sm.m))]
    lo, hi = block(S, sm.m, sm.mi)
    recv = [2 * B * (hi - lo) * no * Dh for no in sm.n_owned]
    got = all_to_all_uneven(torch.cat(sends), sm.model,
                            [t.numel() for t in sends], recv)
    whole = torch.cat([t.reshape(2, B, hi - lo, no, Dh) for t, no in
                       zip(got.split(recv), sm.n_owned)], dim=3)
    return whole[0], whole[1]


def _seq_offset(n: int, sm: _Mesh, device):
    """(first row of this rank's block of ``n`` rows, the whole sequence's
    length), 0-d int64 tensors from one all-gather of the blocks' lengths
    over ``model``: read on the device, so a ``meta`` run needs no
    value."""
    lens = all_gather_tiled(
        torch.tensor([n], dtype=torch.int64, device=device), sm.model)
    return lens[:sm.mi].sum(), lens.sum()


def _gather_token(q, k, v, sm: _Mesh):
    """Every rank's query heads and the KV heads' owners' copies of the new
    tokens, from one all-gather over ``model``: ([B, S, H, Dh], [B, S, Hkv,
    Dh], [B, S, Hkv, Dh])."""
    B, S, Hl, Dh = q.shape
    pad = (0, 0, 0, sm.hk_max - k.shape[2])
    pack = torch.cat([q, F.pad(k, pad), F.pad(v, pad)], dim=2)[None]
    every = all_gather_tiled(pack, sm.model)            # [m, B, S, ., Dh]

    def heads(a, b):
        return every[:, :, :, a:b].permute(1, 2, 0, 3, 4).reshape(
            B, S, -1, Dh)

    pick = sm.kv_pick.to(q.device)
    h = sm.hk_max
    return (heads(0, Hl), heads(Hl, Hl + h).index_select(2, pick),
            heads(Hl + h, Hl + 2 * h).index_select(2, pick))


def _write_block(c, new, start, lo):
    """Rows ``[start, start + S)`` of the whole sequence (``new`` [B, S,
    Hkv, Dh]) written in place into this rank's block ``c`` [B, n, Hkv,
    Dh], which holds rows ``[lo, lo + n)``: those rows that fall in it."""
    n, S = c.shape[1], new.shape[1]
    if n == 0:
        return
    if S == 1:
        r = (start - lo).reshape(1)
        idx = r.clamp(0, n - 1)
        hit = ((r >= 0) & (r < n)).reshape(1, 1, 1, 1)
        c.index_copy_(1, idx, torch.where(hit, new, c.index_select(1, idx)))
        return
    src = torch.arange(n, device=c.device) + lo - start
    hit = ((src >= 0) & (src < S))[None, :, None, None]
    rows = new.index_select(1, src.clamp(0, S - 1))
    c.copy_(torch.where(hit, rows, c))


def _attn_seq_sharded(q, ck, cv, cache_pos, lo, sm: _Mesh, scale):
    """Causal attention of every query head (``q`` [B, S, H, Dh], at
    positions ``cache_pos + i``) over the sequence blocks of every
    ``model`` rank: each rank's partial output, running max and sum over
    its block (``ck``/``cv`` [B, n, Hkv, Dh], rows from ``lo``; an empty
    block gives -inf maxima and zero sums), combined over ``model`` by
    the log-sum-exp rule in float32 and handed to each rank for its own
    heads (a max all-reduce and a reduce-scatter). Returns [B, S, Hl, Dh]
    in ``q``'s type, what ``_attn_xla`` gives those heads over the whole
    cache."""
    B, S, H, Dh = q.shape
    n, Hkv = ck.shape[1], ck.shape[2]
    g = H // Hkv
    if n:
        s = torch.einsum("bqhgd,bkhd->bhgqk",
                         q.reshape(B, S, Hkv, g, Dh).float(),
                         ck.float()) * scale
        qi = torch.arange(S, device=q.device)[:, None] + cache_pos
        kj = torch.arange(n, device=q.device)[None, :] + lo
        s = torch.where(qi >= kj, s, -torch.inf)
        mx = s.amax(dim=-1)                                # [B, Hkv, g, S]
        p = torch.exp(s - torch.where(torch.isfinite(mx), mx, 0.0)[..., None])
        l = p.sum(dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, cv.float())
    else:
        mx = torch.full((B, Hkv, g, S), -torch.inf, device=q.device)
        l = torch.zeros((B, Hkv, g, S), device=q.device)
        o = torch.zeros((B, Hkv, g, S, Dh), device=q.device)
    top = max_over_group(mx, sm.model)
    alpha = torch.where(torch.isfinite(mx), torch.exp(mx - top), 0.0)
    part = torch.cat([o * alpha[..., None], (l * alpha)[..., None]],
                     dim=-1).reshape(B, H, S, Dh + 1)
    mine = reduce_scatter_dim(part, sm.model, 1)        # [B, Hl, S, Dh + 1]
    return (mine[..., :Dh] / mine[..., Dh:]).transpose(1, 2).to(q.dtype)


def grow_caches(caches, n: int, ax: MeshAxes):
    """The KV caches (k, v: [L, B, S, Hkv, Dh]) grown by ``n`` zero
    positions at the end of the sequence: ``F.pad`` of the whole caches.
    Under a mesh whose ``model`` axis holds more than one process, each
    rank passes its blocks and gets its blocks of the grown caches
    (``local_shard`` of the padded whole, re-blocked over ``model``): one
    all-to-all over ``model`` a layer, and one all-gather of the blocks'
    lengths, read on the host."""
    pl = placement(ax)
    if pl is None or pl.model is None:
        return tuple(F.pad(t, (0, 0, 0, 0, 0, n)) for t in caches)
    k, v = caches
    L, B, nloc, Hkv, Dh = k.shape
    lens = all_gather_tiled(torch.tensor([nloc], dtype=torch.int64,
                                         device=k.device), pl.model).tolist()
    starts = [sum(lens[:j]) for j in range(pl.m)]
    lo, hi = starts[pl.mi], starts[pl.mi] + nloc
    new = [block(sum(lens) + n, pl.m, j) for j in range(pl.m)]
    nlo, nhi = new[pl.mi]
    send = [(max(lo, a), min(hi, b)) for a, b in new]
    recv = [(max(s, nlo), min(s + c, nhi)) for s, c in zip(starts, lens)]
    row = 2 * B * Hkv * Dh
    out = torch.zeros((2, L, B, nhi - nlo, Hkv, Dh), dtype=k.dtype,
                      device=k.device)
    for i in range(L):
        kv = torch.stack([k[i], v[i]])                  # [2, B, nloc, ., .]
        pieces = [kv[:, :, a - lo:b - lo].reshape(-1) for a, b in send
                  if b > a]
        got = all_to_all_uneven(
            torch.cat(pieces) if pieces else kv.new_empty(0), pl.model,
            [max(b - a, 0) * row for a, b in send],
            [max(b - a, 0) * row for a, b in recv])
        at = 0
        for a, b in recv:
            if b > a:
                out[:, i, :, a - nlo:b - nlo] = got[at:at + (b - a) * row
                                                    ].reshape(2, B, b - a,
                                                              Hkv, Dh)
                at += (b - a) * row
    return out[0], out[1]


def _layer(x, lp, cfg: TransformerConfig, ax: MeshAxes, positions,
           cache=None, cache_pos=None, sm: _Mesh | None = None, seq=None):
    """One transformer block. x: [B, S, D]. Returns (x', new_cache_slice,
    aux). Without a cache, new_cache_slice is this rank's KV heads over the
    sequence ([B, S, hk, Dh] each; every head with no mesh). With a cache
    (k, v: [B, Skv, Hkv, Dh]) the new k and v are written into it in place
    at ``cache_pos`` (an int or a 0-d tensor, read on the device, so a
    ``meta`` run needs no value), the start clamped to [0, Skv - S] as
    ``lax.dynamic_update_slice`` clamps it; ``_trunk`` hands it a copy
    unless the caller donated the caches. Under a mesh the block runs this
    rank's heads and columns (``_Mesh``); where ``model`` holds more than
    one process the cache is this rank's block of the sequence, rows from
    ``seq[0]`` of ``seq[1]`` (``_seq_offset``, computed here when not
    given), and attention runs over every rank's block
    (``_attn_seq_sharded``)."""
    sm = _Mesh(cfg, ax) if sm is None else sm
    B, S, D = x.shape
    Hl, hk, Dh = sm.Hl, sm.hk, cfg.hd

    h = rmsnorm(x, sm.use(lp, "attn_norm", D), cfg.norm_eps)
    h = copy_to_group(h, sm.model)
    q = (h @ sm.use(lp, "wq", D)).reshape(B, S, Hl, Dh)
    k = (h @ _kv_weight(lp, "wk", cfg, sm)).reshape(B, S, hk, Dh)
    v = (h @ _kv_weight(lp, "wv", cfg, sm)).reshape(B, S, hk, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, sm.use(lp, "q_norm", D, True), cfg.norm_eps)
        k = rmsnorm(k, sm.use(lp, "k_norm", D, True), cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = attention(q, _expand(k, sm), _expand(v, sm), cfg, causal=True)
        new_cache = (k, v)
    elif sm.model is not None:
        ck, cv = cache           # [B, n, Hkv, Dh]: this rank's block
        lo, total = seq if seq is not None else _seq_offset(
            ck.shape[1], sm, ck.device)
        q, k, v = _gather_token(q, k, v, sm)
        pos = torch.as_tensor(cache_pos, device=ck.device).to(torch.int64)
        start = torch.minimum(pos.clamp(min=0), total - S)
        _write_block(ck, k, start, lo)
        _write_block(cv, v, start, lo)
        o = _attn_seq_sharded(q, ck, cv, cache_pos, lo, sm, cfg.hd ** -0.5)
        new_cache = (ck, cv)
    else:
        ck, cv = cache           # [B, Skv, Hkv, Dh], decode: S == 1
        start = torch.as_tensor(cache_pos).clamp(0, ck.shape[1] - S)
        rows = torch.arange(S, device=ck.device) + start
        ck.index_copy_(1, rows, k)
        cv.index_copy_(1, rows, v)
        o = _attn_xla(q, _expand(ck, sm), _expand(cv, sm), causal=True,
                      q_offset=cache_pos, scale=cfg.hd ** -0.5)
        new_cache = (ck, cv)
    x = x + _row(o.reshape(B, S, Hl * Dh), sm.use(lp, "wo", D), sm)

    h = rmsnorm(x, sm.use(lp, "mlp_norm", D), cfg.norm_eps)
    if cfg.moe is None:
        y = _ffn_dense(h, lp, cfg, sm)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        y, aux = moe_mod.moe_ffn(h, lp, cfg.moe, cfg.activation, ax,
                                 impl=cfg.moe_impl)
    x = x + y
    x = dtype_fence(x, cfg.dtype)
    return x, new_cache, aux


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def _embed(params, tokens, cfg: TransformerConfig, sm: _Mesh):
    """The embedding rows of ``tokens``; under a mesh each ``model`` rank
    holds the rows of its vocabulary block, gives zeros for the others and
    the ranks' rows are summed (the vocab-sharded lookup)."""
    table = use_weight(params["embed"], P(sm.ax.model, sm.ax.data), sm.pl,
                       sm.ax, cfg.d_model)
    if sm.model is None:
        return table[tokens.long()]
    lo, hi = sm.vocab
    t = tokens.long()
    mine = (t >= lo) & (t < hi)
    rows = table[(t - lo).clamp(0, max(hi - lo - 1, 0))]
    rows = torch.where(mine[..., None], rows, rows.new_zeros(()))
    return reduce_from_group(rows, sm.model)


def _trunk(params, tokens, cfg: TransformerConfig, ax: MeshAxes,
           caches=None, cache_pos=None, donate: bool = False,
           keep_kv: bool = True, sm: _Mesh | None = None):
    """Embedding and layers: (x [B, S, D] before the final norm, kvs,
    aux). Without caches the layers' k and v are written into one stacked
    [L, B, S, Hkv, Dh] pair (None with ``keep_kv=False``, as the loss
    needs none); under a mesh whose ``model`` holds more than one process,
    each layer's KV heads handed to the owners of the sequence blocks
    (``_to_seq_blocks``) first, so the pair is this rank's block of the
    sequence. With caches, into a copy of them, or into the caches
    themselves when ``donate`` is set."""
    sm = _Mesh(cfg, ax) if sm is None else sm
    B, S = tokens.shape
    if caches is not None and not donate:
        caches = tuple(t.clone() for t in caches)   # the caller's stay intact
    dt = cfg.torch_dtype
    x = _embed(params, tokens, cfg, sm).to(dt)
    if cfg.embed_scale:   # the scale rounded to the model's type first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    pos0 = 0 if cache_pos is None else cache_pos     # an int or 0-d tensor
    positions = (torch.arange(S, device=x.device) + pos0)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = caches
    seq = None
    if caches is not None and sm.model is not None:
        seq = _seq_offset(caches[0].shape[2], sm, x.device)
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in params["layers"].items()}
        if caches is None:
            x, (k, v), a = _layer(x, lp, cfg, ax, positions, sm=sm)
            if keep_kv:
                if sm.model is not None:
                    with torch.no_grad():
                        k, v = _to_seq_blocks(k, v, sm)
                if kvs is None:
                    kvs = tuple(torch.empty((cfg.n_layers, *t.shape),
                                            dtype=t.dtype, device=t.device)
                                for t in (k, v))
                kvs[0][i], kvs[1][i] = k, v
        else:
            x, _, a = _layer(x, lp, cfg, ax, positions,
                             cache=(caches[0][i], caches[1][i]),
                             cache_pos=cache_pos, sm=sm, seq=seq)
        aux = aux + a
    return x, kvs, aux


def _logits(x, params, cfg: TransformerConfig, sm: _Mesh):
    """Final norm and the unembedding, a float32 product; under a mesh,
    this rank's vocabulary block of the logits."""
    D = cfg.d_model
    x = rmsnorm(x, use_weight(params["final_norm"], P(None), sm.pl, sm.ax,
                              D), cfg.norm_eps)
    x = copy_to_group(x, sm.model)
    unembed = use_weight(params["unembed"], P(sm.ax.data, sm.ax.model),
                         sm.pl, sm.ax, D)
    return x.float() @ unembed.float()


def _whole_vocab(logits, cfg: TransformerConfig, sm: _Mesh):
    """Every ``model`` rank's vocabulary block laid together."""
    if sm.model is None:
        return logits
    return all_gather_dim(logits, sm.model, logits.dim() - 1,
                          cfg.vocab_size)


def forward(params, tokens, cfg: TransformerConfig, ax: MeshAxes,
            caches=None, cache_pos=None, *, donate: bool = False):
    """tokens: [B, S]. caches: None | (k: [L, B, Skv, Hkv, Dh], v). Returns
    (logits_f32 [B, S, V], new_caches, aux_loss). The caches passed in are
    left intact, as in the reference, unless ``donate`` is set: then the new
    k and v are written into them in place and they are returned (the
    counterpart of the reference's ``donate_argnums``).

    Under a mesh of processes (``launch.mesh.use_mesh``) ``params`` are
    this rank's shards (``materialize`` under the mesh), ``tokens`` are
    this rank's ``data`` block of rows, the caches, passed in and
    returned, are its block of the reference's ``P(None, data, model,
    None, None)`` (its rows, its ``model`` block of the sequence, every KV
    head: ``[L, B, n, Hkv, Dh]``) and the logits are its vocabulary block
    (the reference's ``P(data, None, model)``)."""
    sm = _Mesh(cfg, ax)
    x, kvs, aux = _trunk(params, tokens, cfg, ax, caches, cache_pos, donate,
                         sm=sm)
    return _logits(x, params, cfg, sm), kvs, aux


def softmax_xent(logits, labels):
    """Mean token cross-entropy of f32 ``logits`` [..., V] against integer
    ``labels`` [...]."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None],
                              dim=-1)[..., 0]
    return (logz - ll).mean()


def _xent_sharded(logits, labels, sm: _Mesh):
    """``softmax_xent`` of the whole batch from this rank's block of rows
    and of the vocabulary: the log-softmax's max and sum of exponentials
    over ``model`` (the label's logit from the rank that holds it), the
    mean over every ``data`` rank's tokens."""
    labels = labels.long()
    if sm.model is None:
        tok = torch.logsumexp(logits, dim=-1) - torch.take_along_dim(
            logits, labels[..., None], dim=-1)[..., 0]
    else:
        lo, hi = sm.vocab
        top = max_over_group(logits.amax(dim=-1), sm.model)
        se = reduce_from_group((logits - top[..., None]).exp().sum(dim=-1),
                               sm.model)
        mine = (labels >= lo) & (labels < hi)
        ll = torch.take_along_dim(
            logits, (labels - lo).clamp(0, max(hi - lo - 1, 0))[..., None],
            dim=-1)[..., 0]
        ll = reduce_from_group(torch.where(mine, ll, 0.0), sm.model)
        tok = se.log() + top - ll
    n = psum_named(torch.tensor(float(tok.numel()), device=tok.device),
                   sm.data) if sm.data is not None else tok.numel()
    return reduce_from_group(tok.sum(), sm.data) / n


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------

def make_prefill_step(cfg: TransformerConfig, ax: MeshAxes):
    """prefill_step(params, {"tokens": [B, S]}) -> (last logits [B, V] f32,
    (k, v) caches [L, B, S, Hkv, Dh]). Only the last position is
    unembedded: the reference computes every position's logits and keeps
    the last, which is the same row (at gemma-7b's 4 x 2048 prompts the
    whole [B, S, V] f32 block is 8.4 GB). Under a mesh, the logits of this
    rank's rows over the whole vocabulary (gathered over ``model``, so a
    greedy step takes the whole argmax) and its blocks of the caches
    (``forward``; ``grow_caches`` pads them for decode)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        sm = _Mesh(cfg, ax)
        x, kvs, _ = _trunk(params, batch["tokens"], cfg, ax, sm=sm)
        last = _logits(x[:, -1:], params, cfg, sm)[:, -1]
        return _whole_vocab(last, cfg, sm), kvs

    return prefill_step


def make_serve_step(cfg: TransformerConfig, ax: MeshAxes, *,
                    donate: bool = False):
    """One decode step: new token [B, 1] + KV caches at position ``pos`` ->
    (last logits [B, V] f32, new caches). The caches passed in are left
    intact, as in the reference, unless ``donate`` is set: then they are
    written in place and returned, as the reference's serving example gets
    with ``jax.jit(serve_step, donate_argnums=(2,))``. Under a mesh, as
    ``make_prefill_step``."""
    @torch.no_grad()
    def serve_step(params, token, caches, pos):
        sm = _Mesh(cfg, ax)
        x, new_caches, _ = _trunk(params, token, cfg, ax, caches, pos,
                                  donate, sm=sm)
        last = _logits(x[:, -1:], params, cfg, sm)[:, -1]
        return _whole_vocab(last, cfg, sm), new_caches

    return serve_step


def loss_fn(params, batch, cfg: TransformerConfig, ax: MeshAxes):
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"},
    each [B, S]) under ``params``; a differentiable scalar. Under a mesh,
    the batch is this rank's rows and the loss is the whole batch's, the
    same on every rank."""
    sm = _Mesh(cfg, ax)
    x, _, aux = _trunk(params, batch["tokens"], cfg, ax, keep_kv=False,
                       sm=sm)
    logits = _logits(x, params, cfg, sm)
    if sm.pl is None:
        loss = softmax_xent(logits, batch["labels"])
    else:
        loss = _xent_sharded(logits, batch["labels"], sm)
    return loss + (cfg.moe.aux_weight * aux / cfg.n_layers if cfg.moe
                   else 0.0)


def _value_and_grad(params, batch, cfg, ax):
    """(loss, grads): the gradient of every leaf of ``params`` (a tree of
    tensors, left as it is), each in its leaf's type. Under a mesh, each
    rank's gradient of its shards of the whole batch's loss."""
    return value_and_grad(loss_fn, params, batch, cfg, ax)


def make_train_step(cfg: TransformerConfig, ax: MeshAxes, opt_cfg,
                    microbatches: int = 1):
    """train_step(params, opt_state, batch) -> (params', opt_state',
    {"loss", "grad_norm"}): the loss and its gradients, then one AdamW
    update (``optim.adamw_update``). ``microbatches`` > 1 splits the batch
    into that many equal slices along the batch axis, accumulates their
    gradients in f32 and averages gradients and loss: activation memory
    falls to a slice's, as in the reference. The parameters passed in are
    left as they are. Under a mesh each rank passes its shards and its
    rows of the batch: the gradients of FSDP-sharded leaves are
    reduce-scattered over ``data``, those of leaves ``data`` does not shard
    all-reduced, and the clipping norm counts each leaf once over the
    mesh."""
    from repro_torch.optim import adamw_update
    pspecs = specs(param_defs(cfg, ax))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(params, batch, cfg, ax)
        else:
            M = microbatches
            gacc = lsum = None
            for i in range(M):
                mb = {}
                for key, t in batch.items():
                    n = t.shape[0] // M
                    mb[key] = t[i * n:(i + 1) * n]
                loss, grads = _value_and_grad(params, mb, cfg, ax)
                g32 = [g.float() for g in tree_leaves(grads)]
                gacc = g32 if gacc is None else [
                    a + g for a, g in zip(gacc, g32)]
                lsum = loss if lsum is None else lsum + loss
            grads = tree_unflatten(params, [g / M for g in gacc])
            loss = lsum / M
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg, specs=pspecs)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
