"""Decoder-only transformer LM family, dense and MoE (the reference's
``models/transformer.py``).

One implementation covers the five LM configs: GQA/MQA/MHA, RoPE,
RMSNorm, optional per-head QK-norm (Qwen3), GeGLU/SwiGLU, explicit
head_dim (Gemma's 256), embedding scaling (Gemma) and a top-k routed MoE
FFN (OLMoE / Qwen3-MoE, ``models/moe.py``). Parameters are a nested dict
of tensors with the layers stacked on a leading ``[L, ...]`` axis, as the
reference's.

The port runs on one device. The reference's ``MeshAxes`` arguments, its
use-site weight gathers (``_use``) and its sharding constraints have no
counterpart here and are gone from every signature. The layer loop is a
Python loop over the stacked parameters; ``scan_layers`` and ``remat`` are
accepted and change nothing (the training step keeps every layer's
activations for the backward), and so is ``moe_impl``: on one device both
of the reference's MoE impls compute the same function, and the MoE FFN
runs its tokens as one group (``moe.moe_ffn``). MoE capacity counts the
tokens of the call, so a decode step (T = B) routes with another capacity
than the forward over the whole sequence: decode equals the forward only
for dense configs, in both packages.

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

from repro_torch.models import moe as moe_mod
from repro_torch.models.params import (ParamDef, as_dtype, n_params,
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
    moe_impl: str = "shmap"              # shmap | gspmd: the same on one
                                         # device
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
        return n_params(param_defs(self))

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

def param_defs(cfg: TransformerConfig):
    D, H, Hkv, Dh, Fd, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.d_ff, cfg.vocab_size, cfg.n_layers)

    def ld(shape, **kw):  # layer-stacked param (leading L dim)
        return ParamDef((L, *shape), **kw)

    layer = dict(
        attn_norm=ld((D,), init="ones"),
        wq=ld((D, H * Dh)),
        wk=ld((D, Hkv * Dh)),
        wv=ld((D, Hkv * Dh)),
        wo=ld((H * Dh, D)),
        mlp_norm=ld((D,), init="ones"),
    )
    if cfg.qk_norm:
        layer["q_norm"] = ld((Dh,), init="ones")
        layer["k_norm"] = ld((Dh,), init="ones")
    if cfg.moe is None:
        layer.update(
            w_gate=ld((D, Fd)),
            w_up=ld((D, Fd)),
            w_down=ld((Fd, D)),
        )
    else:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_expert
        layer.update(
            w_router=ld((D, E)),
            w_gate=ld((E, D, Fe)),
            w_up=ld((E, D, Fe)),
            w_down=ld((E, Fe, D)),
        )
    return dict(
        embed=ParamDef((V, D), init="embed", scale=1.0),
        layers=layer,
        final_norm=ParamDef((D,), init="ones"),
        unembed=ParamDef((D, V)),
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


def _ffn_dense(x, lp, cfg):
    act = (F.silu if cfg.activation == "silu"
           else partial(F.gelu, approximate="tanh"))
    h = act(x @ lp["w_gate"]) * (x @ lp["w_up"])
    return h @ lp["w_down"]


def _layer(x, lp, cfg: TransformerConfig, positions, cache=None,
           cache_pos=None):
    """One transformer block. x: [B, S, D]. Returns (x', new_cache_slice,
    aux). With a cache (k, v: [B, Skv, Hkv, Dh]) the new k and v are written
    into it in place at ``cache_pos``, the start clamped to [0, Skv - S] as
    ``lax.dynamic_update_slice`` clamps it; ``_trunk`` hands it a copy unless
    the caller donated the caches."""
    B, S, D = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, H, Dh)
    k = (h @ lp["wk"]).reshape(B, S, Hkv, Dh)
    v = (h @ lp["wv"]).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = rmsnorm(q, lp["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, lp["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = attention(q, k, v, cfg, causal=True)
        new_cache = (k, v)
    else:
        ck, cv = cache           # [B, Skv, Hkv, Dh], decode: S == 1
        start = min(max(int(cache_pos), 0), ck.shape[1] - S)
        ck[:, start:start + S] = k
        cv[:, start:start + S] = v
        o = _attn_xla(q, ck, cv, causal=True, q_offset=cache_pos,
                      scale=cfg.hd ** -0.5)
        new_cache = (ck, cv)
    x = x + (o.reshape(B, S, H * Dh) @ lp["wo"])

    h = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is None:
        y = _ffn_dense(h, lp, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        y, aux = moe_mod.moe_ffn(h, lp, cfg.moe, cfg.activation,
                                 impl=cfg.moe_impl)
    x = x + y
    x = dtype_fence(x, cfg.dtype)
    return x, new_cache, aux


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------

def _trunk(params, tokens, cfg: TransformerConfig, caches=None,
           cache_pos=None, donate: bool = False, keep_kv: bool = True):
    """Embedding and layers: (x [B, S, D] before the final norm, kvs,
    aux). Without caches the layers' k and v are written into one stacked
    [L, B, S, Hkv, Dh] pair (None with ``keep_kv=False``, as the loss
    needs none); with caches, into a copy of them, or into the caches
    themselves when ``donate`` is set."""
    B, S = tokens.shape
    if caches is not None and not donate:
        caches = tuple(t.clone() for t in caches)   # the caller's stay intact
    dt = cfg.torch_dtype
    x = params["embed"][tokens.long()].to(dt)
    if cfg.embed_scale:   # the scale rounded to the model's type first
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt, device=x.device)
    pos0 = 0 if cache_pos is None else int(cache_pos)
    positions = (pos0 + torch.arange(S, device=x.device))[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = caches
    for i in range(cfg.n_layers):
        lp = {name: t[i] for name, t in params["layers"].items()}
        if caches is None:
            x, (k, v), a = _layer(x, lp, cfg, positions)
            if keep_kv:
                if kvs is None:
                    kvs = tuple(torch.empty((cfg.n_layers, *t.shape),
                                            dtype=t.dtype, device=t.device)
                                for t in (k, v))
                kvs[0][i], kvs[1][i] = k, v
        else:
            x, _, a = _layer(x, lp, cfg, positions,
                             cache=(caches[0][i], caches[1][i]),
                             cache_pos=cache_pos)
        aux = aux + a
    return x, kvs, aux


def _logits(x, params, cfg: TransformerConfig):
    """Final norm and the unembedding, a float32 product."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x.float() @ params["unembed"].float()


def forward(params, tokens, cfg: TransformerConfig, caches=None,
            cache_pos=None, *, donate: bool = False):
    """tokens: [B, S]. caches: None | (k: [L, B, Skv, Hkv, Dh], v). Returns
    (logits_f32 [B, S, V], new_caches, aux_loss). The caches passed in are
    left intact, as in the reference, unless ``donate`` is set: then the new
    k and v are written into them in place and they are returned (the
    counterpart of the reference's ``donate_argnums``)."""
    x, kvs, aux = _trunk(params, tokens, cfg, caches, cache_pos, donate)
    return _logits(x, params, cfg), kvs, aux


def softmax_xent(logits, labels):
    """Mean token cross-entropy of f32 ``logits`` [..., V] against integer
    ``labels`` [...]."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None],
                              dim=-1)[..., 0]
    return (logz - ll).mean()


# --------------------------------------------------------------------------
# step functions
# --------------------------------------------------------------------------

def make_prefill_step(cfg: TransformerConfig):
    """prefill_step(params, {"tokens": [B, S]}) -> (last logits [B, V] f32,
    (k, v) caches [L, B, S, Hkv, Dh]). Only the last position is
    unembedded: the reference computes every position's logits and keeps
    the last, which is the same row (at gemma-7b's 4 x 2048 prompts the
    whole [B, S, V] f32 block is 8.4 GB)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        x, kvs, _ = _trunk(params, batch["tokens"], cfg)
        return _logits(x[:, -1:], params, cfg)[:, -1], kvs

    return prefill_step


def make_serve_step(cfg: TransformerConfig, *, donate: bool = False):
    """One decode step: new token [B, 1] + KV caches at position ``pos`` ->
    (last logits [B, V] f32, new caches). The caches passed in are left
    intact, as in the reference, unless ``donate`` is set: then they are
    written in place and returned, as the reference's serving example gets
    with ``jax.jit(serve_step, donate_argnums=(2,))``."""
    @torch.no_grad()
    def serve_step(params, token, caches, pos):
        logits, new_caches, _ = forward(params, token, cfg, caches=caches,
                                        cache_pos=pos, donate=donate)
        return logits[:, -1], new_caches

    return serve_step


def loss_fn(params, batch, cfg: TransformerConfig):
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"},
    each [B, S]) under ``params``; a differentiable scalar."""
    x, _, aux = _trunk(params, batch["tokens"], cfg, keep_kv=False)
    loss = softmax_xent(_logits(x, params, cfg), batch["labels"])
    return loss + (cfg.moe.aux_weight * aux / cfg.n_layers if cfg.moe
                   else 0.0)


def _value_and_grad(params, batch, cfg):
    """(loss, grads): the gradient of every leaf of ``params`` (a tree of
    tensors, left as it is), each in its leaf's type."""
    return value_and_grad(loss_fn, params, batch, cfg)


def make_train_step(cfg: TransformerConfig, opt_cfg, microbatches: int = 1):
    """train_step(params, opt_state, batch) -> (params', opt_state',
    {"loss", "grad_norm"}): the loss and its gradients, then one AdamW
    update (``optim.adamw_update``). ``microbatches`` > 1 splits the batch
    into that many equal slices along the batch axis, accumulates their
    gradients in f32 and averages gradients and loss: activation memory
    falls to a slice's, as in the reference. The parameters passed in are
    left as they are."""
    from repro_torch.optim import adamw_update

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _value_and_grad(params, batch, cfg)
        else:
            M = microbatches
            gacc = lsum = None
            for i in range(M):
                mb = {}
                for key, t in batch.items():
                    n = t.shape[0] // M
                    mb[key] = t[i * n:(i + 1) * n]
                loss, grads = _value_and_grad(params, mb, cfg)
                g32 = [g.float() for g in tree_leaves(grads)]
                gacc = g32 if gacc is None else [
                    a + g for a, g in zip(gacc, g32)]
                lsum = loss if lsum is None else lsum + loss
            grads = tree_unflatten(params, [g / M for g in gacc])
            loss = lsum / M
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
