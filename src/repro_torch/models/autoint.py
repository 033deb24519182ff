"""AutoInt [arXiv:1810.11921]: self-attention feature interaction over
sparse-field embeddings (the reference's ``models/autoint.py``).

The embedding table is one combined table ``[n_fields * vocab_per_field,
d]``; a field's bag of ids is looked up with a row take and a masked sum,
as the reference does (``kernels/embedding_bag`` holds the kernel of the
same op, which this model does not call). The id ``total_vocab`` is the
padding sentinel.

Steps: train (BCE), serve (sigmoid scores), retrieval (query embedding vs
candidate vectors: one matmul and a top-k, the lower index first among
equal scores, as ``lax.top_k``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import mlp_apply, mlp_defs, take_rows
from repro_torch.models.moe import top_k as _top_k
from repro_torch.models.params import ParamDef, value_and_grad


@dataclasses.dataclass(frozen=True)
class AutoIntConfig:
    name: str = "autoint"
    n_sparse: int = 39
    vocab_per_field: int = 1_000_000
    embed_dim: int = 16
    n_attn_layers: int = 3
    n_heads: int = 2
    d_attn: int = 32
    multi_hot: int = 1           # bag length per field (1 = one-hot)
    d_retrieval: int = 64

    @property
    def total_vocab(self):
        return self.n_sparse * self.vocab_per_field


def autoint_param_defs(cfg: AutoIntConfig):
    D, A, H = cfg.embed_dim, cfg.d_attn, cfg.n_heads
    layers = []
    d_in = D
    for _ in range(cfg.n_attn_layers):
        layers.append(dict(
            wq=ParamDef((d_in, H * A)),
            wk=ParamDef((d_in, H * A)),
            wv=ParamDef((d_in, H * A)),
            wres=ParamDef((d_in, H * A)),
        ))
        d_in = H * A
    return dict(
        table=ParamDef((cfg.total_vocab, D), init="embed", scale=0.01),
        layers=layers,
        head=mlp_defs([cfg.n_sparse * d_in, 64, 1]),
        retr_proj=mlp_defs([cfg.n_sparse * d_in, cfg.d_retrieval]),
    )


def _embed_fields(params, idx, cfg: AutoIntConfig):
    """idx: [B, F, L] global row ids (sentinel total_vocab = padding).
    EmbeddingBag (sum) per field -> [B, F, D]. The take is the reference's
    default ``jnp.take``: ids in [-V, -1] wrap, ids below give NaN rows."""
    V = cfg.total_vocab
    valid = idx < V
    rows = take_rows(params["table"], torch.clamp(idx, max=V - 1),
                     float("nan"))
    rows = torch.where(valid[..., None], rows, 0.0)
    return torch.sum(rows, dim=2)


def autoint_embed(params, batch, cfg: AutoIntConfig):
    x = _embed_fields(params, batch["sparse_idx"], cfg)      # [B, F, D]
    B, F, _ = x.shape
    H, A = cfg.n_heads, cfg.d_attn
    for lp in params["layers"]:
        q = (x @ lp["wq"]).reshape(B, F, H, A)
        k = (x @ lp["wk"]).reshape(B, F, H, A)
        v = (x @ lp["wv"]).reshape(B, F, H, A)
        s = torch.einsum("bfha,bgha->bhfg", q, k) / (A ** 0.5)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhfg,bgha->bfha", p, v).reshape(B, F, H * A)
        x = torch.relu(o + x @ lp["wres"])
    return x.reshape(B, -1)


def autoint_logit(params, batch, cfg):
    flat = autoint_embed(params, batch, cfg)
    return mlp_apply(params["head"], flat, 2)[:, 0]


def autoint_loss(params, batch, cfg):
    logit = autoint_logit(params, batch, cfg)
    y = batch["labels"].float()
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def make_autoint_train_step(cfg: AutoIntConfig, opt_cfg):
    """train_step(params, opt_state, batch) -> (params', opt_state',
    {"loss", "grad_norm"}): the BCE loss, its gradients and one AdamW
    update. The parameters passed in are left as they are."""
    from repro_torch.optim import adamw_update

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(autoint_loss, params, batch, cfg)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_autoint_serve_step(cfg: AutoIntConfig):
    @torch.no_grad()
    def serve_step(params, batch):
        return torch.sigmoid(autoint_logit(params, batch, cfg))
    return serve_step


def make_retrieval_step(cfg: AutoIntConfig, top_k: int = 100):
    """Score one query batch against [n_cand, d_retrieval] item vectors:
    (values, int32 indices) of the ``top_k`` best, descending, the lower
    index first among equal scores."""

    @torch.no_grad()
    def retrieval_step(params, batch):
        q = mlp_apply(params["retr_proj"],
                      autoint_embed(params, batch, cfg), 1)       # [B, dR]
        scores = q @ batch["cand_vecs"].T                         # [B, Nc]
        return _top_k(scores, top_k)

    return retrieval_step
