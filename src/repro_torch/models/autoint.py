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

Sharding (``MeshAxes`` ``ax``, as the reference's): under a mesh of
processes (``launch.mesh.use_mesh``) the table is ``P(ax.model, None)``,
a ``model`` rank holding its block of rows; the other leaves are
replicated. The lookup is vocab-sharded: a rank takes the ids that fall
in its block, gives zeros for the others, and the ranks' bags are summed
over ``model``. The batch is this rank's rows over ``ax.data`` in the
logit, the loss and serving (the loss is the whole batch's mean), and
whole in retrieval, whose candidates ``cand_vecs`` are this rank's block
over ``model``: each rank scores its block, takes a local top-k, and the
ranks' values and global indices, gathered over ``model`` in rank order,
give every rank the whole top-k. With no mesh, or a mesh of one process,
nothing is exchanged.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.collectives import (all_gather_dim,
                                                 psum_named,
                                                 reduce_from_group)
from repro_torch.distributed.sharding import (MeshAxes, P, block, placement,
                                              use_weight, whole_size)
from repro_torch.models.gnn import mlp_apply, mlp_defs, take_rows
from repro_torch.models.moe import top_k as _top_k
from repro_torch.models.params import (ParamDef, specs, tree_leaves,
                                       tree_unflatten, value_and_grad)


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


def autoint_param_defs(cfg: AutoIntConfig, ax: MeshAxes):
    D, A, H = cfg.embed_dim, cfg.d_attn, cfg.n_heads
    layers = []
    d_in = D
    for _ in range(cfg.n_attn_layers):
        layers.append(dict(
            wq=ParamDef((d_in, H * A), P(None, None)),
            wk=ParamDef((d_in, H * A), P(None, None)),
            wv=ParamDef((d_in, H * A), P(None, None)),
            wres=ParamDef((d_in, H * A), P(None, None)),
        ))
        d_in = H * A
    return dict(
        table=ParamDef((cfg.total_vocab, D), P(ax.model, None),
                       init="embed", scale=0.01),
        layers=layers,
        head=mlp_defs([cfg.n_sparse * d_in, 64, 1]),
        retr_proj=mlp_defs([cfg.n_sparse * d_in, cfg.d_retrieval]),
    )


def _placed(params, cfg: AutoIntConfig, ax: MeshAxes, pl):
    """Every leaf in its use layout (``use_weight`` by its spec): the
    gradients of a data-sharded batch summed over ``data``."""
    if pl is None:
        return params
    return tree_unflatten(params, [
        use_weight(w, spec, pl, ax, 0) for w, spec in zip(
            tree_leaves(params), tree_leaves(specs(autoint_param_defs(
                cfg, ax))), strict=True)])


def _embed_fields(params, idx, cfg: AutoIntConfig, pl=None):
    """idx: [B, F, L] global row ids (sentinel total_vocab = padding).
    EmbeddingBag (sum) per field -> [B, F, D]. The take is the reference's
    default ``jnp.take``: ids in [-V, -1] wrap, ids below give NaN rows.
    Under a mesh (``pl``) the table is this ``model`` rank's block of rows:
    each rank sums the rows it holds and the bags are summed over
    ``model``."""
    V = cfg.total_vocab
    lo, hi = (0, V) if pl is None or pl.model is None else block(
        V, pl.m, pl.mi)
    valid = idx < V
    i = torch.clamp(idx, max=V - 1).long()
    i = torch.where(i < 0, i + V, i)
    mine = valid & (i >= lo) & (i < hi)
    rows = take_rows(params["table"], torch.where(mine, i - lo, hi - lo), 0.0)
    rows = torch.where((valid & (i < 0))[..., None], float("nan"), rows)
    return reduce_from_group(torch.sum(rows, dim=2), pl and pl.model)


def _interact(x, params, cfg: AutoIntConfig):
    """The self-attention layers over the fields: [B, F, D] -> [B, F * HA]."""
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


def autoint_embed(params, batch, cfg: AutoIntConfig, ax: MeshAxes,
                  batch_axes=None):
    """The interacted fields [B, F * HA] of this rank's rows. ``batch_axes``:
    the mesh axes the batch is sharded over (None: whole on every rank, as
    the retrieval query); a sharded batch's weight gradients are summed
    over them."""
    pl = placement(ax)
    if batch_axes is not None:
        params = _placed(params, cfg, ax, pl)
    x = _embed_fields(params, batch["sparse_idx"], cfg, pl)  # [B, F, D]
    return _interact(x, params, cfg)


def autoint_logit(params, batch, cfg, ax):
    """The logits of this rank's rows, the batch sharded over ``ax.data``."""
    params = _placed(params, cfg, ax, placement(ax))
    return mlp_apply(params["head"], autoint_embed(params, batch, cfg, ax),
                     2)[:, 0]


def autoint_loss(params, batch, cfg, ax):
    """The mean BCE over the whole batch, every rank passing its rows:
    the ranks' sums over the global count (ceil blocks need not be
    equal)."""
    logit = autoint_logit(params, batch, cfg, ax)
    y = batch["labels"].float()
    per = (torch.clamp(logit, min=0) - logit * y
           + torch.log1p(torch.exp(-torch.abs(logit))))
    pl = placement(ax)
    if pl is None or pl.data is None:
        return torch.mean(per)
    n = psum_named(torch.tensor(float(per.numel()), device=per.device),
                   pl.data)
    return reduce_from_group(per.sum(), pl.data) / n


def make_autoint_train_step(cfg: AutoIntConfig, ax: MeshAxes, opt_cfg):
    """train_step(params, opt_state, batch) -> (params', opt_state',
    {"loss", "grad_norm"}): the BCE loss, its gradients and one AdamW
    update. The parameters passed in are left as they are. Under a mesh
    each rank passes its shards and its rows of the batch; the clipping
    norm counts each leaf once over the mesh."""
    from repro_torch.optim import adamw_update
    pspecs = specs(autoint_param_defs(cfg, ax))

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(autoint_loss, params, batch, cfg, ax)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg, specs=pspecs)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step


def make_autoint_serve_step(cfg: AutoIntConfig, ax: MeshAxes):
    """serve_step(params, batch) -> sigmoid scores [B] of this rank's
    rows."""
    @torch.no_grad()
    def serve_step(params, batch):
        return torch.sigmoid(autoint_logit(params, batch, cfg, ax))
    return serve_step


def make_retrieval_step(cfg: AutoIntConfig, ax: MeshAxes, top_k: int = 100):
    """Score one query batch against [n_cand, d_retrieval] item vectors:
    (values, int32 indices) of the ``top_k`` best, descending, the lower
    index first among equal scores. Under a mesh the query is whole on
    every rank and ``cand_vecs`` this rank's block over ``model``; every
    rank returns the whole top-k over all the candidates."""

    @torch.no_grad()
    def retrieval_step(params, batch):
        pl = placement(ax)
        q = mlp_apply(params["retr_proj"],
                      autoint_embed(params, batch, cfg, ax), 1)   # [B, dR]
        cand = batch["cand_vecs"]
        scores = q @ cand.T                                       # [B, Nc]
        if pl is None or pl.model is None:
            return _top_k(scores, top_k)
        lo = block(whole_size(cand.shape[0], pl.model, cand.device), pl.m,
                   pl.mi)[0]
        vals, idx = _top_k(scores, top_k)
        # fewer than top_k candidates here: pad with -inf past every index
        pad = top_k - vals.shape[-1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=float("-inf"))
        gidx = torch.nn.functional.pad(idx + lo, (0, pad),
                                       value=torch.iinfo(torch.int32).max)
        vals = all_gather_dim(vals, pl.model, 1, pl.m * top_k)
        gidx = all_gather_dim(gidx, pl.model, 1, pl.m * top_k)
        top, pos = _top_k(vals, top_k)
        return top, torch.take_along_dim(gidx, pos.long(), dim=-1)

    return retrieval_step
