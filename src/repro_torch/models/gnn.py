"""GNN zoo: GAT, EGNN, MACE, GraphCast-style encoder-processor-decoder (the
reference's ``models/gnn.py``).

Message passing is built on a segment-op substrate: padded edge lists
``(src, dst)`` with sentinel ``N`` for padding, row gathers by src, and
sums and maxima scattered by dst. The substrate keeps the reference's
rules for ids out of range: a scatter drops ids outside ``[0, n)`` (it
adds into one extra row that is cut off, as ``index_add_`` would raise on
them), an empty segment's maximum reads ``-inf``, and a filled row gather
wraps ids in ``[-n, -1]`` and fills the rest (``jnp.take``'s
``mode="fill"``).

Batch dict convention (uniform across archs):
  node_feat [N, Df] f32      edge_src/edge_dst [E] int (N = pad sentinel)
  coords    [N, 3]  f32      (egnn / mace)
  edge_feat [E, De] f32      (graphcast)
  graph_id  [N] int          (batched small graphs; mace)
  labels    arch-dependent

The port runs on one device, so there is no sharding constraint and no
mesh axes argument; a ``ParamDef`` has no partition spec.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import torch
import torch.nn.functional as F

from repro_torch.models import equivariant as eqv
from repro_torch.models.params import ParamDef, value_and_grad


# --------------------------------------------------------------------------
# segment-op substrate
# --------------------------------------------------------------------------

def _rows(seg: torch.Tensor, n: int) -> torch.Tensor:
    """Segment ids with every id outside ``[0, n)`` moved onto row n."""
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < n), seg, n)


def seg_sum(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, seg, num_segments=n)``: ids outside
    ``[0, n)`` are dropped."""
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, _rows(seg, n), data)[:n]


def seg_max(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max``: ids outside ``[0, n)`` are dropped and an
    empty segment reads ``-inf``."""
    out = data.new_full((n + 1,) + tuple(data.shape[1:]), float("-inf"))
    idx = _rows(seg, n).view((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)[:n]


def seg_mean(data: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    s = seg_sum(data, seg, n)
    cnt = seg_sum(data.new_ones((data.shape[0],) + (1,) * (data.ndim - 1)),
                  seg, n)
    return s / torch.clamp(cnt, min=1.0)


def take_rows(x: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(x, idx, axis=0, mode="fill", fill_value=fill)``: ids in
    ``[-n, -1]`` wrap, ids below ``-n`` or from ``n`` up give rows of
    ``fill``."""
    n = x.shape[0]
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    rows = x.index_select(0, torch.where(ok, i, 0).reshape(-1))
    rows = rows.reshape(tuple(idx.shape) + tuple(x.shape[1:]))
    ok = ok.reshape(tuple(idx.shape) + (1,) * (x.ndim - 1))
    return torch.where(ok, rows, torch.as_tensor(fill, dtype=x.dtype,
                                                 device=x.device))


def seg_softmax(scores: torch.Tensor, seg: torch.Tensor, n: int):
    """Numerically-stable softmax over edges grouped by destination."""
    mx = seg_max(scores, seg, n)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.exp(scores - take_rows(mx, seg, 0.0))
    den = seg_sum(ex, seg, n)
    return ex / take_rows(torch.clamp(den, min=1e-9), seg, 1.0)


def gather_nodes(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return take_rows(h, idx, 0.0)


# --------------------------------------------------------------------------
# tiny MLP helper (ParamDef-declared)
# --------------------------------------------------------------------------

def mlp_defs(dims, *, ln: bool = False):
    d = {}
    for i in range(len(dims) - 1):
        d[f"w{i}"] = ParamDef((dims[i], dims[i + 1]))
        d[f"b{i}"] = ParamDef((dims[i + 1],), init="zeros")
    if ln:
        d["ln"] = ParamDef((dims[-1],), init="ones")
    return d


def mlp_apply(p, x, n_layers, act=F.silu):
    for i in range(n_layers):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n_layers - 1:
            x = act(x)
    if "ln" in p:
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
        x = (x - mu) * torch.rsqrt(var + 1e-5) * p["ln"]
    return x


# ==========================================================================
# GAT  [arXiv:1710.10903]
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class GatConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    leaky_slope: float = 0.2


def gat_param_defs(cfg: GatConfig):
    layers = []
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append(dict(
            w=ParamDef((d_in, heads * d_out)),
            a_src=ParamDef((heads, d_out)),
            a_dst=ParamDef((heads, d_out)),
        ))
        d_in = heads * d_out
    return dict(layers=layers)


def gat_forward(params, batch, cfg: GatConfig):
    h = batch["node_feat"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    N = h.shape[0]
    pad = src >= N
    seg = torch.where(pad, N, dst)
    for i, lp in enumerate(params["layers"]):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        wh = (h @ lp["w"]).reshape(N, heads, d_out)
        s_src = torch.einsum("nhd,hd->nh", wh, lp["a_src"])
        s_dst = torch.einsum("nhd,hd->nh", wh, lp["a_dst"])
        e = gather_nodes(s_src, src) + gather_nodes(s_dst, dst)   # [E, H]
        e = F.leaky_relu(e, cfg.leaky_slope)
        e = torch.where(pad[:, None], float("-inf"), e)
        alpha = seg_softmax(e, seg, N)                            # [E, H]
        msg = alpha[..., None] * gather_nodes(wh, src)            # [E, H, D]
        h = seg_sum(msg, seg, N).reshape(N, heads * d_out)
        if not last:
            h = F.elu(h)
    return h  # [N, n_classes]


def gat_loss(params, batch, cfg):
    logits = gat_forward(params, batch, cfg)
    labels = batch["labels"]
    mask = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(
        logits, torch.clamp(labels, min=0).long()[:, None], dim=-1)[:, 0]
    return (torch.sum(torch.where(mask, logz - ll, 0.0))
            / torch.clamp(mask.sum(), min=1))


# ==========================================================================
# EGNN  [arXiv:2102.09844]
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class EgnnConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_in: int = 16


def egnn_param_defs(cfg: EgnnConfig):
    D = cfg.d_hidden
    layers = [dict(
        phi_e=mlp_defs([2 * D + 1, D, D]),
        phi_x=mlp_defs([D, D, 1]),
        phi_h=mlp_defs([2 * D, D, D]),
    ) for _ in range(cfg.n_layers)]
    return dict(embed=mlp_defs([cfg.d_in, D]), layers=layers,
                readout=mlp_defs([D, D, 1]))


def egnn_forward(params, batch, cfg: EgnnConfig):
    h = mlp_apply(params["embed"], batch["node_feat"], 1)
    x = batch["coords"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    N = h.shape[0]
    pad = src >= N
    seg = torch.where(pad, N, dst)
    for lp in params["layers"]:
        xs, xd = gather_nodes(x, src), gather_nodes(x, dst)
        d2 = torch.sum((xd - xs) ** 2, dim=-1, keepdim=True)
        m = mlp_apply(lp["phi_e"],
                      torch.cat([gather_nodes(h, dst),
                                 gather_nodes(h, src), d2], -1), 2)
        m = torch.where(pad[:, None], 0.0, m)
        w = mlp_apply(lp["phi_x"], m, 2)                      # [E, 1]
        x = x + seg_mean((xd - xs) * w, seg, N)
        agg = seg_sum(m, seg, N)
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, agg], -1), 2)
    return h, x


def egnn_loss(params, batch, cfg):
    h, x = egnn_forward(params, batch, cfg)
    pred = mlp_apply(params["readout"], h, 2)[:, 0]
    return torch.mean((pred - batch["labels"]) ** 2)


# ==========================================================================
# MACE  [arXiv:2206.07697] — l<=2 irreps, correlation order 3
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class MaceConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 10

    @property
    def ls(self):
        return tuple(range(self.l_max + 1))


def _tp_paths(l_max):
    """Allowed (l1, l2, l3) couplings with all l <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return out


def mace_param_defs(cfg: MaceConfig):
    C = cfg.d_hidden
    paths = _tp_paths(cfg.l_max)
    layers = []
    for _ in range(cfg.n_layers):
        lp = dict(
            radial=mlp_defs([cfg.n_rbf, C, len(paths) * C]),
            # per-l channel mixing after aggregation (A-basis linear)
            mix_a={str(l): ParamDef((C, C)) for l in cfg.ls},
            # product-basis mixing (correlation 2 and 3 contributions)
            mix_b2={str(l): ParamDef((C, C)) for l in cfg.ls},
            mix_b3={str(l): ParamDef((C, C)) for l in cfg.ls},
            update={str(l): ParamDef((C, C)) for l in cfg.ls},
            resid={str(l): ParamDef((C, C)) for l in cfg.ls},
        )
        layers.append(lp)
    return dict(
        embed=ParamDef((cfg.n_species, C), init="embed", scale=1.0),
        layers=layers,
        readout=mlp_defs([C, C, 1]),
    )


@lru_cache(maxsize=None)
def _cg_on(l1: int, l2: int, l3: int, device: torch.device):
    """``real_cg(l1, l2, l3)`` as a tensor on ``device``, made once."""
    return torch.from_numpy(eqv.real_cg(l1, l2, l3)).to(device)


def _tensor_product(a, b, l1, l2, l3):
    """Channel-wise CG product: a [N,C,2l1+1] x b [N,C|1,2l2+1] -> [N,C,2l3+1]."""
    cg = _cg_on(l1, l2, l3, a.device)
    if b.ndim == 2:  # SH without channel dim
        return torch.einsum("ncx,ny,xyz->ncz", a, b, cg)
    return torch.einsum("ncx,ncy,xyz->ncz", a, b, cg)


def _mix(x, w):
    return torch.einsum("ncm,cd->ndm", x, w)


def mace_forward(params, batch, cfg: MaceConfig):
    src, dst = batch["edge_src"], batch["edge_dst"]
    x = batch["coords"]
    N = x.shape[0]
    C = cfg.d_hidden
    pad = src >= N
    seg = torch.where(pad, N, dst)
    species = batch["node_feat"][:, 0].int()
    embed = params["embed"]

    h = {l: x.new_zeros((N, C, 2 * l + 1)) for l in cfg.ls}
    h[0] = embed[torch.clamp(species, 0, embed.shape[0] - 1).long()][..., None]

    vec = gather_nodes(x, dst) - gather_nodes(x, src)
    r = torch.sqrt(torch.sum(vec * vec, -1) + 1e-9)
    sh = eqv.spherical_harmonics(vec)                     # {l2: [E, 2l2+1]}
    rbf = eqv.bessel_rbf(r, cfg.n_rbf, cfg.r_cut)         # [E, n_rbf]
    paths = _tp_paths(cfg.l_max)

    for lp in params["layers"]:
        Rw = mlp_apply(lp["radial"], rbf, 2).reshape(-1, len(paths), C)
        Rw = torch.where(pad[:, None, None], 0.0, Rw)
        # ---- A-basis: aggregate R * (h_src^l1 x Y^l2 -> l3) per path ------
        A = {l: x.new_zeros((N, C, 2 * l + 1)) for l in cfg.ls}
        for pi, (l1, l2, l3) in enumerate(paths):
            hj = gather_nodes(h[l1], src)                 # [E, C, 2l1+1]
            tp = _tensor_product(hj, sh[l2], l1, l2, l3)  # [E, C, 2l3+1]
            A[l3] = A[l3] + seg_sum(tp * Rw[:, pi, :, None], seg, N)
        A = {l: _mix(A[l], lp["mix_a"][str(l)]) for l in cfg.ls}
        # ---- B-basis: symmetric products up to correlation 3 --------------
        B = {l: A[l] for l in cfg.ls}
        A2 = {l: torch.zeros_like(A[l]) for l in cfg.ls}
        for (l1, l2, l3) in paths:
            A2[l3] = A2[l3] + _tensor_product(A[l1], A[l2], l1, l2, l3)
        for l in cfg.ls:
            B[l] = B[l] + _mix(A2[l], lp["mix_b2"][str(l)])
        A3 = {l: torch.zeros_like(A[l]) for l in cfg.ls}
        for (l1, l2, l3) in paths:
            A3[l3] = A3[l3] + _tensor_product(A2[l1], A[l2], l1, l2, l3)
        for l in cfg.ls:
            B[l] = B[l] + _mix(A3[l], lp["mix_b3"][str(l)])
        # ---- update + residual -------------------------------------------
        h = {l: _mix(B[l], lp["update"][str(l)])
             + _mix(h[l], lp["resid"][str(l)])
             for l in cfg.ls}
    return h


def mace_loss(params, batch, cfg: MaceConfig):
    h = mace_forward(params, batch, cfg)
    site_e = mlp_apply(params["readout"], h[0][..., 0], 2)[:, 0]   # [N]
    G = batch["graph_energy"].shape[0]
    energy = seg_sum(site_e, batch["graph_id"], G)
    return torch.mean((energy - batch["graph_energy"]) ** 2)


# ==========================================================================
# GraphCast-style encoder-processor-decoder  [arXiv:2212.12794]
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class GraphcastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    n_vars: int = 227
    mesh_refinement: int = 6
    d_edge_in: int = 4


def graphcast_param_defs(cfg: GraphcastConfig):
    D = cfg.d_hidden
    layers = [dict(
        edge_mlp=mlp_defs([3 * D, D, D], ln=True),
        node_mlp=mlp_defs([2 * D, D, D], ln=True),
    ) for _ in range(cfg.n_layers)]
    return dict(
        node_enc=mlp_defs([cfg.n_vars, D, D], ln=True),
        edge_enc=mlp_defs([cfg.d_edge_in, D, D], ln=True),
        layers=layers,
        node_dec=mlp_defs([D, D, cfg.n_vars]),
    )


def graphcast_forward(params, batch, cfg: GraphcastConfig):
    src, dst = batch["edge_src"], batch["edge_dst"]
    N = batch["node_feat"].shape[0]
    pad = src >= N
    seg = torch.where(pad, N, dst)
    h = mlp_apply(params["node_enc"], batch["node_feat"], 2)
    e = mlp_apply(params["edge_enc"], batch["edge_feat"], 2)
    for lp in params["layers"]:
        cat = torch.cat([e, gather_nodes(h, src), gather_nodes(h, dst)],
                        dim=-1)
        e = e + mlp_apply(lp["edge_mlp"], cat, 2)
        e = torch.where(pad[:, None], 0.0, e)
        agg = seg_sum(e, seg, N)
        h = h + mlp_apply(lp["node_mlp"], torch.cat([h, agg], -1), 2)
    return mlp_apply(params["node_dec"], h, 2)


def graphcast_loss(params, batch, cfg):
    out = graphcast_forward(params, batch, cfg)
    return torch.mean((out - batch["labels"]) ** 2)


# arch name in the registry -> (param defs, forward, loss)
MODELS = {
    "gat-cora": (gat_param_defs, gat_forward, gat_loss),
    "egnn": (egnn_param_defs, egnn_forward, egnn_loss),
    "mace": (mace_param_defs, mace_forward, mace_loss),
    "graphcast": (graphcast_param_defs, graphcast_forward, graphcast_loss),
}


# --------------------------------------------------------------------------
# generic train step
# --------------------------------------------------------------------------

def make_gnn_train_step(loss_f, cfg, opt_cfg):
    """train_step(params, opt_state, batch) -> (params', opt_state',
    {"loss", "grad_norm"}): the loss and its gradients, then one AdamW
    update. The parameters passed in are left as they are."""
    from repro_torch.optim import adamw_update

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_f, params, batch, cfg)
        params, opt_state, gnorm = adamw_update(params, grads, opt_state,
                                                opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
