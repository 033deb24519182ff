"""Cell registry (the reference's ``configs/registry.py``): the
architectures the port runs, the reference's shape tables, and its cells,
(architecture x input shape) -> the port's step, its arguments as
``meta`` tensors and a ``model_flops`` estimate for the roofline's useful
compute ratio.

``list_cells`` gives the reference's 44 cells in its order, and every
cell's ``model_flops`` and argument bytes equal the reference's (at
``n_parts`` equal to its mesh's size for SSSP). A cell has no shardings
yet (the steps run over a mesh of processes, ``launch.mesh.use_mesh``,
but a cell's ``in_shardings`` are ROADMAP item 11b), and ``build_cell``
takes no mesh. The dry run (``launch/dryrun.py``) runs each step on
``meta`` tensors."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

import torch

LM_ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b", "mistral-large-123b",
            "gemma-7b", "deepseek-7b"]
GNN_ARCHS = ["gat-cora", "egnn", "mace", "graphcast"]
REC_ARCHS = ["autoint"]

ARCHS = {
    "olmoe-1b-7b": ("lm", "repro_torch.configs.olmoe_1b_7b"),
    "qwen3-moe-235b-a22b": ("lm", "repro_torch.configs.qwen3_moe_235b_a22b"),
    "mistral-large-123b": ("lm", "repro_torch.configs.mistral_large_123b"),
    "gemma-7b": ("lm", "repro_torch.configs.gemma_7b"),
    "deepseek-7b": ("lm", "repro_torch.configs.deepseek_7b"),
    "gat-cora": ("gnn", "repro_torch.configs.gat_cora"),
    "egnn": ("gnn", "repro_torch.configs.egnn"),
    "mace": ("gnn", "repro_torch.configs.mace"),
    "graphcast": ("gnn", "repro_torch.configs.graphcast"),
    "autoint": ("recsys", "repro_torch.configs.autoint"),
}

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _pad512(x: int) -> int:
    """Node/edge counts padded to the 512-device lcm so 1-D sharding divides
    evenly on both production meshes (sentinel padding is the models'
    native convention)."""
    return -(-x // 512) * 512


GNN_SHAPES = {
    "full_graph_sm": dict(n_nodes=_pad512(2708), n_edges=_pad512(10556),
                          d_feat=1433, n_classes=7, batched=False,
                          note="Cora 2708v/10556e padded to /512"),
    "minibatch_lg": dict(n_nodes=_pad512(169984), n_edges=_pad512(168960),
                         d_feat=602, n_classes=41, batched=False,
                         note="sampled block: 1024 seeds, fanout 15-10 over a "
                              "233k-node graph (Reddit-like); shapes are the "
                              "padded sampler output"),
    "ogb_products": dict(n_nodes=_pad512(2449029), n_edges=_pad512(61859140),
                         d_feat=100, n_classes=47, batched=False,
                         note="ogbn-products padded to /512"),
    "molecule": dict(n_nodes=_pad512(30 * 128), n_edges=_pad512(64 * 128),
                     d_feat=16, n_classes=2, batched=True, n_graphs=128),
}

REC_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

SSSP_SHAPES = {"graph1": {}, "graph2": {}, "graph3": {}, "graph4": {}}

SHAPES = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": REC_SHAPES,
          "sssp": SSSP_SHAPES}


def _load(arch: str, smoke: bool = False):
    family, mod = ARCHS[arch]
    m = importlib.import_module(mod)
    return family, (m.SMOKE if smoke else m.CONFIG)


# ---------------------------------------------------------------------------
# cells: (architecture x input shape) -> step, abstract arguments, FLOPs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """One (architecture x input shape) cell: the port's step, its
    arguments as ``meta`` tensors (nothing allocated; the reference's
    ``ShapeDtypeStruct`` structs), and the useful work ``model_flops`` by
    the reference's formulas. The reference's ``in_shardings`` and
    ``donate_argnums`` place arguments on a TPU mesh and mean nothing on one
    card, so a port cell has neither."""
    arch: str
    shape: str
    kind: str
    step_fn: Callable | None
    args_struct: tuple | None
    model_flops: float
    note: str = ""
    skip: str | None = None


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def arg_leaves(args) -> list:
    """The tensors of a cell's arguments: tree leaves, and the array fields
    of an ``SsspShards`` (its static sizes are no arguments)."""
    from repro_torch.core.shards import SsspShards
    from repro_torch.models.params import tree_leaves
    out = []
    for leaf in tree_leaves(args):
        if isinstance(leaf, SsspShards):
            out += [getattr(leaf, f.name) for f in dataclasses.fields(leaf)
                    if isinstance(getattr(leaf, f.name), torch.Tensor)]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def argument_bytes(args) -> int:
    """Bytes of a cell's arguments: the sum over ``arg_leaves``."""
    return sum(t.numel() * t.element_size() for t in arg_leaves(args))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LONG_500K_SKIP = ("pure full-attention arch: 512K-token dense attention is "
                  "quadratically infeasible; skipped per task rule (no "
                  "SSM/linear-attn variant assigned). See DESIGN.md §5.")


def _lm_cell(arch, cfg, shape_id) -> Cell:
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import abstract
    from repro_torch.optim import AdamWConfig, adamw_init
    sh = LM_SHAPES[shape_id]
    if shape_id == "long_500k":
        return Cell(arch, shape_id, "decode", None, None, 0.0,
                    skip=LONG_500K_SKIP)
    ax = MeshAxes(data=("data",))
    p_struct = abstract(tf.param_defs(cfg, ax), cfg.dtype)
    N_active = cfg.n_active_params()
    B, S = sh["batch"], sh["seq"]
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    if sh["kind"] == "train":
        step = tf.make_train_step(cfg, ax, AdamWConfig())
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        args = (p_struct, adamw_init(p_struct), batch)
        return Cell(arch, shape_id, "train", step, args, 6.0 * N_active * B * S)

    if sh["kind"] == "prefill":
        step = tf.make_prefill_step(cfg, ax)
        args = (p_struct, {"tokens": _meta((B, S), torch.int32)})
        return Cell(arch, shape_id, "prefill", step, args,
                    2.0 * N_active * B * S)

    # decode: one new token against a KV cache of seq_len
    step = tf.make_serve_step(cfg, ax)
    caches = tuple(_meta((L, B, S, Hkv, Dh), cfg.torch_dtype)
                   for _ in range(2))
    args = (p_struct, _meta((B, 1), torch.int32), caches,
            _meta((), torch.int32))
    # useful flops: dense read of active params + attention over the cache
    flops = 2.0 * N_active * B + 4.0 * L * B * S * Hkv * Dh
    return Cell(arch, shape_id, "decode", step, args, flops)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_batch_struct(arch, cfg, sh):
    N, E, Df = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    f32, i32 = torch.float32, torch.int32
    b = {"node_feat": _meta((N, Df)), "edge_src": _meta((E,), i32),
         "edge_dst": _meta((E,), i32)}
    if arch == "gat-cora":
        b["labels"] = _meta((N,), i32)
    elif arch == "egnn":
        b["coords"] = _meta((N, 3))
        b["labels"] = _meta((N,), f32)
    elif arch == "mace":
        b["coords"] = _meta((N, 3))
        b["graph_id"] = _meta((N,), i32)
        b["graph_energy"] = _meta((sh.get("n_graphs", 1),))
    elif arch == "graphcast":
        b["edge_feat"] = _meta((E, cfg.d_edge_in))
        b["labels"] = _meta((N, cfg.n_vars))
    return b


def _gnn_flops(arch, cfg, sh):
    N, E, Df = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    L = cfg.n_layers
    if arch == "gat-cora":
        D, H = cfg.d_hidden, cfg.n_heads
        return 6.0 * (N * Df * H * D + (L - 1) * E * H * D * 4 + E * H * D * 2)
    if arch == "egnn":
        D = cfg.d_hidden
        return 6.0 * L * (E * (2 * D + 1) * D * 2 + E * D * D
                          + N * 2 * D * D * 2)
    if arch == "mace":
        C = cfg.d_hidden
        # the reference's count of couplings, |{(l1,l2,l3): l<=2}|; the
        # model's _tp_paths(2) has 15 (ROADMAP, reference caveats)
        n_paths = 19
        per_edge = n_paths * C * 45          # CG contractions, l<=2 (m-dims <=5)
        per_node = 5 * C * C * 9 * 2         # channel mixes across l
        return 6.0 * L * (E * per_edge + N * per_node)
    if arch == "graphcast":
        D = cfg.d_hidden
        enc = N * Df * D + E * cfg.d_edge_in * D
        per_layer = E * (3 * D) * D + E * D * D + N * (2 * D) * D + N * D * D
        dec = N * D * cfg.n_vars
        return 6.0 * (enc + L * per_layer + dec)
    raise ValueError(arch)


def _gnn_cell(arch, cfg, shape_id) -> Cell:
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.models import gnn
    from repro_torch.models.params import abstract
    from repro_torch.optim import AdamWConfig, adamw_init
    sh = GNN_SHAPES[shape_id]
    # adapt input/output dims to the shape's graph
    if arch == "gat-cora":
        cfg = dataclasses.replace(cfg, d_in=sh["d_feat"],
                                  n_classes=sh["n_classes"])
    elif arch == "egnn":
        cfg = dataclasses.replace(cfg, d_in=sh["d_feat"])
    elif arch == "mace":
        if not sh["batched"]:
            sh = dict(sh, n_graphs=1)
    elif arch != "graphcast":
        raise ValueError(arch)
    ax = MeshAxes(data=("data",))
    param_defs, _, loss = gnn.MODELS[arch]
    defs = param_defs(cfg, ax)
    if arch == "graphcast":
        # inputs follow the shape's d_feat; outputs stay n_vars=227
        defs["node_enc"] = gnn.mlp_defs(
            [sh["d_feat"], cfg.d_hidden, cfg.d_hidden], ln=True)
    p_struct = abstract(defs)
    step = gnn.make_gnn_train_step(loss, cfg, ax, AdamWConfig())
    args = (p_struct, adamw_init(p_struct), _gnn_batch_struct(arch, cfg, sh))
    return Cell(arch, shape_id, "train", step, args,
                _gnn_flops(arch, cfg, sh), note=sh.get("note", ""))


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _rec_cell(arch, cfg, shape_id) -> Cell:
    from repro_torch.distributed.sharding import MeshAxes
    from repro_torch.models import autoint as ai
    from repro_torch.models.params import abstract
    from repro_torch.optim import AdamWConfig, adamw_init
    sh = REC_SHAPES[shape_id]
    B = sh["batch"]
    ax = MeshAxes(data=("data",))
    p_struct = abstract(ai.autoint_param_defs(cfg, ax))
    F, Lh = cfg.n_sparse, cfg.multi_hot
    idx = _meta((B, F, Lh), torch.int32)

    D, A, H, nL = cfg.embed_dim, cfg.d_attn, cfg.n_heads, cfg.n_attn_layers
    attn_flops = nL * (3 * B * F * (H * A) * (H * A) + 2 * B * H * F * F * A)
    embed_flops = B * F * Lh * D
    base = attn_flops + embed_flops + B * F * H * A * 64

    if sh["kind"] == "train":
        step = ai.make_autoint_train_step(cfg, ax, AdamWConfig())
        batch = {"sparse_idx": idx, "labels": _meta((B,), torch.int32)}
        args = (p_struct, adamw_init(p_struct), batch)
        return Cell(arch, shape_id, "train", step, args, 3.0 * base)

    if sh["kind"] == "serve":
        step = ai.make_autoint_serve_step(cfg, ax)
        args = (p_struct, {"sparse_idx": idx})
        return Cell(arch, shape_id, "serve", step, args, base)

    Nc = sh["n_candidates"]
    step = ai.make_retrieval_step(cfg, ax)
    batch = {"sparse_idx": idx, "cand_vecs": _meta((Nc, cfg.d_retrieval))}
    return Cell(arch, shape_id, "retrieval", step, (p_struct, batch),
                base + 2.0 * B * Nc * cfg.d_retrieval)


# ---------------------------------------------------------------------------
# SSSP (paper) cells
# ---------------------------------------------------------------------------

def _sssp_abstract_shards(gspec, n_parts: int):
    """The stacked ``[P, ...]`` shards of ``gspec`` at ``n_parts`` as meta
    tensors, the fields the reference's abstract shards have; no tile
    layouts."""
    from repro_torch.core.shards import SsspShards
    s = gspec.shard_shapes(n_parts)
    Pn = n_parts
    i32, f32, b_ = torch.int32, torch.float32, torch.bool
    return SsspShards(
        loc_src=_meta((Pn, s["e_loc"]), i32),
        loc_dst=_meta((Pn, s["e_loc"]), i32),
        loc_w=_meta((Pn, s["e_loc"]), f32),
        cut_src=_meta((Pn, s["e_cut"]), i32),
        cut_w=_meta((Pn, s["e_cut"]), f32),
        cut_seg=_meta((Pn, s["e_cut"]), i32),
        slot_owner=_meta((Pn, s["S"]), i32),
        slot_dstl=_meta((Pn, s["S"]), i32),
        slot_pos=_meta((Pn, s["S"]), i32), slot_valid=_meta((Pn, s["S"]), b_),
        recv_idx=_meta((Pn, Pn, s["C"]), i32),
        tri_uj=_meta((Pn, s["T"]), i32), tri_ui=_meta((Pn, s["T"]), i32),
        tri_ij=_meta((Pn, s["T"]), i32), tri_valid=_meta((Pn, s["T"]), b_),
        inter_edges=_meta((Pn,), i32),
        n_vertices=gspec.n_vertices, n_parts=Pn, block=s["block"])


def _sssp_cell(shape_id, n_parts: int, sssp_cfg=None) -> Cell:
    from repro_torch.configs.sssp_paper import GRAPHS
    from repro_torch.core.sssp import SsspConfig, solve_sim
    gspec = GRAPHS[shape_id]
    cfg = sssp_cfg or SsspConfig(max_rounds=64)
    shards = _sssp_abstract_shards(gspec, n_parts)
    # one full relaxation of every edge + the exchange, per round; report
    # per-round useful work (min-plus relax = 1 add + 1 min per edge)
    flops = 2.0 * gspec.n_edges
    return Cell("sp-async", shape_id, "sssp",
                lambda sh: solve_sim(sh, 0, cfg), (shards,), flops,
                note=f"cut={gspec.cut_fraction}, rounds capped at "
                     f"{cfg.max_rounds} for the dry-run lowering")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_id: str, mesh=None, ax=None,
               smoke: bool = False, **kw) -> Cell:
    """The cell of ``arch`` at ``shape_id``, in the reference's argument
    order. A cell carries no shardings yet (ROADMAP item 11b): ``mesh``
    and ``ax`` must be None, and an LM cell's steps take the one-process
    ``MeshAxes``. An SSSP cell (``arch`` "sp-async" or
    "sssp") stacks ``kw["n_parts"]`` shards (default 256, the reference's
    16 x 16 production mesh) and solves with ``kw["sssp_cfg"]`` (default
    ``SsspConfig(max_rounds=64)``)."""
    if mesh is not None or ax is not None:
        raise ValueError(
            "build_cell: a cell carries no shardings yet; pass "
            "mesh=None and ax=None (SSSP cells take n_parts=)")
    if arch in ("sp-async", "sssp"):
        return _sssp_cell(shape_id, kw.get("n_parts", 256),
                          kw.get("sssp_cfg"))
    family, cfg = _load(arch, smoke)
    if family == "lm":
        return _lm_cell(arch, cfg, shape_id)
    if family == "gnn":
        return _gnn_cell(arch, cfg, shape_id)
    return _rec_cell(arch, cfg, shape_id)


def list_cells(include_sssp: bool = True):
    out = []
    for arch, (family, _) in ARCHS.items():
        for shape_id in SHAPES[family]:
            out.append((arch, shape_id))
    if include_sssp:
        for g in SSSP_SHAPES:
            out.append(("sp-async", g))
    return out
