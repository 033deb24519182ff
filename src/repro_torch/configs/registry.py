"""Cell registry (the reference's ``configs/registry.py``): the
architectures the port runs, the reference's shape tables, and its cells,
(architecture x input shape x mesh) -> the port's step, its arguments as
``meta`` tensors, their ``in_shardings`` and a ``model_flops`` estimate
for the roofline's useful compute ratio.

``list_cells`` gives the reference's 44 cells in its order, and every
cell's ``model_flops`` equals the reference's. ``build_cell(arch, shape,
mesh, ax)`` takes a mesh of processes (``launch.mesh.HostMesh``, such as
``make_production_mesh``'s) and the ``MeshAxes`` the steps shard over:
``in_shardings`` is then the tree of ``NamedSharding(mesh, spec)`` whose
specs are the reference's, leaf for leaf, and the arguments are ``meta``
tensors of this rank's blocks of them (``sharding.shard_ranges``' ceil
blocks); the steps run under ``launch.mesh.use_mesh(mesh)``. With
``mesh=None, ax=None`` a cell is the one-card cell, its arguments whole
and ``in_shardings`` None. The dry run (``launch/dryrun.py``) runs each
step on its ``meta`` arguments."""
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
    """One (architecture x input shape) cell, in the reference's fields:
    the port's step, its arguments as ``meta`` tensors (nothing
    allocated; the reference's ``ShapeDtypeStruct`` structs; under a mesh
    this rank's blocks), their ``in_shardings`` (None on one card), the
    useful work ``model_flops`` by the reference's formulas, and the
    arguments a step may write in place (``donate_argnums``, the
    reference's default: none)."""
    arch: str
    shape: str
    kind: str
    step_fn: Callable | None
    args_struct: tuple | None
    in_shardings: tuple | None
    model_flops: float
    note: str = ""
    skip: str | None = None
    donate_argnums: tuple = ()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _expand(leaves):
    """Tree leaves with an ``SsspShards`` opened into its array fields (its
    static sizes are no arguments), in field order."""
    from repro_torch.core.shards import SsspShards
    out = []
    for leaf in leaves:
        if isinstance(leaf, SsspShards):
            out += [v for f in dataclasses.fields(leaf)
                    if not isinstance(v := getattr(leaf, f.name),
                                      (int, str, type(None)))]
        else:
            out.append(leaf)
    return out


def arg_leaves(args) -> list:
    """The tensors of a cell's arguments: tree leaves, and the array fields
    of an ``SsspShards`` (its static sizes are no arguments)."""
    from repro_torch.models.params import tree_leaves
    return [t for t in _expand(tree_leaves(args))
            if isinstance(t, torch.Tensor)]


def sharding_leaves(in_shardings) -> list:
    """The ``NamedSharding`` of each of ``arg_leaves``' tensors, in its
    order."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.models.params import tree_leaves
    return [t for t in _expand(tree_leaves(in_shardings))
            if isinstance(t, NamedSharding)]


def argument_bytes(args) -> int:
    """Bytes of a cell's arguments: the sum over ``arg_leaves``."""
    return sum(t.numel() * t.element_size() for t in arg_leaves(args))


def _ns(mesh, spec_tree):
    """The tree of ``NamedSharding(mesh, spec)`` of a tree of specs."""
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.models.params import _map
    return _map(lambda s: NamedSharding(mesh, s), spec_tree)


def _blocks(struct, spec_tree, mesh):
    """``struct``'s ``meta`` leaves cut to this rank's blocks of
    ``spec_tree`` over ``mesh`` (``shard_ranges``' ceil blocks)."""
    from repro_torch.distributed.sharding import shard_ranges
    from repro_torch.models.params import tree_leaves, tree_unflatten
    specs_ = tree_leaves(spec_tree)
    leaves = tree_leaves(struct)
    if len(specs_) != len(leaves):
        raise ValueError(f"{len(leaves)} arguments, {len(specs_)} specs")
    return tree_unflatten(struct, [
        _meta(tuple(hi - lo for lo, hi in shard_ranges(t.shape, sp, mesh)),
              t.dtype) for t, sp in zip(leaves, specs_)])


def _placed(mesh, struct, spec_tree):
    """(arguments, in_shardings): the whole ``struct`` and None on one
    card (``mesh`` None), else this rank's blocks and their shardings."""
    if mesh is None:
        return struct, None
    return _blocks(struct, spec_tree, mesh), _ns(mesh, spec_tree)


def _opt_spec(p_spec):
    from repro_torch.distributed.sharding import P
    from repro_torch.optim import AdamWState
    return AdamWState(step=P(), m=p_spec, v=p_spec)


def _one_card_ax():
    from repro_torch.distributed.sharding import MeshAxes
    return MeshAxes(data=("data",))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LONG_500K_SKIP = ("pure full-attention arch: 512K-token dense attention is "
                  "quadratically infeasible; skipped per task rule (no "
                  "SSM/linear-attn variant assigned). See DESIGN.md §5.")


def _lm_cell(arch, cfg, shape_id, mesh, ax) -> Cell:
    from repro_torch.distributed.sharding import P
    from repro_torch.models import transformer as tf
    from repro_torch.models.params import abstract, specs
    from repro_torch.optim import AdamWConfig, adamw_init
    sh = LM_SHAPES[shape_id]
    if shape_id == "long_500k":
        return Cell(arch, shape_id, "decode", None, None, None, 0.0,
                    skip=LONG_500K_SKIP)
    defs = tf.param_defs(cfg, ax)
    p_struct = abstract(defs, cfg.dtype)
    p_spec = specs(defs)
    N_active = cfg.n_active_params()
    B, S = sh["batch"], sh["seq"]
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.hd

    if sh["kind"] == "train":
        step = tf.make_train_step(cfg, ax, AdamWConfig())
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        batch_spec = {"tokens": P(ax.data, None), "labels": P(ax.data, None)}
        args, shardings = _placed(
            mesh, (p_struct, adamw_init(p_struct), batch),
            (p_spec, _opt_spec(p_spec), batch_spec))
        return Cell(arch, shape_id, "train", step, args, shardings,
                    6.0 * N_active * B * S)

    if sh["kind"] == "prefill":
        step = tf.make_prefill_step(cfg, ax)
        args, shardings = _placed(
            mesh, (p_struct, {"tokens": _meta((B, S), torch.int32)}),
            (p_spec, {"tokens": P(ax.data, None)}))
        return Cell(arch, shape_id, "prefill", step, args, shardings,
                    2.0 * N_active * B * S)

    # decode: one new token against a KV cache of seq_len
    step = tf.make_serve_step(cfg, ax)
    caches = tuple(_meta((L, B, S, Hkv, Dh), cfg.torch_dtype)
                   for _ in range(2))
    cache_spec = tuple(P(None, ax.data, ax.model, None, None)
                       for _ in range(2))
    args, shardings = _placed(
        mesh, (p_struct, _meta((B, 1), torch.int32), caches,
               _meta((), torch.int32)),
        (p_spec, P(ax.data, None), cache_spec, P()))
    # useful flops: dense read of active params + attention over the cache
    flops = 2.0 * N_active * B + 4.0 * L * B * S * Hkv * Dh
    return Cell(arch, shape_id, "decode", step, args, shardings, flops)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_batch_struct(arch, cfg, sh, ax):
    """(the batch's ``meta`` struct, its specs): node and edge rows over
    ``ax.all``, MACE's per-graph energies whole."""
    from repro_torch.distributed.sharding import P
    N, E, Df = sh["n_nodes"], sh["n_edges"], sh["d_feat"]
    f32, i32 = torch.float32, torch.int32
    b = {"node_feat": (_meta((N, Df)), P(ax.all, None)),
         "edge_src": (_meta((E,), i32), P(ax.all)),
         "edge_dst": (_meta((E,), i32), P(ax.all))}
    if arch == "gat-cora":
        b["labels"] = (_meta((N,), i32), P(ax.all))
    elif arch == "egnn":
        b["coords"] = (_meta((N, 3)), P(ax.all, None))
        b["labels"] = (_meta((N,), f32), P(ax.all))
    elif arch == "mace":
        b["coords"] = (_meta((N, 3)), P(ax.all, None))
        b["graph_id"] = (_meta((N,), i32), P(ax.all))
        b["graph_energy"] = (_meta((sh.get("n_graphs", 1),)), P())
    elif arch == "graphcast":
        b["edge_feat"] = (_meta((E, cfg.d_edge_in)), P(ax.all, None))
        b["labels"] = (_meta((N, cfg.n_vars)), P(ax.all, None))
    return ({k: v[0] for k, v in b.items()}, {k: v[1] for k, v in b.items()})


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


def _gnn_cell(arch, cfg, shape_id, mesh, ax) -> Cell:
    from repro_torch.models import gnn
    from repro_torch.models.params import abstract, specs
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
    param_defs, _, loss = gnn.MODELS[arch]
    defs = param_defs(cfg, ax)
    if arch == "graphcast":
        # inputs follow the shape's d_feat; outputs stay n_vars=227
        defs["node_enc"] = gnn.mlp_defs(
            [sh["d_feat"], cfg.d_hidden, cfg.d_hidden], ln=True)
    p_struct = abstract(defs)
    p_spec = specs(defs)
    batch, batch_spec = _gnn_batch_struct(arch, cfg, sh, ax)
    step = gnn.make_gnn_train_step(loss, cfg, ax, AdamWConfig())
    args, shardings = _placed(mesh, (p_struct, adamw_init(p_struct), batch),
                              (p_spec, _opt_spec(p_spec), batch_spec))
    return Cell(arch, shape_id, "train", step, args, shardings,
                _gnn_flops(arch, cfg, sh), note=sh.get("note", ""))


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _rec_cell(arch, cfg, shape_id, mesh, ax) -> Cell:
    from repro_torch.distributed.sharding import P
    from repro_torch.models import autoint as ai
    from repro_torch.models.params import abstract, specs
    from repro_torch.optim import AdamWConfig, adamw_init
    sh = REC_SHAPES[shape_id]
    B = sh["batch"]
    defs = ai.autoint_param_defs(cfg, ax)
    p_struct = abstract(defs)
    p_spec = specs(defs)
    F, Lh = cfg.n_sparse, cfg.multi_hot
    idx = _meta((B, F, Lh), torch.int32)
    idx_spec = P(ax.data, None, None)

    D, A, H, nL = cfg.embed_dim, cfg.d_attn, cfg.n_heads, cfg.n_attn_layers
    attn_flops = nL * (3 * B * F * (H * A) * (H * A) + 2 * B * H * F * F * A)
    embed_flops = B * F * Lh * D
    base = attn_flops + embed_flops + B * F * H * A * 64

    if sh["kind"] == "train":
        step = ai.make_autoint_train_step(cfg, ax, AdamWConfig())
        batch = {"sparse_idx": idx, "labels": _meta((B,), torch.int32)}
        batch_spec = {"sparse_idx": idx_spec, "labels": P(ax.data)}
        args, shardings = _placed(
            mesh, (p_struct, adamw_init(p_struct), batch),
            (p_spec, _opt_spec(p_spec), batch_spec))
        return Cell(arch, shape_id, "train", step, args, shardings,
                    3.0 * base)

    if sh["kind"] == "serve":
        step = ai.make_autoint_serve_step(cfg, ax)
        args, shardings = _placed(mesh, (p_struct, {"sparse_idx": idx}),
                                  (p_spec, {"sparse_idx": idx_spec}))
        return Cell(arch, shape_id, "serve", step, args, shardings, base)

    Nc = sh["n_candidates"]
    step = ai.make_retrieval_step(cfg, ax)
    batch = {"sparse_idx": idx, "cand_vecs": _meta((Nc, cfg.d_retrieval))}
    # B=1 query replicated; candidates sharded over the model axis
    batch_spec = {"sparse_idx": P(None, None, None),
                  "cand_vecs": P(ax.model, None)}
    args, shardings = _placed(mesh, (p_struct, batch), (p_spec, batch_spec))
    return Cell(arch, shape_id, "retrieval", step, args, shardings,
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


def _sssp_cell(shape_id, n_parts: int, mesh, ax, sssp_cfg=None) -> Cell:
    """On one card the ``sim`` solve of ``n_parts`` stacked shards; under
    a mesh the ``shmap`` solve, one shard a process (``n_parts`` the
    mesh's size): this rank's one-shard view (every field's block of
    ``P(ax.all)``, ``shard_id`` its place over ``ax.all``)."""
    from repro_torch.configs.sssp_paper import GRAPHS
    from repro_torch.core.sssp import SsspConfig, solve_shmap, solve_sim
    from repro_torch.distributed.sharding import (NamedSharding, P,
                                                  _position, entry_axes)
    gspec = GRAPHS[shape_id]
    cfg = sssp_cfg or SsspConfig(max_rounds=64)
    # one full relaxation of every edge + the exchange, per round; report
    # per-round useful work (min-plus relax = 1 add + 1 min per edge)
    flops = 2.0 * gspec.n_edges
    note = (f"cut={gspec.cut_fraction}, rounds capped at "
            f"{cfg.max_rounds} for the dry-run lowering")
    if mesh is None:
        shards = _sssp_abstract_shards(gspec, n_parts)
        return Cell("sp-async", shape_id, "sssp",
                    lambda sh: solve_sim(sh, 0, cfg), (shards,), None,
                    flops, note=note)
    whole = _sssp_abstract_shards(gspec, mesh.size)
    spec = P(ax.all)
    rank = _position(mesh, entry_axes(tuple(ax.all), mesh))[0]
    fields = whole.arrays()
    view = dataclasses.replace(
        whole, **_blocks(fields, {k: spec for k in fields}, mesh),
        shard_id=rank)
    shardings = dataclasses.replace(
        whole, **{k: NamedSharding(mesh, spec) for k in fields})
    return Cell("sp-async", shape_id, "sssp",
                lambda sh: solve_shmap(sh, 0, cfg, mesh, ax.all), (view,),
                (shardings,), flops, note=note)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_id: str, mesh, ax, smoke: bool = False,
               **kw) -> Cell:
    """The cell of ``arch`` at ``shape_id`` on ``mesh`` (a ``HostMesh``)
    with the steps sharded over ``ax`` (``MeshAxes``), in the reference's
    argument order: this rank's blocks of the arguments and their
    ``in_shardings``, the reference's specs. ``mesh=None, ax=None`` is
    the one-card cell (whole arguments, ``in_shardings`` None; an LM,
    GNN or AutoInt step with the one-process ``MeshAxes``). An SSSP cell
    (``arch`` "sp-async" or "sssp") solves with ``kw["sssp_cfg"]``
    (default ``SsspConfig(max_rounds=64)``) over ``mesh.size`` shards,
    one a process, or on one card over ``kw["n_parts"]`` stacked shards
    (default 256, the reference's 16 x 16 production mesh)."""
    from repro_torch.launch.mesh import use_mesh
    if (mesh is None) != (ax is None):
        raise ValueError("build_cell: pass a mesh and its MeshAxes, or "
                         "mesh=None and ax=None for the one-card cell")
    with use_mesh(None):            # whole shapes, cut to blocks here
        if arch in ("sp-async", "sssp"):
            return _sssp_cell(shape_id, kw.get("n_parts", 256), mesh, ax,
                              kw.get("sssp_cfg"))
        family, cfg = _load(arch, smoke)
        ax_ = ax if ax is not None else _one_card_ax()
        if family == "lm":
            return _lm_cell(arch, cfg, shape_id, mesh, ax_)
        if family == "gnn":
            return _gnn_cell(arch, cfg, shape_id, mesh, ax_)
        return _rec_cell(arch, cfg, shape_id, mesh, ax_)


def list_cells(include_sssp: bool = True):
    out = []
    for arch, (family, _) in ARCHS.items():
        for shape_id in SHAPES[family]:
            out.append((arch, shape_id))
    if include_sssp:
        for g in SSSP_SHAPES:
            out.append(("sp-async", g))
    return out
