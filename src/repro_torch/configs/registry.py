"""The architectures the port runs and the reference's cell shapes
(``configs/registry.py``): every family (LM, GNN, recsys) loads through
``_load``, and the shape tables equal the reference's.

The reference's dry-run cells (``Cell``, ``build_cell``, ``list_cells``,
its abstract batch structs and FLOP counts) lower sharded steps for a
mesh; they are not ported yet (ROADMAP Queue 1 item 10.6), and reaching
for them raises."""
from __future__ import annotations

import importlib

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


def _dry_run_only(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"configs.registry.{name}: the dry-run cells (lowered, sharded "
            f"steps with abstract inputs) are not ported yet (ROADMAP Queue 1 "
            f"item 10.6)")
    refuse.__name__ = name
    return refuse


build_cell = _dry_run_only("build_cell")
list_cells = _dry_run_only("list_cells")
