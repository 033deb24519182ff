"""The LM architectures the port runs, and the reference's LM cell shapes
(``configs/registry.py``). The GNN and recsys architectures are named, as
in the reference, but not ported: loading one raises (ROADMAP Queue 1
item 10), and so do the reference's cells and SSSP shapes, which are not
here."""
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
}

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def _load(arch: str, smoke: bool = False):
    if arch in GNN_ARCHS or arch in REC_ARCHS:
        raise NotImplementedError(
            f"{arch}: the GNN and recsys models and their configs are not "
            f"ported yet (ROADMAP Queue 1 item 10)")
    family, mod = ARCHS[arch]
    m = importlib.import_module(mod)
    return family, (m.SMOKE if smoke else m.CONFIG)
