"""The dense LM architectures the port serves, and the reference's LM cell
shapes (``configs/registry.py``). The MoE LMs, GNNs, recsys and SSSP
cells are not ported (ROADMAP Queue 1 item 10)."""
from __future__ import annotations

import importlib

ARCHS = {
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
    family, mod = ARCHS[arch]
    m = importlib.import_module(mod)
    return family, (m.SMOKE if smoke else m.CONFIG)
