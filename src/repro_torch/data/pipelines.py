"""Synthetic data pipelines (deterministic, host-side): the reference's
``data/pipelines.py``.

The draws are the reference's numpy draws, so a seed gives the reference's
tokens, indices and labels element for element; the batches are int32
tensors on ``device`` (``cuda`` unless the caller names one). Real
deployments swap the generators for file readers; the batching and the
device move are what the training loop depends on.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _int32(a, device):
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int, device=None):
    """Markov-ish token stream: next-token structure so loss can fall."""
    device = resolve_device(device)
    base = rng.integers(0, vocab, (batch, seq + 1))
    # inject copy structure: 50% of positions repeat t-1 (learnable signal)
    rep = rng.random((batch, seq)) < 0.5
    base[:, 1:][rep] = base[:, :-1][rep]
    return {"tokens": _int32(base[:, :-1], device),
            "labels": _int32(base[:, 1:], device)}


class TokenStream:
    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 device=None):
        self.rng = np.random.default_rng(seed)
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        return synthetic_lm_batch(self.rng, self.batch, self.seq, self.vocab,
                                  self.device)


class GraphBatcher:
    """Full-graph batches or sampler-driven minibatches for the GNN archs:
    ``batch_builder(i)`` for i = 1, 2, ... (``steps`` of them, or without
    end)."""

    def __init__(self, batch_builder, steps: int | None = None):
        self.batch_builder = batch_builder
        self.steps = steps
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.steps is not None and self._i >= self.steps:
            raise StopIteration
        self._i += 1
        return self.batch_builder(self._i)


class RecsysBatcher:
    def __init__(self, batch: int, n_fields: int, vocab_per_field: int,
                 multi_hot: int = 1, seed: int = 0, device=None):
        self.rng = np.random.default_rng(seed)
        self.batch, self.F, self.V, self.L = (batch, n_fields,
                                              vocab_per_field, multi_hot)
        self.device = resolve_device(device)

    def __next__(self):
        # skewed (zipf-ish) ids — embedding-access realism
        raw = self.rng.zipf(1.2, (self.batch, self.F, self.L)) % self.V
        field_off = (np.arange(self.F) * self.V)[None, :, None]
        idx = raw + field_off
        # synthetic label correlated with low ids (learnable)
        y = raw[:, :, 0].sum(1) % 2
        return {"sparse_idx": _int32(idx, self.device),
                "labels": _int32(y, self.device)}

    def __iter__(self):
        return self
