"""Serving example: batched prefill + autoregressive greedy decode with a KV
cache (the reference's ``examples/serve_decode.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode

Runs on the GPU; ``main("cpu")`` runs it on the CPU. As the reference's,
it runs on a (1, 1) host mesh; ``generate`` under a larger one
(``launch.mesh.use_mesh``) decodes each rank's rows of the batch with the
model sharded over the mesh (``models/transformer.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import _load
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshAxes
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.params import materialize


def generate(params, prompts, cfg: tf.TransformerConfig, ax: MeshAxes,
             gen_len: int):
    """Greedy decode of ``gen_len`` tokens after ``prompts`` [B, P] int:
    the prefill, the caches padded by ``gen_len`` on the sequence axis
    (``grow_caches``: under a mesh, re-blocked over ``model``), then
    ``gen_len - 1`` serve steps, which are given the caches to write in
    place (the reference example donates them). Returns [B, gen_len]
    int32. Under a mesh, ``prompts`` and the result are this rank's rows
    and ``params`` its shards."""
    prefill = tf.make_prefill_step(cfg, ax)
    serve = tf.make_serve_step(cfg, ax, donate=True)
    prompt_len = prompts.shape[1]
    logits, kvs = prefill(params, {"tokens": prompts})
    caches = tf.grow_caches(kvs, gen_len, ax)
    del kvs
    tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
    outs = [tok]
    for i in range(gen_len - 1):
        logits, caches = serve(params, tok, caches, prompt_len + i)
        tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, dim=1)


def main(device=None):
    dev = resolve_device(device)
    _, cfg = _load("gemma-7b", smoke=True)    # reduced gemma-family config
    ax = MeshAxes(data=("data",), data_shards=1)
    mesh = make_host_mesh(backend="gloo")     # (1, 1): one process
    with use_mesh(mesh):
        params = materialize(tf.param_defs(cfg, ax), prng.key(0),
                             device=dev, default_dtype=cfg.dtype)

        B, prompt_len, gen_len = 4, 24, 16
        rng = np.random.default_rng(0)
        prompts = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (B, prompt_len)),
            dtype=torch.int32, device=dev)
        out = generate(params, prompts, cfg, ax, gen_len).cpu().numpy()
    print("generated token ids (greedy):")
    print(out)
    assert out.shape == (B, gen_len)
    print("ok")


if __name__ == "__main__":
    main()
