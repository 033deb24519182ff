"""End-to-end training driver with checkpoint/restart fault tolerance (the
reference's ``launch/train.py``), for every registered architecture: the
LMs, the GNN zoo and AutoInt.

Runs reduced ("smoke") or full configs of a registered arch on the
ambient mesh (``launch.mesh.use_mesh``; one process by default, as the
reference's host mesh), on the card unless ``--device`` names another:

  - data pipeline -> device batches (``data.TokenStream`` for an LM,
    ``data.RecsysBatcher`` for AutoInt, ``data.GraphBatcher`` over one
    random graph for a GNN)
  - the family's train step (AdamW)
  - periodic checkpoints (atomic commit, keep-K)
  - crash-safe resume: on start, restores the latest complete step and
    continues from it

The reference restarts its data at the seed on a resume, so a resumed run
trains on the batches the run began with; the port draws and drops the
batches of the steps already taken, whatever the family, so a resumed run
sees the batches an uninterrupted run would. The batches are the
reference's numpy draws, element for element, and the weights are the
reference's: ``materialize`` of the threefry key ``prng.key(0)``, as the
reference launcher's ``jax.random.key(0)``, within a few ulp.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --smoke --steps 200 --ckpt-dir ckpt --ckpt-every 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import _load
from repro_torch.core import prng
from repro_torch.data import GraphBatcher, RecsysBatcher, TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (MeshAxes, P, ambient_mesh,
                                              local_shard)
from repro_torch.launch.mesh import make_host_mesh, use_mesh
from repro_torch.models.params import materialize
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init


def _weights(defs, device, dtype=torch.float32):
    """``materialize(defs)`` on ``device`` from ``prng.key(0)``, the
    reference launcher's ``jax.random.key(0)``."""
    return materialize(defs, prng.key(0), device=device, default_dtype=dtype)


def build_lm(cfg, ax, batch, seq, opt_cfg, device=None):
    from repro_torch.models import transformer as tf
    params = _weights(tf.param_defs(cfg, ax), device, cfg.dtype)
    step = tf.make_train_step(cfg, ax, opt_cfg)
    data = TokenStream(batch, seq, cfg.vocab_size, device=device)
    return params, step, data


def _mine(batch, specs):
    """This process's block of each array of ``batch`` by its spec on the
    ambient mesh (the whole batch with no mesh)."""
    mesh = ambient_mesh()
    if mesh is None:
        return batch
    return {k: local_shard(v, specs.get(k, P()), mesh).contiguous()
            for k, v in batch.items()}


def build_recsys(cfg, ax, batch, opt_cfg, device=None):
    """Parameters (this process's shards under a mesh), train step and
    batches of AutoInt; each batch is the reference's numpy draw, this
    process's rows of it over ``ax.data``."""
    from repro_torch.models import autoint as ai
    params = _weights(ai.autoint_param_defs(cfg, ax), device)
    step = ai.make_autoint_train_step(cfg, ax, opt_cfg)
    draws = RecsysBatcher(batch, cfg.n_sparse, cfg.vocab_per_field,
                          cfg.multi_hot, device=device)
    rows = {"sparse_idx": P(ax.data), "labels": P(ax.data)}
    return params, step, (_mine(b, rows) for b in draws)


def build_gnn(arch, cfg, ax, opt_cfg, device=None):
    """Parameters, train step and batches of a GNN arch on one random graph
    of 256 nodes and 1,024 edges; the graph and every batch are the
    reference launcher's numpy draws, in its order, and under a mesh this
    process's blocks of their node and edge rows over ``ax.all``."""
    from repro_torch.models import gnn
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    N, E = 256, 1024
    src = rng.integers(0, N, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    param_defs, _, loss = gnn.MODELS[arch]
    params = _weights(param_defs(cfg, ax), device)
    step = gnn.make_gnn_train_step(loss, cfg, ax, opt_cfg)
    rows = {k: P(ax.all) for k in ("node_feat", "coords", "labels",
                                   "graph_id", "edge_src", "edge_dst",
                                   "edge_feat")}

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    def batch_builder(i):
        f32, i32 = np.float32, np.int32
        b = dict(edge_src=t(src, i32), edge_dst=t(dst, i32))
        if arch == "gat-cora":
            b["node_feat"] = t(rng.standard_normal((N, cfg.d_in)), f32)
            b["labels"] = t(rng.integers(0, cfg.n_classes, N), i32)
        elif arch == "egnn":
            b["node_feat"] = t(rng.standard_normal((N, cfg.d_in)), f32)
            b["coords"] = t(rng.standard_normal((N, 3)), f32)
            b["labels"] = t(rng.standard_normal(N), f32)
        elif arch == "mace":
            b["node_feat"] = t(rng.integers(0, 10, (N, 1)), f32)
            b["coords"] = t(rng.standard_normal((N, 3)) * 2, f32)
            b["graph_id"] = t(np.repeat(np.arange(8), N // 8), i32)
            b["graph_energy"] = t(rng.standard_normal(8), f32)
        else:
            b["node_feat"] = t(rng.standard_normal((N, cfg.n_vars)), f32)
            b["edge_feat"] = t(rng.standard_normal((E, cfg.d_edge_in)), f32)
            b["labels"] = t(rng.standard_normal((N, cfg.n_vars)), f32)
        return _mine(b, rows)

    return params, step, GraphBatcher(batch_builder)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="deepseek-7b")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: cuda)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    mesh = make_host_mesh(backend="gloo")    # (1, 1), as the reference's
    ax = MeshAxes(data=("data",))
    with use_mesh(mesh):
        family, cfg = _load(args.arch, smoke=args.smoke)
        opt_cfg = AdamWConfig(lr=args.lr)
        if family == "lm":
            params, step_fn, data = build_lm(cfg, ax, args.batch, args.seq,
                                             opt_cfg, device)
        elif family == "recsys":
            params, step_fn, data = build_recsys(cfg, ax, args.batch,
                                                 opt_cfg, device)
        else:
            params, step_fn, data = build_gnn(args.arch, cfg, ax, opt_cfg,
                                              device)

        opt_state = adamw_init(params)
        start = 0
        mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        if mgr is not None and mgr.latest() is not None:
            (params, opt_state), start = mgr.restore((params, opt_state))
            print(f"resumed from step {start}")

        it = iter(data)
        for _ in range(start):      # the batches of the steps already taken
            next(it)
        losses = []
        t0 = time.time()
        for s in range(start, args.steps):
            batch = next(it)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (s + 1) % args.log_every == 0:
                dt = (time.time() - t0) / args.log_every
                print(f"step {s+1}: loss={losses[-1]:.4f} "
                      f"({dt*1e3:.0f} ms/step)")
                t0 = time.time()
            if mgr is not None and (s + 1) % args.ckpt_every == 0:
                mgr.save(s + 1, (params, opt_state))
        print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f})")
        return losses


if __name__ == "__main__":
    main()
