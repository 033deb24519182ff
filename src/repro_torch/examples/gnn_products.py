"""GNN example: minibatch GraphSAGE-style training of GAT with the neighbor
sampler (the reference's ``examples/gnn_products.py``, on the PyTorch
port: the minibatch_lg pattern at a small scale).

    PYTHONPATH=src python -m repro_torch.examples.gnn_products [--device cpu]

Runs on the GPU by default; ``--device cpu`` runs it on the CPU. Uses the
real ogbn-products graph when a local extract exists under
``data/ogbn_products/`` (see ``repro_torch.graph.ogbn_products_graph`` for
how to stage one; nothing is downloaded), otherwise a products-like R-MAT
stand-in (scale 12, edge factor 8). Each step samples 64 seed nodes with
fanouts (10, 5) on the host, moves the padded subgraph to the device and
takes one AdamW step of a 2-layer GAT on it, the loss on the seeds only.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import ogbn_products_graph, rmat_graph
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.models import gnn
from repro_torch.models.params import materialize
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: cuda)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    try:
        g = ogbn_products_graph()
        print(f"ogbn-products: {g.n_vertices} vertices, {g.n_edges} edges")
    except FileNotFoundError:
        # products-like graph at a small scale
        g = rmat_graph(scale=12, edge_factor=8, seed=0)
    n, d_feat, n_classes = g.n_vertices, 32, 16
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((n, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n).astype(np.int32)

    sampler = NeighborSampler(g, fanouts=(10, 5), seed=0)
    cfg = gnn.GatConfig(n_layers=2, d_hidden=16, n_heads=4, d_in=d_feat,
                        n_classes=n_classes)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = materialize(gnn.gat_param_defs(cfg), gen, device=device)
    opt = adamw_init(params)
    step = gnn.make_gnn_train_step(gnn.gat_loss, cfg, AdamWConfig(lr=3e-3))

    B = args.batch
    max_n = sampler.max_nodes(B)
    losses = []
    for s in range(args.steps):
        seeds = rng.choice(n, B, replace=False)
        nodes, src, dst, n_real = sampler.sample(seeds)
        sub_feat = np.zeros((max_n, d_feat), np.float32)
        sub_lab = np.full(max_n, -1, np.int32)       # -1 = unlabeled pad
        sub_feat[:n_real] = feats[nodes[:n_real]]
        sub_lab[:B] = labels[seeds]                  # loss on seeds only
        batch = {k: torch.as_tensor(v, device=device) for k, v in dict(
            node_feat=sub_feat, edge_src=src.astype(np.int32),
            edge_dst=dst.astype(np.int32), labels=sub_lab).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if (s + 1) % 5 == 0:
            print(f"step {s+1}: loss={losses[-1]:.4f}")
    print("ok")
    return losses


if __name__ == "__main__":
    main()
