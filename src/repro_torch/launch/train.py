"""End-to-end training driver with checkpoint/restart fault tolerance (the
reference's ``launch/train.py``), for the LM architectures.

Runs reduced ("smoke") or full configs of a registered LM on one device,
the card unless ``--device`` names another:

  - data pipeline -> device batches (``data.TokenStream``)
  - the train step (``models.transformer.make_train_step``, AdamW)
  - periodic checkpoints (atomic commit, keep-K)
  - crash-safe resume: on start, restores the latest complete step and
    continues from it

The reference restarts its token stream at the seed on a resume, so a
resumed run trains on the batches the run began with; the port draws and
drops the batches of the steps already taken, so a resumed run sees the
batches an uninterrupted run would. The weights come from ``materialize``
with a seeded ``torch.Generator``, not the reference's threefry keys. The
GNN and recsys architectures are not ported (ROADMAP Queue 1 item 10).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \
      --smoke --steps 200 --ckpt-dir ckpt --ckpt-every 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import _load
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models.params import materialize
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init


def build_lm(cfg, batch, seq, opt_cfg, device):
    from repro_torch.models import transformer as tf
    defs = tf.param_defs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = materialize(defs, gen, device=device, default_dtype=cfg.dtype)
    step = tf.make_train_step(cfg, opt_cfg)
    data = TokenStream(batch, seq, cfg.vocab_size, device=device)
    return params, step, data


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
    _, cfg = _load(args.arch, smoke=args.smoke)
    opt_cfg = AdamWConfig(lr=args.lr)
    params, step_fn, data = build_lm(cfg, args.batch, args.seq, opt_cfg,
                                     device)

    opt_state = adamw_init(params)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr is not None and mgr.latest() is not None:
        (params, opt_state), start = mgr.restore((params, opt_state))
        print(f"resumed from step {start}")

    it = iter(data)
    for _ in range(start):          # the batches of the steps already taken
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
