"""End-to-end driver: train a ~100M-param dense LM for a few hundred steps
with checkpointing (the reference's ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300

The config is a scaled deepseek-7b family member (~100M params). It runs
on the GPU; ``--device cpu`` runs it on the CPU. Checkpoints go to
``--ckpt-dir`` (by default ``repro_lm_ckpt`` in the temporary directory);
a second run resumes from the newest one.
"""
import argparse
import os
import tempfile

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import prng
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import MeshAxes
from repro_torch.models import transformer as tf
from repro_torch.models.params import materialize, n_params as count_params
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_init

CONFIG = tf.TransformerConfig(
    name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=2048, vocab_size=32000, dtype="float32", attn_chunk=128)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_lm_ckpt"))
    p.add_argument("--device", default=None,
                   help="torch device of the run (default: cuda)")
    args = p.parse_args(argv)

    cfg = CONFIG
    device = resolve_device(args.device)
    ax = MeshAxes(data=("data",))
    defs = tf.param_defs(cfg, ax)
    print(f"params: {count_params(defs) / 1e6:.1f}M")
    params = materialize(defs, prng.key(0), device=device,
                         default_dtype=cfg.dtype)
    opt = adamw_init(params)
    step = tf.make_train_step(cfg, ax, AdamWConfig(lr=3e-4))
    data = iter(TokenStream(args.batch, args.seq, cfg.vocab_size,
                            device=device))
    mgr = CheckpointManager(args.ckpt_dir, keep=2)

    start = 0
    restored = mgr.restore((params, opt)) if mgr.latest() else (None, None)
    if restored[0] is not None:
        (params, opt), start = restored
        print(f"resumed at step {start}")
        for _ in range(start):      # the batches of the steps already taken
            next(data)

    for s in range(start, args.steps):
        params, opt, m = step(params, opt, next(data))
        if (s + 1) % 20 == 0:
            print(f"step {s+1}: loss={float(m['loss']):.4f}")
        if (s + 1) % 100 == 0:
            mgr.save(s + 1, (params, opt))
    print("done")


if __name__ == "__main__":
    main()
