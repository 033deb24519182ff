"""The PyTorch port's training entry point: ``python -m
repro_torch.launch.train`` on the CPU with checkpoints and a resume (an
LM, AutoInt and MACE), a short run of every registered architecture, its
LM train step against the reference launcher's on the same parameters and
batches, the GNN and recsys builders' batches against the reference
launcher's, the registry's configs and shape tables against the
reference's, its refusal of the unported dry-run cells, and the
``train_lm`` and ``gnn_products`` examples.

The launcher makes its weights with a seeded ``torch.Generator``, not the
reference's threefry keys, so the step is held against the reference's
through ``params_from_numpy`` of the reference launcher's own parameters
and the same ``TokenStream`` batches: loss and gradient norm within 1e-5
relative, the parameters within 1e-5 of the tree's largest value
(tests/test_torch_train.py says why).
"""
import dataclasses
import re

import numpy as np
import pytest

import jax

from repro import compat
from repro.configs import registry as jax_registry
from repro.configs import sssp_paper as jax_sssp_paper
from repro.distributed.sharding import MeshAxes
from repro.launch import train as jtrain
from repro.models.params import abstract as jax_abstract
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.configs import sssp_paper as torch_sssp_paper  # noqa: E402
from repro_torch.examples import gnn_products, train_lm  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy, tree_leaves)
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402

ARGS = ["--arch", "olmoe-1b-7b", "--smoke", "--log-every", "1",
        "--device", "cpu"]
LINE = re.compile(r"step (\d+): loss=(\d+\.\d{4}) \(\d+ ms/step\)")


def test_launcher_resumes_from_its_last_complete_step(tmp_path, capsys):
    ckpt = str(tmp_path / "ck")
    first = ttrain.main(ARGS + ["--steps", "6", "--ckpt-dir", ckpt,
                                "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert [LINE.fullmatch(x).group(1) for x in out[:-1]] == [
        str(s) for s in range(1, 7)]
    assert out[-1] == f"final loss: {first[-1]:.4f} (first: {first[0]:.4f})"
    assert latest_step(ckpt) == 6
    saved = restore_checkpoint(ckpt, 6, _target(), device="cpu")
    resumed = ttrain.main(ARGS + ["--steps", "10", "--ckpt-dir", ckpt,
                                  "--ckpt-every", "100"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 6"
    assert [LINE.fullmatch(x).group(1) for x in out[1:-1]] == [
        "7", "8", "9", "10"]
    # the resumed run takes the batches an uninterrupted run takes
    whole = ttrain.main(ARGS + ["--steps", "10"])
    assert len(resumed) == 4
    np.testing.assert_allclose(resumed, whole[6:], rtol=1e-6)
    np.testing.assert_allclose(first, whole[:6], rtol=1e-6)
    assert whole[-1] < whole[0]
    # what the resume reads is what the first run saved at step 6, bit for
    # bit (the smoke config is float32)
    assert int(saved[1].step) == 6
    for i, leaf in enumerate(tree_leaves(saved)):
        want = np.load(f"{ckpt}/step_00000006/leaf_{i:05d}.npy")
        assert leaf.numpy().tobytes() == want.tobytes()


def _target():
    cfg = torch_registry._load("olmoe-1b-7b", smoke=True)[1]
    params = ttrain.build_lm(cfg, 2, 4, AdamWConfig(), "cpu")[0]
    return params, adamw_init(params)


def test_launcher_step_matches_reference(mesh11):
    """Two steps of the launcher's LM build (``build_lm``: its train step
    and token stream) against the reference launcher's, the port's
    parameters carried over from the reference's ``materialize``."""
    cj = jax_registry._load("qwen3-moe-235b-a22b", smoke=True)[1]
    ct = torch_registry._load("qwen3-moe-235b-a22b", smoke=True)[1]
    ax = MeshAxes(data=("data",))
    pj, step_j, data_j = jtrain.build_lm(cj, ax, 4, 16, JAdamWConfig(lr=1e-3))
    _, step_t, data_t = ttrain.build_lm(ct, 4, 16, AdamWConfig(lr=1e-3),
                                        "cpu")
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    sj, st = jadamw_init(pj), adamw_init(pt)
    with compat.set_mesh(mesh11):
        step_j = jax.jit(step_j)
        for _ in range(2):
            bj, bt = next(data_j), next(data_t)
            assert np.array_equal(bt["tokens"].numpy(),
                                  np.asarray(bj["tokens"]))
            pj, sj, mj = step_j(pj, sj, bj)
            pt, st, mt = step_t(pt, st, bt)
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                           rtol=1e-5)
    lj = jax.tree_util.tree_leaves(pj)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in lj)
    for a, b in zip(tree_leaves(pt), lj, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("arch", ["gat-cora", "autoint"])
def test_launcher_refuses_unported_archs(arch):
    """Every architecture trains now; what the port still refuses is the
    reference's dry-run cells of an architecture (ROADMAP Queue 1 item
    10.6)."""
    assert arch in jax_registry.ARCHS and arch in torch_registry.ARCHS
    for fn, args in ((torch_registry.build_cell, (arch, "train_batch")),
                     (torch_registry.list_cells, ())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 10.6"):
            fn(*args)


@pytest.mark.parametrize("arch", list(jax_registry.ARCHS))
def test_launcher_runs_every_arch(arch, capsys):
    """``python -m repro_torch.launch.train --arch <a> --smoke --device
    cpu``, two steps, for each of the reference's 10 architectures."""
    losses = ttrain.main(["--arch", arch, "--smoke", "--steps", "2",
                          "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [LINE.fullmatch(x).group(1) for x in out[:-1]] == ["1", "2"]
    assert len(losses) == 2 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["autoint", "mace"])
def test_launcher_resumes_gnn_and_recsys(arch, tmp_path, capsys):
    """A recsys and a GNN run: 6 steps with a checkpoint every 2, then a
    resume to 10 whose losses equal an uninterrupted run's (the resumed
    run draws and drops the batches of the steps already taken)."""
    args = ["--arch", arch, "--smoke", "--log-every", "1", "--device",
            "cpu", "--batch", "16"]
    ckpt = str(tmp_path / "ck")
    first = ttrain.main(args + ["--steps", "6", "--ckpt-dir", ckpt,
                                "--ckpt-every", "2"])
    assert latest_step(ckpt) == 6
    capsys.readouterr()
    resumed = ttrain.main(args + ["--steps", "10", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 6"
    whole = ttrain.main(args + ["--steps", "10"])
    assert len(resumed) == 4
    np.testing.assert_allclose(resumed, whole[6:], rtol=1e-6)
    np.testing.assert_allclose(first, whole[:6], rtol=1e-6)


@pytest.mark.parametrize("arch", torch_registry.GNN_ARCHS
                         + torch_registry.REC_ARCHS)
def test_builders_batches_equal_reference(arch, monkeypatch):
    """The first 3 batches of ``build_gnn`` / ``build_recsys`` equal the
    reference launcher's element for element, and the parameters have the
    reference's shapes. The reference builder's weights are taken as
    shapes (``params.abstract``): its draws of them come from keys apart
    from the batches' numpy generator."""
    monkeypatch.setattr(jtrain, "materialize",
                        lambda defs, key, *a: jax_abstract(defs))
    family, cj = jax_registry._load(arch, smoke=True)
    ct = torch_registry._load(arch, smoke=True)[1]
    ax = MeshAxes(data=("data",))
    if family == "gnn":
        pj, _, dj = jtrain.build_gnn(arch, cj, ax, JAdamWConfig())
        pt, _, dt = ttrain.build_gnn(arch, ct, AdamWConfig(), "cpu")
    else:
        pj, _, dj = jtrain.build_recsys(cj, ax, 8, JAdamWConfig())
        pt, _, dt = ttrain.build_recsys(ct, 8, AdamWConfig(), "cpu")
    assert [tuple(t.shape) for t in tree_leaves(pt)] == [
        a.shape for a in jax.tree_util.tree_leaves(pj)]
    for _ in range(3):
        bj, bt = next(dj), next(dt)
        assert sorted(bj) == sorted(bt)
        for key in bj:
            want = np.asarray(bj[key])
            got = bt[key].numpy()
            assert got.dtype == want.dtype, key
            assert np.array_equal(got, want), key


@pytest.mark.parametrize("arch", list(jax_registry.ARCHS))
def test_registry_configs_match_reference(arch):
    """``_load`` of every architecture, full and SMOKE: the family and the
    config field by field (the LM configs' fields are held in
    tests/test_torch_transformer.py)."""
    for smoke in (False, True):
        fam_j, cj = jax_registry._load(arch, smoke)
        fam_t, ct = torch_registry._load(arch, smoke)
        assert fam_t == fam_j
        assert ({f.name for f in dataclasses.fields(ct)}
                == {f.name for f in dataclasses.fields(cj)})
        if fam_j != "lm":
            assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        else:
            assert ct.name == cj.name and ct.n_layers == cj.n_layers
    if fam_j == "recsys":
        assert ct.total_vocab == cj.total_vocab
    if arch == "mace":
        assert ct.ls == cj.ls


def test_registry_tables_match_reference():
    assert torch_registry.ARCHS.keys() == jax_registry.ARCHS.keys()
    assert {k: v[0] for k, v in torch_registry.ARCHS.items()} == {
        k: v[0] for k, v in jax_registry.ARCHS.items()}
    for name in ("LM_ARCHS", "GNN_ARCHS", "REC_ARCHS", "LM_SHAPES",
                 "GNN_SHAPES", "REC_SHAPES", "SSSP_SHAPES", "SHAPES"):
        assert getattr(torch_registry, name) == getattr(jax_registry, name)
    for x in (1, 511, 512, 513, 2449029):
        assert torch_registry._pad512(x) == jax_registry._pad512(x)
    assert torch_sssp_paper.GRAPHS.keys() == jax_sssp_paper.GRAPHS.keys()
    for name, gj in jax_sssp_paper.GRAPHS.items():
        gt = torch_sssp_paper.GRAPHS[name]
        assert dataclasses.asdict(gt) == dataclasses.asdict(gj)
        for parts in (1, 8, 512):
            assert gt.shard_shapes(parts) == gj.shard_shapes(parts)


def test_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--arch", "olmoe-1b-7b", "--smoke", "--steps", "1"])


def test_train_lm_example_resumes(tmp_path, capsys, monkeypatch):
    """The example at a few layers and narrow widths (its 100M config is
    the same code at other sizes): 100 steps, a checkpoint, then a second
    run that resumes from it."""
    small = ttf.TransformerConfig(
        name="lm-small", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=64, dtype="float32", attn_chunk=8)
    monkeypatch.setattr(train_lm, "CONFIG", small)
    argv = ["--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    train_lm.main(argv + ["--steps", "100"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("params: ") and out[-1] == "done"
    assert len([x for x in out if x.startswith("step ")]) == 5
    assert latest_step(str(tmp_path)) == 100
    train_lm.main(argv + ["--steps", "120"])
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == ["resumed at step 100", out[2], "done"]
    assert out[2].startswith("step 120: loss=")


def test_gnn_products_example_runs(capsys):
    """The example on the CPU for a few steps (its R-MAT stand-in: no
    ogbn-products extract is on disk here)."""
    losses = gnn_products.main(["--steps", "5", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == [f"step 5: loss={losses[-1]:.4f}", "ok"]
    assert len(losses) == 5 and np.isfinite(losses).all()
