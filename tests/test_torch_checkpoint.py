"""The PyTorch port's checkpoints against the JAX package's: the on-disk
layout (``step_%08d`` committed by rename, ``meta.json``, one
``leaf_%05d.npy`` a leaf), the leaf order of ``(params, AdamWState)``
equal to ``jax.tree_util.tree_flatten``'s, bfloat16 leaves as raw 2-byte
words, checkpoints written by one package and restored by the other,
``abstract``'s meta tensors as a target, keep-K pruning and an orphan
``.tmp`` never seen as the latest step."""
import json
import os

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from repro import checkpoint as jck
from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.models import transformer as jtf
from repro.models.params import abstract as jax_abstract
from repro.models.params import materialize as jax_materialize
from repro.optim import adamw as jadamw

torch = pytest.importorskip("torch")

from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.distributed.sharding import MeshAxes as TMeshAxes  # noqa: E402,E501
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    abstract, params_from_numpy, tree_leaves, tree_unflatten)
from repro_torch.optim import adamw as tadamw  # noqa: E402

AX = MeshAxes(data=("data",), data_shards=1)
TAX = TMeshAxes(data=("data",), data_shards=1)


def _trees(dtype, seed=0):
    """(params, AdamWState) of the qwen3-moe SMOKE model in ``dtype`` in
    both packages, the optimizer state after one step so every leaf
    differs from its initial value."""
    cj = jax_registry._load("qwen3-moe-235b-a22b", True)[1]
    pj = jax_materialize(jtf.param_defs(cj, AX), jax.random.key(seed), dtype)
    sj = jadamw.adamw_init(pj)
    gj = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.5, p.dtype), pj)
    pj, sj, _ = jax.jit(jadamw.adamw_update, static_argnums=3)(
        pj, gj, sj, jadamw.AdamWConfig())
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pt = params_from_numpy(to_np(pj), device="cpu")
    st = tadamw.AdamWState(step=torch.tensor(int(sj.step), dtype=torch.int32),
                           m=params_from_numpy(to_np(sj.m), device="cpu"),
                           v=params_from_numpy(to_np(sj.v), device="cpu"))
    return (pj, sj), (pt, st)


def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else (
        t.numpy())


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_bits(tree_t, tree_j):
    lt, lj = tree_leaves(tree_t), jax.tree_util.tree_leaves(tree_j)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert np.array_equal(_bits(a), _jbits(b))


def test_leaf_order_and_meta_match_reference(tmp_path):
    (tj, sj), (tt, st) = _trees("bfloat16")
    _same_bits((tt, st), (tj, sj))
    assert tree_unflatten((tt, st), tree_leaves((tt, st)))[1].step is st.step
    jck.save_checkpoint(str(tmp_path / "j"), 7, (tj, sj))
    tck.save_checkpoint(str(tmp_path / "t"), 7, (tt, st))
    for side in ("j", "t"):
        assert sorted(os.listdir(tmp_path / side)) == ["step_00000007"]
    d_j, d_t = tmp_path / "j" / "step_00000007", tmp_path / "t" / "step_00000007"
    assert sorted(os.listdir(d_j)) == sorted(os.listdir(d_t))
    meta_j = json.loads((d_j / "meta.json").read_text())
    meta_t = json.loads((d_t / "meta.json").read_text())
    assert meta_t == meta_j
    assert "bfloat16" in meta_t["dtypes"] and "int32" in meta_t["dtypes"]
    for name in os.listdir(d_j):
        if name.endswith(".npy"):     # the same words (bf16: '<V2' / '|V2')
            a, b = np.load(d_j / name), np.load(d_t / name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name
    # the treedef string for lists, empty tuples and None, as JAX writes it
    odd = ({"b": 1, "a": [2, (3,)]}, (), None)
    assert tck.checkpoint._treedef(odd) == str(
        jax.tree_util.tree_structure(odd))


def test_reference_bf16_checkpoint_restores_bit_for_bit(tmp_path):
    (tj, sj), (tt, st) = _trees("bfloat16", seed=1)
    jck.save_checkpoint(str(tmp_path), 3, (tj, sj))
    # a target of other values: the restore must take every bit from disk
    (_, _), (t0, s0) = _trees("bfloat16", seed=2)
    got, step = tck.CheckpointManager(str(tmp_path)).restore((t0, s0),
                                                             device="cpu")
    assert step == 3
    assert got[0]["layers"]["w_router"].dtype == torch.bfloat16
    assert isinstance(got[1], tadamw.AdamWState)
    _same_bits(got, (tj, sj))


def test_roundtrip_with_bf16_leaves_and_abstract_target(tmp_path):
    (_, _), (tt, st) = _trees("bfloat16", seed=3)
    tck.save_checkpoint(str(tmp_path), 5, (tt, st))
    got = tck.restore_checkpoint(str(tmp_path), 5, (tt, st))
    for a, b in zip(tree_leaves(got), tree_leaves((tt, st))):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))
    # abstract's meta tensors as the target: shapes and types only
    ct = torch_registry._load("qwen3-moe-235b-a22b", True)[1]
    target = abstract(ttf.param_defs(ct, TAX), "bfloat16")
    assert all(t.is_meta for t in tree_leaves(target))
    tck.save_checkpoint(str(tmp_path), 6, tt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _no_cuda(lambda: tck.restore_checkpoint(str(tmp_path), 6, target))
    got = tck.restore_checkpoint(str(tmp_path), 6, target, device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(tt)):
        assert a.device.type == "cpu" and np.array_equal(_bits(a), _bits(b))
    # a target of another type casts, as the reference's restore does
    f32 = tck.restore_checkpoint(str(tmp_path), 6,
                                 abstract(ttf.param_defs(ct, TAX)), device="cpu")
    assert f32["embed"].dtype == torch.float32
    assert torch.equal(f32["embed"], tt["embed"].float())


def _no_cuda(fn):
    real = torch.cuda.is_available
    torch.cuda.is_available = lambda: False
    try:
        fn()
    finally:
        torch.cuda.is_available = real


def test_abstract_matches_reference():
    for arch in ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "gemma-7b"):
        cj = jax_registry._load(arch)[1]
        ct = torch_registry._load(arch)[1]
        want = jax_abstract(jtf.param_defs(cj, AX), cj.dtype)
        got = abstract(ttf.param_defs(ct, TAX), ct.dtype)
        lw, lg = jax.tree_util.tree_leaves(want), tree_leaves(got)
        assert len(lw) == len(lg)
        for w, g in zip(lw, lg):
            assert tuple(g.shape) == w.shape and g.is_meta
            assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        assert sum(g.numel() for g in lg) == ct.n_params()


def test_port_f32_checkpoint_restores_in_reference(tmp_path):
    (tj, sj), (tt, st) = _trees("float32", seed=4)
    tck.save_checkpoint(str(tmp_path), 9, (tt, st))
    got = jck.restore_checkpoint(str(tmp_path), 9, (tj, sj))
    _same_bits((tt, st), got)
    structs = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), (tj, sj))
    got, s = jck.CheckpointManager(str(tmp_path)).restore(structs)
    assert s == 9
    _same_bits((tt, st), got)


def test_manager_keeps_newest_k_and_ignores_orphan_tmp(tmp_path):
    """tests/test_checkpoint.py's cases on the port, and the same
    directory listing as the reference's manager after the same saves."""
    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn((8, 16), generator=g),
                "nested": {"b": torch.arange(5, dtype=torch.float32)},
                "step": torch.tensor(seed, dtype=torch.int32)}
    mgr = tck.CheckpointManager(str(tmp_path / "t"), keep=2)
    ref = jck.CheckpointManager(str(tmp_path / "j"), keep=2)
    assert mgr.latest() is None and mgr.restore(tree(0)) == (None, None)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree(s))
        ref.save(s, jax.tree_util.tree_map(lambda t: np.asarray(t), tree(s)))
        assert sorted(os.listdir(tmp_path / "t")) == sorted(
            os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == ["step_00000003",
                                                  "step_00000004"]
    got, s = mgr.restore(tree(0))
    assert s == 4 and int(got["step"]) == 4
    assert torch.equal(got["w"], tree(4)["w"])
    got, s = mgr.restore(tree(0), step=3)
    assert s == 3 and torch.equal(got["w"], tree(3)["w"])
    # a crash mid-write leaves a .tmp directory: never the latest step,
    # and a save of that step later replaces it
    os.makedirs(tmp_path / "t" / "step_00000009.tmp")
    (tmp_path / "t" / "step_00000009.tmp" / "leaf_00000.npy").write_bytes(
        b"torn")
    assert mgr.latest() == 4 == jck.latest_step(str(tmp_path / "t"))
    assert tck.latest_step(str(tmp_path / "nowhere")) is None
    mgr.save(9, tree(9))
    assert mgr.latest() == 9
    assert sorted(os.listdir(tmp_path / "t")) == ["step_00000004",
                                                  "step_00000009"]
