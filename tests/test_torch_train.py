"""The PyTorch port's training half of the dense transformer against the
JAX package: the loss, every parameter's gradient, the chunked
attention's flash backward, the dtype fence, AdamW and its schedules, and
whole train steps with and without microbatches.

Parameters are the JAX package's ``materialize`` at the deepseek ``SMOKE``
size in float32, carried to the port leaf for leaf; the same numpy tokens
and labels go through both. The JAX side runs under ``jax.jit`` inside
``compat.set_mesh`` (its sharding constraints need a mesh). Sequence 40
with ``attn_chunk`` 16 leaves an uneven last kv chunk.

Tolerances: the loss and each gradient within 1e-5 of the largest value of
the JAX array (measured below 1e-6); AdamW and the schedules on equal
inputs within 1e-6 relative; after three train steps the loss and
gradient norm within 1e-5 relative and every parameter within 1e-5 of the
largest parameter of the tree (measured 1.8e-6). The parameters are held
to the tree's largest value, not each leaf's: AdamW's first steps divide
each gradient by its own magnitude, so a gradient entry near ``eps`` turns
the frameworks' 1e-7 differences into up to 1.3e-5 of a small leaf's
largest value.
"""
import dataclasses

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

import repro.kernels.flash_attention as jax_fa_pkg
from repro import compat
from repro.configs import registry as jax_registry
from repro.distributed.sharding import MeshAxes
from repro.models import transformer as jtf
from repro.models.params import materialize as jax_materialize
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.distributed.sharding import MeshAxes as TMeshAxes  # noqa: E402,E501
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402

AX = MeshAxes(data=("data",), data_shards=1)
TAX = TMeshAxes(data=("data",), data_shards=1)
REL = 1e-5
B, S = 4, 40


def _configs(**over):
    cj = dataclasses.replace(jax_registry._load("deepseek-7b", True)[1],
                             **over)
    ct = dataclasses.replace(torch_registry._load("deepseek-7b", True)[1],
                             **over)
    return cj, ct


def _setup(impl, seed=0):
    cj, ct = _configs(attn_impl=impl)
    pj = jax_materialize(jtf.param_defs(cj, AX), jax.random.key(seed),
                         cj.dtype)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                           device="cpu")
    rng = np.random.default_rng(seed)
    tok, lab = (rng.integers(0, cj.vocab_size, (B, S)).astype(np.int32)
                for _ in range(2))
    bj = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    bt = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    return cj, ct, pj, pt, bj, bt


def _pairs(tree_j, tree_t):
    """(name, jax leaf, torch leaf) for every leaf."""
    for path, lj in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
        node = tree_t
        for key in path:
            node = node[key.key]
        yield "/".join(k.key for k in path), np.asarray(lj), node


def _close(got, want, rel, scale=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * (
        np.abs(want).max() if scale is None else scale))


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_loss_and_grads_match_reference(impl, mesh11):
    cj, ct, pj, pt, bj, bt = _setup(impl)
    with compat.set_mesh(mesh11):
        lj, gj = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.loss_fn(p, b, cj, AX)))(pj, bj)
    logits = np.random.default_rng(1).standard_normal(
        (B, S, cj.vocab_size)).astype(np.float32) * 4
    _close(ttf.softmax_xent(torch.from_numpy(logits), bt["labels"]),
           jtf.softmax_xent(jnp.asarray(logits), bj["labels"]), REL)
    _close(ttf.loss_fn(pt, bt, ct, TAX), lj, REL)
    lt, gt = ttf._value_and_grad(pt, bt, ct, TAX)
    _close(lt, lj, REL)
    n = 0
    for name, g_j, g_t in _pairs(gj, gt):
        assert g_t.dtype == torch.float32, name
        _close(g_t, g_j, REL)
        n += 1
    assert n == 12
    # the parameters are left as they were, with no gradient attached
    assert all(not t.requires_grad for _, _, t in _pairs(pj, pt))


@pytest.mark.parametrize("causal,q_offset,S_q,S_kv", [
    (True, 0, 37, 37), (False, 0, 21, 37), (True, 16, 21, 37)])
def test_attn_chunked_backward_matches_reference(causal, q_offset, S_q, S_kv):
    """The flash backward against the reference's custom VJP: GQA (4 query
    heads on 2 kv heads), an uneven last chunk, causal, non-causal and a
    query offset."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, S_q, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, S_kv, 2, 16)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((2, S_q, 4, 16)).astype(np.float32)
    scale, chunk = 0.25, 8
    out_j, vjp = jax.vjp(lambda q, k, v: jtf._attn_chunked(
        q, k, v, causal, q_offset, scale, chunk), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out_t = ttf._attn_chunked(qt, kt, vt, causal, q_offset, scale, chunk)
    _close(out_t, out_j, REL)
    # the saved tensors are the reference's residuals: (q, k, v, out, lse)
    assert [tuple(t.shape) for t in out_t.grad_fn.saved_tensors] == [
        (2, S_q, 4, 16), (2, S_kv, 2, 16), (2, S_kv, 2, 16),
        (2, 2, 2, S_q, 16), (2, 2, 2, S_q)]
    got = torch.autograd.grad(out_t, (qt, kt, vt), torch.from_numpy(do))
    for g, w in zip(got, want, strict=True):
        _close(g, w, REL)


def test_dtype_fence_casts_the_cotangent():
    """Identity forward; the cotangent leaves the fence in the fence's
    type (bfloat16 here, so a float32 input receives it rounded)."""
    x = torch.linspace(0, 1, 7, requires_grad=True)
    c = torch.full((7,), 1.2345678)
    y = ttf.dtype_fence(x, "bfloat16")
    assert torch.equal(y, x)
    (g,) = torch.autograd.grad((y * c).sum(), x)
    assert g.dtype == torch.float32
    assert torch.equal(g, c.to(torch.bfloat16).float())
    xb = x.detach().to(torch.bfloat16).requires_grad_(True)
    (gb,) = torch.autograd.grad(
        (ttf.dtype_fence(xb, torch.float32).float() * c).sum(), xb)
    assert gb.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_and_schedules_match_reference(dtype):
    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": {"c": (4,), "d": (2, 6)}}

    def tree(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
    p, g1, g2 = tree(1.0), tree(0.5), tree(3.0)
    pj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p)
    pt = params_from_numpy(p, device="cpu", dtype=dtype)
    sj, st = jadamw.adamw_init(pj), tadamw.adamw_init(pt)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, weight_decay=0.05)
    cfg_t = tadamw.AdamWConfig(lr=1e-2, weight_decay=0.05)
    for i, g in enumerate((g1, g2, g1)):       # g2 is clipped
        gj = jax.tree_util.tree_map(jnp.asarray, g)
        gt = params_from_numpy(g, device="cpu")
        pj, sj, nj = jadamw.adamw_update(pj, gj, sj, cfg_j,
                                         lr_scale=0.5 + i)
        pt, st, nt = tadamw.adamw_update(pt, gt, st, cfg_t,
                                         lr_scale=0.5 + i)
        _close(nt, nj, 1e-6)
        assert int(st.step) == int(sj.step) == i + 1
        for tree_j, tree_t in ((pj, pt), (sj.m, st.m), (sj.v, st.v)):
            for _, a, b in _pairs(tree_j, tree_t):
                assert b.dtype == (getattr(torch, dtype) if tree_t is pt
                                   else torch.float32)
                _close(b, a, 1e-6 if dtype == "float32" else 1e-2)
    _close(tadamw.global_norm(pt), jadamw.global_norm(pj), 1e-6)
    clipped_t, _ = tadamw.clip_by_global_norm(
        params_from_numpy(g2, device="cpu"), 1.0)
    clipped_j, _ = jadamw.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g2), 1.0)
    for _, a, b in _pairs(clipped_j, clipped_t):
        _close(b, a, 1e-6)
    for step in (0, 1, 7, 50, 99, 100, 140):
        for args in ((100,), (100, 0.3), (1,)):
            _close(tsched.cosine_schedule(step, *args),
                   jsched.cosine_schedule(jnp.int32(step), *args), 1e-6, 1.0)
        for args in ((10, 100), (0, 100, 0.2), (10, 5)):
            _close(tsched.linear_warmup_cosine(torch.tensor(step), *args),
                   jsched.linear_warmup_cosine(jnp.int32(step), *args),
                   1e-6, 1.0)


@pytest.mark.parametrize("impl,microbatches", [("xla", 2), ("chunked", 1)])
def test_train_steps_match_reference(impl, microbatches, mesh11):
    cj, ct, pj, pt, bj, bt = _setup(impl)
    with compat.set_mesh(mesh11):
        step_j = jax.jit(jtf.make_train_step(
            cj, AX, jadamw.AdamWConfig(), microbatches=microbatches))
        state_j = jadamw.adamw_init(pj)
        metrics_j = []
        for _ in range(3):
            pj, state_j, m = step_j(pj, state_j, bj)
            metrics_j.append(m)
    step_t = ttf.make_train_step(ct, TAX, tadamw.AdamWConfig(),
                                 microbatches=microbatches)
    state_t = tadamw.adamw_init(pt)
    p0 = pt
    for mj in metrics_j:
        pt, state_t, mt = step_t(pt, state_t, bt)
        for key in ("loss", "grad_norm"):
            _close(mt[key], mj[key], REL)
    assert float(metrics_j[-1]["loss"]) < float(metrics_j[0]["loss"])
    scale = max(np.abs(np.asarray(a)).max()
                for a in jax.tree_util.tree_leaves(pj))
    for _, a, b in _pairs(pj, pt):
        _close(b, a, REL, scale)
    assert int(state_t.step) == 3
    # the step left the parameters it was given as they were
    for _, a, b in _pairs(jax.tree_util.tree_map(np.asarray, _setup(impl)[2]),
                          p0):
        assert np.array_equal(b.numpy(), a)


def test_pallas_attention_refuses_a_gradient(monkeypatch):
    """Kernel 12 has no backward in either package: the reference fails
    when asked to differentiate ``flash_attention_p`` (here on the CPU in
    interpret mode), and the port raises before computing anything, on
    either device; serving through it is unchanged."""
    q = jnp.ones((1, 2, 16, 8), jnp.float32)
    with pytest.raises(Exception):
        jax.grad(lambda q: jax_fa_pkg.flash_attention(
            q, q, q, causal=True, interpret=True).sum())(q)
    _, ct = _configs(attn_impl="pallas")
    _, _, _, pt, _, bt = _setup("xla")
    with pytest.raises(NotImplementedError, match="no backward"):
        ttf.loss_fn(dict(pt, embed=pt["embed"].detach().requires_grad_()),
                    bt, ct, TAX)
    step = ttf.make_train_step(ct, TAX, tadamw.AdamWConfig())
    with pytest.raises(NotImplementedError, match="no backward"):
        step(pt, tadamw.adamw_init(pt), bt)
    with torch.no_grad():
        got = ttf.forward(pt, bt["tokens"], ct, TAX)[0]
    want = ttf.forward(pt, bt["tokens"], _configs(attn_impl="xla")[1],
                       TAX)[0]
    _close(got, want, REL)
