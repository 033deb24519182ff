"""The two MoE LM configs of the PyTorch port (olmoe-1b-7b and
qwen3-moe-235b-a22b at their SMOKE sizes) against the JAX package end to
end: ``forward`` under every attention impl, bfloat16, prefill and
decode, ``loss_fn`` and its gradients, and train steps.

The JAX side runs under ``jax.jit`` inside ``compat.set_mesh`` on a 1 x 1
mesh, its ``attn_impl="pallas"`` branch in interpret mode (the
``jax_pallas_interpret`` fixture, as in tests/test_torch_transformer.py).
Parameters are the JAX package's ``materialize`` carried to the port leaf
for leaf; the same numpy tokens go through both.

Tolerances: float32 logits, caches and gradients within 1e-5 of the
largest JAX value, the aux loss within 1e-6 a layer; bfloat16 logits
within 3e-2 of the largest, as the dense tests hold them. MoE decode is
held against the reference's decode, never the port's forward: capacity
counts the tokens of a call, so a decode step (T = B) routes with another
capacity than the forward (tests/test_arch_smoke.py holds decode ==
forward for the dense configs only).
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

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.distributed.sharding import MeshAxes as TMeshAxes  # noqa: E402,E501
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

MOE_ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
F32_REL = 1e-5
BF16_REL = 3e-2
AUX_ATOL = 1e-6


AX = MeshAxes(data=("data",), data_shards=1)
TAX = TMeshAxes(data=("data",), data_shards=1)


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    orig = jax_fa_pkg.flash_attention

    def interpret(*args, interpret=None, **kw):
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(jax_fa_pkg, "flash_attention", interpret)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _jit(mesh, fn, *args):
    with compat.set_mesh(mesh):
        return jax.jit(fn)(*args)


# ------------------------------------------------------------ the model

def _configs(arch, smoke=True, **over):
    cj = dataclasses.replace(jax_registry._load(arch, smoke)[1], **over)
    ct = dataclasses.replace(torch_registry._load(arch, smoke)[1], **over)
    return cj, ct


def _params(cj, seed=0):
    pj = jax_materialize(jtf.param_defs(cj, AX), jax.random.key(seed),
                         cj.dtype)
    return pj, params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                 device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _pairs(tree_j, tree_t):
    for path, lj in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
        node = tree_t
        for key in path:
            node = node[key.key]
        yield "/".join(k.key for k in path), lj, node


@pytest.mark.parametrize("impl", ["xla", "chunked", "pallas"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches(mesh11, jax_pallas_interpret, arch, impl):
    cj, ct = _configs(arch, attn_impl=impl)
    pj, pt = _params(cj, seed=1)
    toks = _tokens(cj, (2, 40), seed=2)
    lj, kvj, auxj = _jit(mesh11, lambda p, t: jtf.forward(p, t, cj, AX),
                         pj, jnp.asarray(toks))
    lt, kvt, auxt = ttf.forward(pt, torch.from_numpy(toks), ct, TAX)
    _close(lt, lj, F32_REL)
    for a, b in zip(kvt, kvj):
        _close(a, b, F32_REL)
    assert float(auxt) > 0
    assert abs(float(auxt) - float(auxj)) <= AUX_ATOL * cj.n_layers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_bf16_matches(mesh11, jax_pallas_interpret, arch):
    cj, ct = _configs(arch, attn_impl="pallas", dtype="bfloat16")
    pj, pt = _params(cj, seed=3)
    toks = _tokens(cj, (2, 40), seed=3)
    lj, _, _ = _jit(mesh11, lambda p, t: jtf.forward(p, t, cj, AX), pj,
                    jnp.asarray(toks))
    lt, kvt, _ = ttf.forward(pt, torch.from_numpy(toks), ct, TAX)
    assert lt.dtype == torch.float32 and kvt[0].dtype == torch.bfloat16
    _close(lt, lj, BF16_REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_reference_decode(mesh11,
                                                   jax_pallas_interpret,
                                                   arch):
    """The prefill's last logits and caches, then three decode steps into
    caches padded by 3, each against the reference's own serve step."""
    cj, ct = _configs(arch, attn_impl="pallas")
    pj, pt = _params(cj, seed=4)
    toks = _tokens(cj, (4, 19), seed=4)
    lj, kvj = _jit(mesh11, jtf.make_prefill_step(cj, AX), pj,
                   {"tokens": jnp.asarray(toks[:, :16])})
    lt, kvt = ttf.make_prefill_step(ct, TAX)(
        pt, {"tokens": torch.from_numpy(toks[:, :16])})
    _close(lt, lj, F32_REL)
    cjs = tuple(jnp.pad(t, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
                for t in kvj)
    cts = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3)) for t in kvt)
    serve_j = jax.jit(jtf.make_serve_step(cj, AX))
    serve_t = ttf.make_serve_step(ct, TAX)
    for pos in (16, 17, 18):
        tok = toks[:, pos:pos + 1]
        with compat.set_mesh(mesh11):
            lj, cjs = serve_j(pj, jnp.asarray(tok), cjs, jnp.int32(pos))
        lt, cts = serve_t(pt, torch.from_numpy(tok), cts, pos)
        _close(lt, lj, F32_REL)
        for a, b in zip(cts, cjs):
            _close(a, b, F32_REL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_grads_and_train_step_match(mesh11, arch):
    """loss_fn (with the aux term) and every gradient, then three train
    steps with AdamW: loss and gradient norm within 1e-5 relative, the
    parameters within 1e-5 of the tree's largest value (AdamW divides each
    gradient by its own magnitude; tests/test_torch_train.py)."""
    cj, ct = _configs(arch, attn_impl="chunked")
    pj, pt = _params(cj, seed=5)
    rng = np.random.default_rng(5)
    tok, lab = (rng.integers(0, cj.vocab_size, (4, 24)).astype(np.int32)
                for _ in range(2))
    bj = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    bt = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)}
    lj, gj = _jit(mesh11, jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, b, cj, AX)), pj, bj)
    lt, gt = ttf._value_and_grad(pt, bt, ct, TAX)
    _close(lt, lj, F32_REL)
    names = set()
    for name, g_j, g_t in _pairs(gj, gt):
        _close(g_t, g_j, F32_REL)
        names.add(name.split("/")[-1])
    assert {"w_router", "w_gate", "w_up", "w_down"} <= names
    with compat.set_mesh(mesh11):
        step_j = jax.jit(jtf.make_train_step(cj, AX,
                                             jadamw.AdamWConfig()))
        state_j = jadamw.adamw_init(pj)
        metrics_j = []
        for _ in range(3):
            pj, state_j, m = step_j(pj, state_j, bj)
            metrics_j.append(m)
    step_t = ttf.make_train_step(ct, TAX, tadamw.AdamWConfig())
    state_t = tadamw.adamw_init(pt)
    for mj in metrics_j:
        pt, state_t, mt = step_t(pt, state_t, bt)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                       rtol=F32_REL)
    assert float(metrics_j[-1]["loss"]) < float(metrics_j[0]["loss"])
    scale = max(np.abs(np.asarray(a)).max()
                for a in jax.tree_util.tree_leaves(pj))
    for _, a, b in _pairs(pj, pt):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=F32_REL * scale)
