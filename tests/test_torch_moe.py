"""The PyTorch port's MoE FFN against the JAX package: the routing,
top-k's tie order, and ``moe_ffn`` forward and gradients under both of
the reference's impls with one and two token groups
(tests/test_torch_moe_model.py holds the two MoE LM configs end to end).

The JAX side runs under ``jax.jit`` inside ``compat.set_mesh`` on a 1 x 1
mesh. The reference's ``shmap`` impl keeps one token group a data shard,
so at two groups it runs in a subprocess on two spoofed host devices (a
2 x 1 mesh). The same numpy inputs go through both packages.

Tolerances: routing (``topi``, ``slot_token``, ``pos``, ``keep``) exact;
float32 outputs and gradients within 1e-5 of the largest JAX value, the
aux loss within 1e-6.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp
from jax import lax

from repro import compat
from repro.distributed.sharding import MeshAxes
from repro.models import moe as jmoe
from repro.models import transformer as jtf

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.distributed.sharding import MeshAxes as TMeshAxes  # noqa: E402,E501
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-5
AUX_ATOL = 1e-6


def _ax(groups):
    return MeshAxes(data=("data",), data_shards=groups)


def _tax(groups):
    return TMeshAxes(data=("data",), data_shards=groups)


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


# ---------------------------------------------------------------- routing

def _probs(rng, T, E, skew, ties):
    """Router probabilities: ``skew`` piles the mass on the first experts
    (so they overflow their capacity); ``ties`` rounds the logits to a
    coarse grid, so many probabilities are equal."""
    logits = rng.standard_normal((T, E)).astype(np.float32)
    logits += skew * np.linspace(2, 0, E, dtype=np.float32)
    if ties:
        logits = np.round(logits * 2) / 2
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("E,k", [(4, 1), (8, 2), (64, 8)])
@pytest.mark.parametrize("case", ["plain", "overflow", "ties"])
def test_routing_matches_reference(E, k, case):
    rng = np.random.default_rng(E * 10 + k)
    T = 96
    probs = _probs(rng, T, E, skew=3.0 if case == "overflow" else 0.0,
                   ties=case == "ties")
    _, topi_j = lax.top_k(jnp.asarray(probs), k)
    topv_t, topi_t = tmoe.top_k(torch.from_numpy(probs), k)
    assert topi_t.dtype == torch.int32
    assert np.array_equal(topi_t.numpy(), np.asarray(topi_j))
    for cf in (0.5, 1.25):
        Cg = max(int(T * k / E * cf), 1)
        want = jmoe._routing_group(topi_j, E, k, Cg)
        got = tmoe._routing_group(topi_t, E, k, Cg)
        for name, a, b in zip(("slot_token", "pos", "keep"), got, want):
            assert a.dtype == (torch.bool if name == "keep"
                               else torch.int32), name
            assert np.array_equal(a.numpy(), np.asarray(b)), (name, cf)
        if case == "overflow":
            assert not bool(got[2].all())          # capacity drops happen


def test_top_k_breaks_ties_as_lax_top_k():
    """bf16-rounded router logits tie often; the port's top-k keeps
    ``lax.top_k``'s order (the lower expert first among equals), which
    ``torch.topk`` does not on these inputs."""
    rng = np.random.default_rng(3)
    logits = jnp.asarray(rng.standard_normal((512, 16)) * 0.05,
                         jnp.bfloat16).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    p = torch.from_numpy(np.array(probs))
    for k in (1, 2, 4, 8):
        vj, ij = lax.top_k(probs, k)
        vt, it = tmoe.top_k(p, k)
        assert np.array_equal(it.numpy(), np.asarray(ij)), k
        assert np.array_equal(vt.numpy(), np.asarray(vj)), k
    assert not np.array_equal(torch.topk(p, 4).indices.numpy(),
                              np.asarray(lax.top_k(probs, 4)[1]))
    vals = torch.tensor([[0.1, .3, .3, .3, 0, .3]])
    assert tmoe.top_k(vals, 3)[1].tolist() == [[1, 2, 3]]


# ---------------------------------------------------------------- moe_ffn

def _ffn_inputs(seed, B=2, S=24, D=32, E=8, Fe=48, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(dtype)
    lp = {"w_router": rng.standard_normal((D, E)).astype(dtype) * 0.3,
          "w_gate": rng.standard_normal((E, D, Fe)).astype(dtype) * 0.2,
          "w_up": rng.standard_normal((E, D, Fe)).astype(dtype) * 0.2,
          "w_down": rng.standard_normal((E, Fe, D)).astype(dtype) * 0.2}
    cot = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, lp, cot


def _moe_cfgs(cf, E=8, k=2, Fe=48):
    kw = dict(n_experts=E, top_k=k, d_expert=Fe, capacity_factor=cf)
    return jtf.MoeConfig(**kw), ttf.MoeConfig(**kw)


def _jax_ffn(mj, impl, groups):
    """The reference's (moe_ffn, its loss sum(y * cot) + 0.7 aux)."""
    ax = _ax(groups)

    def f(x, lp):
        return jmoe.moe_ffn(x, lp, mj, "silu", ax, impl=impl)

    def loss(x, lp, cot):
        y, aux = f(x, lp)
        return jnp.sum(y * cot) + 0.7 * aux
    return f, loss


def _torch_ffn(x, lp, cot, mt, impl, groups):
    xt = torch.from_numpy(x).requires_grad_(True)
    lpt = {n: torch.from_numpy(a).requires_grad_(True) for n, a in lp.items()}
    y, aux = tmoe.moe_ffn(xt, lpt, mt, "silu", _tax(groups), impl=impl)
    loss = (y * torch.from_numpy(cot)).sum() + 0.7 * aux
    grads = torch.autograd.grad(loss, [xt, *lpt.values()])
    return y, aux, dict(zip(["x", *lpt], grads))


_SHMAP2_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro import compat
    from repro.distributed.sharding import MeshAxes
    from repro.models import moe, transformer as tf

    src, out = sys.argv[1], sys.argv[2]
    d = dict(np.load(src))
    mesh = compat.make_mesh((2, 1), ("data", "model"))
    ax = MeshAxes(data=("data",), data_shards=2)
    res = {}
    for cf in (1.25, 0.5):
        mc = tf.MoeConfig(n_experts=8, top_k=2, d_expert=48,
                          capacity_factor=cf)
        lp = {n: jnp.asarray(d[n]) for n in
              ("w_router", "w_gate", "w_up", "w_down")}

        def loss(x, lp):
            y, aux = moe.moe_ffn(x, lp, mc, "silu", ax, impl="shmap")
            return jnp.sum(y * d["cot"]) + 0.7 * aux, (y, aux)
        with compat.set_mesh(mesh):
            (_, (y, aux)), g = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(jnp.asarray(d["x"]), lp)
        res[f"{cf}/y"], res[f"{cf}/aux"] = np.asarray(y), np.asarray(aux)
        res[f"{cf}/x"] = np.asarray(g[0])
        for n, a in g[1].items():
            res[f"{cf}/{n}"] = np.asarray(a)
    np.savez(out, **res)
    print("SHMAP2 OK")
""")


@pytest.fixture(scope="module")
def shmap_two_groups(tmp_path_factory):
    """The reference's shmap impl at two data shards, on a 2 x 1 mesh of
    spoofed host devices (the device count is fixed when JAX starts)."""
    d = tmp_path_factory.mktemp("shmap2")
    x, lp, cot = _ffn_inputs(11)
    np.savez(d / "in.npz", x=x, cot=cot, **lp)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _SHMAP2_PROG,
                          str(d / "in.npz"), str(d / "out.npz")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("impl,groups", [("gspmd", 1), ("shmap", 1),
                                         ("gspmd", 2), ("shmap", 2)])
def test_moe_ffn_matches_reference(mesh11, shmap_two_groups, impl, groups,
                                   cf):
    """y, aux and the gradients in x, the router and the experts, against
    each of the reference's impls at ``data_shards`` 1 and 2 (group-local
    capacity). At capacity_factor 0.5 the experts hold half of the 96
    (token, k) assignments, so at least half are dropped."""
    x, lp, cot = _ffn_inputs(11)
    mj, mt = _moe_cfgs(cf)
    yt, auxt, gt = _torch_ffn(x, lp, cot, mt, impl, groups)
    if impl == "shmap" and groups == 2:
        want = {n: shmap_two_groups[f"{cf}/{n}"] for n in
                ("y", "aux", "x", *lp)}
    else:
        f, loss = _jax_ffn(mj, impl, groups)
        lpj = {n: jnp.asarray(a) for n, a in lp.items()}
        yj, auxj = _jit(mesh11, f, jnp.asarray(x), lpj)
        gx, glp = _jit(mesh11, jax.grad(loss, argnums=(0, 1)),
                       jnp.asarray(x), lpj, jnp.asarray(cot))
        want = dict(y=yj, aux=auxj, x=gx, **glp)
    _close(yt, want["y"], F32_REL)
    assert abs(float(auxt.detach()) - float(want["aux"])) <= AUX_ATOL
    for name, g in gt.items():
        _close(g, want[name], F32_REL)


def test_moe_ffn_shmap_needs_whole_groups():
    x, lp, _ = _ffn_inputs(2, B=1, S=5)
    _, mt = _moe_cfgs(1.25)
    lpt = {n: torch.from_numpy(a) for n, a in lp.items()}
    with pytest.raises(ValueError, match="equal groups"):
        tmoe.moe_ffn(torch.from_numpy(x), lpt, mt, "silu", _tax(2),
                     impl="shmap")
    # gspmd halves the groups until they divide the 5 tokens: one group
    y1, a1 = tmoe.moe_ffn(torch.from_numpy(x), lpt, mt, "silu", _tax(2))
    y0, a0 = tmoe.moe_ffn(torch.from_numpy(x), lpt, mt, "silu", _tax(1))
    assert torch.equal(y1, y0) and torch.equal(a1, a0)


def test_moe_ffn_gelu_and_decode_capacity(mesh11):
    """GeGLU (gelu in its tanh form) and the decode shape: T = B = 4
    tokens over 8 experts top-2 gives Cg = max(int(1.0 * 1.25 / ...), 1),
    a capacity of one slot, so tokens that share an expert are dropped as
    the reference drops them."""
    x, lp, _ = _ffn_inputs(5, B=4, S=1)
    mj, mt = _moe_cfgs(1.25)
    lpj = {n: jnp.asarray(a) for n, a in lp.items()}
    for act in ("gelu", "silu"):
        yj, auxj = _jit(mesh11, lambda x, lp: jmoe.moe_ffn(
            x, lp, mj, act, _ax(1), impl="gspmd"), jnp.asarray(x), lpj)
        yt, auxt = tmoe.moe_ffn(torch.from_numpy(x),
                                {n: torch.from_numpy(a) for n, a in
                                 lp.items()}, mt, act, _tax(1))
        _close(yt, yj, F32_REL)
        assert abs(float(auxt) - float(auxj)) <= AUX_ATOL
