"""The PyTorch port's transformer serving path against the JAX package.

Parameters are made by the JAX package's ``materialize`` and carried to the
port leaf for leaf (``params_from_numpy``); the same numpy tokens go through
both. The JAX side runs under ``jax.jit`` inside ``compat.set_mesh`` (its
sharding constraints need a mesh), and its ``attn_impl="pallas"`` branch
runs the Pallas kernel in interpret mode: the test replaces
``repro.kernels.flash_attention.flash_attention`` with a wrapper that
passes ``interpret=True`` (``attention()`` passes ``interpret=False``
itself). Nothing in the JAX package changes for it.

Tolerances: float32 logits within 1e-5 of the largest JAX logit (measured
about 7e-7); bfloat16 within 3e-2 of it (the frameworks round at other
places; measured up to 1.0e-2); prefill + decode == forward at
rtol = atol = 2e-3, as tests/test_arch_smoke.py holds the reference.
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

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import registry as torch_registry  # noqa: E402
from repro_torch.examples import serve_decode  # noqa: E402
from repro_torch.distributed.sharding import MeshAxes as TMeshAxes  # noqa: E402,E501
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    ParamDef, as_dtype, materialize, n_params, params_from_numpy)

AX = MeshAxes(data=("data",), data_shards=1)
TAX = TMeshAxes(data=("data",), data_shards=1)
ARCHS = ["gemma-7b", "deepseek-7b", "mistral-large-123b"]   # the dense LMs
IMPLS = ["xla", "chunked", "pallas"]
F32_REL = 1e-5
BF16_REL = 3e-2


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    orig = jax_fa_pkg.flash_attention

    def interpret(*args, interpret=None, **kw):
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(jax_fa_pkg, "flash_attention", interpret)


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


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, rel):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _jit(mesh, fn, *args):
    with compat.set_mesh(mesh):
        return jax.jit(fn)(*args)


def _dtype_name(dt):
    if isinstance(dt, str):
        return dt
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return jnp.dtype(dt).name


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", jax_registry.LM_ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        cj, ct = _configs(arch, smoke)
        for f in dataclasses.fields(cj):
            a, b = getattr(cj, f.name), getattr(ct, f.name)
            if f.name == "dtype":
                assert _dtype_name(a) == _dtype_name(b), (arch, smoke)
            elif f.name == "moe" and a is not None:
                assert type(b) is ttf.MoeConfig
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, (arch, smoke, f.name)
        assert {f.name for f in dataclasses.fields(ct)} == {
            f.name for f in dataclasses.fields(cj)}
        assert ct.hd == cj.hd
        assert ct.n_params() == cj.n_params()
        assert ct.n_active_params() == cj.n_active_params()


def test_registry_matches_reference():
    assert torch_registry.LM_SHAPES == jax_registry.LM_SHAPES
    assert torch_registry.LM_ARCHS == jax_registry.LM_ARCHS
    assert list(torch_registry.ARCHS) == list(jax_registry.ARCHS)
    assert torch_registry.GNN_ARCHS == jax_registry.GNN_ARCHS
    assert torch_registry.REC_ARCHS == jax_registry.REC_ARCHS
    # the GNN and recsys configs load as the reference's (their fields are
    # held in tests/test_torch_train_launch.py)
    for arch in jax_registry.GNN_ARCHS + jax_registry.REC_ARCHS:
        assert (torch_registry._load(arch)[0]
                == jax_registry._load(arch)[0])
    sizes = {"gemma-7b": (9_324_112_896, 9_324_112_896),
             "olmoe-1b-7b": (6_919_100_416, 1_281_955_840),
             "qwen3-moe-235b-a22b": (235_093_634_560, 22_190_763_520)}
    for arch, (total, active) in sizes.items():
        cfg = torch_registry._load(arch)[1]
        assert (cfg.n_params(), cfg.n_active_params()) == (total, active)


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_carries_jax_params(dtype):
    cj, _ = _configs("mistral-large-123b", dtype=dtype)
    pj, pt = _params(cj)
    leaves_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    assert len(leaves_j) == len(jax.tree_util.tree_leaves(
        pt, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for path, lj in leaves_j:
        node = pt
        for key in path:
            node = node[key.key]
        assert node.dtype == getattr(torch, dtype)
        assert np.array_equal(_f32(node), _f32(lj)), path


def test_materialize_follows_the_init_rule():
    _, ct = _configs("gemma-7b", dtype="bfloat16")
    cj, _ = _configs("gemma-7b", dtype="bfloat16")
    pj, _ = _params(cj)
    defs = ttf.param_defs(ct, TAX)
    gen = torch.Generator().manual_seed(0)
    pt = materialize(defs, gen, device="cpu", default_dtype=ct.dtype)
    again = materialize(defs, torch.Generator().manual_seed(0), device="cpu",
                        default_dtype=ct.dtype)
    assert n_params(defs) == ct.n_params()
    for path, lj in jax.tree_util.tree_flatten_with_path(pj)[0]:
        names = [k.key for k in path]
        t, d, t2 = pt, defs, again
        for key in names:
            t, d, t2 = t[key], d[key], t2[key]
        assert tuple(t.shape) == lj.shape and t.dtype == torch.bfloat16
        assert torch.equal(t, t2)                    # seeded
        x = t.float()
        if d.init == "ones":
            assert bool((x == 1).all())
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = d.scale if d.scale is not None else fan_in ** -0.5
            assert abs(float(x.std()) / scale - 1) < 0.05, names
            assert abs(float(x.mean())) < 0.05 * scale, names
    p = materialize({"z": ParamDef((3,), init="zeros"),
                     "h": ParamDef((2, 4), dtype=torch.float32)},
                    torch.Generator().manual_seed(1), device="cpu",
                    default_dtype="bfloat16")
    assert p["z"].dtype == torch.bfloat16 and not p["z"].any()
    assert p["h"].dtype == torch.float32
    assert as_dtype("float32") is torch.float32


# ------------------------------------------------------------ building blocks

def test_rmsnorm_and_rope_match():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 256)).astype(np.float32)
    g = rng.standard_normal(256).astype(np.float32)
    pos = np.stack([np.arange(5), 2075 + np.arange(5)]).astype(np.int32)
    for dt in ("float32", "bfloat16"):
        xj = jnp.asarray(x, dt)
        xt = torch.from_numpy(_f32(xj)).to(getattr(torch, dt))
        rel = F32_REL if dt == "float32" else BF16_REL
        _close(ttf.rmsnorm(xt, torch.from_numpy(g), 1e-6),
               jtf.rmsnorm(xj, jnp.asarray(g), 1e-6), rel)
        for theta in (10_000.0, 1e6):
            _close(ttf.rope(xt, torch.from_numpy(pos), theta),
                   jtf.rope(xj, jnp.asarray(pos), theta), rel)


@pytest.mark.parametrize("causal,q_offset,S,Skv", [
    (True, 0, 40, 40), (True, 13, 7, 20), (False, 0, 9, 37)])
def test_attention_impls_match(causal, q_offset, S, Skv):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, S, 6, 16), (2, Skv, 2, 16), (2, Skv, 2, 16)))
    qj, kj, vj = map(jnp.asarray, (q, k, v))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=causal, q_offset=q_offset, scale=0.25)
    _close(ttf._attn_xla(qt, kt, vt, **kw), jtf._attn_xla(qj, kj, vj, **kw),
           F32_REL)
    args = (causal, q_offset, 0.25, 16)
    _close(ttf._attn_chunked(qt, kt, vt, *args),
           jtf._attn_chunked(qj, kj, vj, *args), F32_REL)
    ot, lt = ttf._attn_fwd_scan(qt, kt, vt, *args)
    oj, lj = jtf._attn_fwd_scan(qj, kj, vj, *args)
    _close(ot, oj, F32_REL)
    _close(lt, lj, F32_REL)
    ct, cj = ttf._chunk_kv(kt, 16), jtf._chunk_kv(kj, 16)
    assert ct[1] == cj[1] and np.array_equal(_f32(ct[0]), _f32(cj[0]))


def test_layer_matches(mesh11):
    cj, ct = _configs("mistral-large-123b", qk_norm=True)
    pj, pt = _params(cj)
    lpj = jax.tree_util.tree_map(lambda t: t[0], pj["layers"])
    lpt = {k: t[0] for k, t in pt["layers"].items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    yj, (kj, vj), _ = _jit(mesh11, lambda x, p: jtf._layer(x, lpj, cj, AX, p),
                           jnp.asarray(x), jnp.asarray(pos))
    yt, (kt, vt), _ = ttf._layer(torch.from_numpy(x), lpt, ct, TAX,
                                 torch.from_numpy(pos))
    for a, b in ((yt, yj), (kt, kj), (vt, vj)):
        _close(a, b, F32_REL)
    # the cache branch: one token at position 12 of a 16-slot cache
    cache = [rng.standard_normal((2, 16, 2, cj.hd)).astype(np.float32)
             for _ in range(2)]
    x1 = x[:, :1]
    p1 = np.full((2, 1), 12, np.int32)
    yj, (ckj, cvj), _ = _jit(
        mesh11, lambda x, p, c0, c1: jtf._layer(x, lpj, cj, AX, p,
                                                cache=(c0, c1), cache_pos=12),
        jnp.asarray(x1), jnp.asarray(p1), *map(jnp.asarray, cache))
    ct_ = [torch.from_numpy(c.copy()) for c in cache]
    yt, (ckt, cvt), _ = ttf._layer(torch.from_numpy(x1), lpt, ct, TAX,
                                   torch.from_numpy(p1), cache=tuple(ct_),
                                   cache_pos=12)
    assert ckt is ct_[0] and cvt is ct_[1]          # written in place
    for a, b in ((yt, yj), (ckt, ckj), (cvt, cvj)):
        _close(a, b, F32_REL)


def test_embed_scale_rounds_to_bf16():
    """gemma multiplies by sqrt(3072) rounded to bf16 first (55.5, not
    55.43), as transformer.py:386 does."""
    cfg = ttf.TransformerConfig(name="e", n_layers=0, d_model=3072, n_heads=1,
                                n_kv_heads=1, d_ff=8, vocab_size=8,
                                embed_scale=True)
    assert float(torch.tensor(3072 ** 0.5, dtype=torch.bfloat16)) == 55.5
    rng = np.random.default_rng(7)
    emb = jnp.asarray(rng.standard_normal((8, 3072)), jnp.bfloat16)
    toks = np.array([[1, 5, 7]], np.int32)
    want = jnp.take(emb, toks, axis=0) * jnp.asarray(3072 ** 0.5, jnp.bfloat16)
    params = {"embed": torch.from_numpy(_f32(emb)).to(torch.bfloat16),
              "layers": {}}
    x, _, _ = ttf._trunk(params, torch.from_numpy(toks), cfg, TAX)
    assert np.array_equal(_f32(x), _f32(want))
    plain = params["embed"][torch.from_numpy(toks).long()] * 3072 ** 0.5
    assert not torch.equal(x, plain)


# ------------------------------------------------------------ the model

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch,over", [
    ("gemma-7b", {}), ("deepseek-7b", {}), ("mistral-large-123b", {}),
    ("deepseek-7b", {"qk_norm": True})],
    ids=["gemma", "deepseek", "mistral_gqa", "qk_norm"])
def test_forward_matches(mesh11, jax_pallas_interpret, arch, over, impl):
    cj, ct = _configs(arch, attn_impl=impl, **over)
    pj, pt = _params(cj, seed=1)
    toks = _tokens(cj, (2, 40), seed=2)
    lj, kvj, _ = _jit(mesh11, lambda p, t: jtf.forward(p, t, cj, AX), pj,
                      jnp.asarray(toks))
    lt, kvt, aux = ttf.forward(pt, torch.from_numpy(toks), ct, TAX)
    _close(lt, lj, F32_REL)
    for a, b in zip(kvt, kvj):
        _close(a, b, F32_REL)
    assert float(aux) == 0.0


def test_forward_bf16_matches(mesh11, jax_pallas_interpret):
    cj, ct = _configs("gemma-7b", attn_impl="pallas", dtype="bfloat16")
    pj, pt = _params(cj, seed=3)
    toks = _tokens(cj, (2, 40), seed=3)
    lj, kvj, _ = _jit(mesh11, lambda p, t: jtf.forward(p, t, cj, AX), pj,
                      jnp.asarray(toks))
    lt, kvt, _ = ttf.forward(pt, torch.from_numpy(toks), ct, TAX)
    assert lt.dtype == torch.float32 and kvt[0].dtype == torch.bfloat16
    _close(lt, lj, BF16_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_match(mesh11, jax_pallas_interpret, arch):
    """The step functions against JAX's: the prefill's last logits and
    caches, three decode steps into caches padded by 4, then a step at a
    position past the end, where both clamp the write to the last slot."""
    cj, ct = _configs(arch, attn_impl="pallas")
    pj, pt = _params(cj, seed=4)
    toks = _tokens(cj, (2, 20), seed=4)
    lj, kvj = _jit(mesh11, jtf.make_prefill_step(cj, AX), pj,
                   {"tokens": jnp.asarray(toks[:, :16])})
    lt, kvt = ttf.make_prefill_step(ct, TAX)(
        pt, {"tokens": torch.from_numpy(toks[:, :16])})
    _close(lt, lj, F32_REL)
    assert kvt[0].shape == (cj.n_layers, 2, 16, cj.n_kv_heads, cj.hd)
    for a, b in zip(kvt, kvj):
        _close(a, b, F32_REL)
    cj_ = tuple(jnp.pad(t, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0)))
                for t in kvj)
    ct_ = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 4)) for t in kvt)
    serve_j = jtf.make_serve_step(cj, AX)
    serve_t = ttf.make_serve_step(ct, TAX)
    for pos in (16, 17, 18, 25):
        tok = toks[:, pos:pos + 1] if pos < 20 else toks[:, :1]
        lj, cj_ = _jit(mesh11, serve_j, pj, jnp.asarray(tok), cj_,
                       jnp.int32(pos))
        lt, ct_ = serve_t(pt, torch.from_numpy(tok), ct_, pos)
        _close(lt, lj, F32_REL)
        for a, b in zip(ct_, cj_):
            _close(a, b, F32_REL)


def test_serve_step_leaves_caches_intact(mesh11):
    """Two continuations decoded from one prefill (the caller keeps the
    prefill's caches and branches from them): each equals the JAX package's,
    whose serve step returns new caches, and the caches passed in stay
    unchanged. Donated caches are written in place and returned."""
    cj, ct = _configs("gemma-7b")
    pj, pt = _params(cj, seed=7)
    toks = _tokens(cj, (2, 16), seed=7)
    _, kvj = _jit(mesh11, jtf.make_prefill_step(cj, AX), pj,
                  {"tokens": jnp.asarray(toks)})
    _, kvt = ttf.make_prefill_step(ct, TAX)(pt, {"tokens": torch.from_numpy(toks)})
    cj0 = tuple(jnp.pad(t, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
                for t in kvj)
    ct0 = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 3)) for t in kvt)
    kept = tuple(t.clone() for t in ct0)
    serve_j, serve_t = jtf.make_serve_step(cj, AX), ttf.make_serve_step(ct, TAX)
    ends = []
    for first in (1, 2):       # two different first tokens, one prefill
        tok = np.full((2, 1), first, np.int32)
        cjb, ctb = cj0, ct0
        for pos in (16, 17, 18):
            lj, cjb = _jit(mesh11, serve_j, pj, jnp.asarray(tok), cjb,
                           jnp.int32(pos))
            lt, ctb = serve_t(pt, torch.from_numpy(tok), ctb, pos)
            _close(lt, lj, F32_REL)
            tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
        for a, b in zip(ctb, cjb):
            _close(a, b, F32_REL)
        assert all(torch.equal(a, b) for a, b in zip(ct0, kept))
        ends.append(ctb[0])
    assert not torch.equal(ends[0], ends[1])
    donated = ttf.make_serve_step(ct, TAX, donate=True)(
        pt, torch.ones((2, 1), dtype=torch.int32), ct0, 16)[1]
    assert donated[0] is ct0[0] and donated[1] is ct0[1]
    assert not torch.equal(ct0[0], kept[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Prefill + decode reproduce the full forward's logits (the serving
    path's invariant, tests/test_arch_smoke.py:92), on the port alone with
    its own parameters."""
    _, ct = _configs(arch, attn_impl="pallas")
    params = materialize(ttf.param_defs(ct, TAX), torch.Generator().manual_seed(1),
                         device="cpu", default_dtype=ct.dtype)
    B, S, pre = 2, 24, 20
    toks = torch.from_numpy(_tokens(ct, (B, S), seed=5))
    full, _, _ = ttf.forward(params, toks, ct, TAX)
    _, kvs = ttf.make_prefill_step(ct, TAX)(params, {"tokens": toks[:, :pre]})
    caches = tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, S - pre))
                   for t in kvs)
    serve = ttf.make_serve_step(ct, TAX)
    for i in range(pre, S):
        logits, caches = serve(params, toks[:, i:i + 1], caches, i)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_generate_matches_reference_loop(mesh11, jax_pallas_interpret):
    """The port's serving example (greedy decode) gives the tokens of the
    reference example's loop on the same parameters and prompts."""
    cj, ct = _configs("gemma-7b", attn_impl="pallas")
    pj, pt = _params(cj, seed=6)
    B, P, G = 2, 12, 6
    prompts = _tokens(cj, (B, P), seed=6)
    with compat.set_mesh(mesh11):
        logits, kvs = jax.jit(jtf.make_prefill_step(cj, AX))(
            pj, {"tokens": jnp.asarray(prompts)})
        caches = tuple(jnp.pad(t, ((0, 0), (0, 0), (0, G), (0, 0), (0, 0)))
                       for t in kvs)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        outs = [tok]
        serve = jax.jit(jtf.make_serve_step(cj, AX))
        for i in range(G - 1):
            logits, caches = serve(pj, tok, caches, jnp.int32(P + i))
            tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
            outs.append(tok)
    want = np.concatenate([np.asarray(t) for t in outs], axis=1)
    got = serve_decode.generate(pt, torch.from_numpy(prompts), ct, TAX,
                                 G)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_serve_example_runs_on_cpu(capsys):
    serve_decode.main("cpu")
    assert capsys.readouterr().out.strip().endswith("ok")


def test_params_and_example_default_to_cuda(monkeypatch):
    """With no device named, the parameters and the example go to cuda;
    without a CUDA device they raise rather than land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    defs = {"w": ParamDef((2, 3))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize(defs, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros((2, 3), np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.main()
    assert materialize(defs, torch.Generator().manual_seed(0),
                       device="cpu")["w"].device.type == "cpu"
