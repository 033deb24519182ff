"""Kernel 12 of the PyTorch port (flash attention) against the JAX package.

The same numpy inputs go through the JAX ``flash_attention`` (the Pallas
kernel in interpret mode) and the port's ``flash_attention`` (on CPU
tensors, the kernel's plain version), and through both ``attention_ref``
oracles. f32 results agree to 1e-6; the kernel agrees with the oracle at
the reference's tolerances (tests/test_kernels.py: 2e-5 f32, 3e-2 bf16).
"""
import importlib

import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

import jax.numpy as jnp

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import build  # noqa: E402

tfa = importlib.import_module("repro_torch.kernels.flash_attention")
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_p, flash_attention_p_plain)

F32_TOL = 1e-6     # port plain version vs Pallas interpret, float32
REF_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py:63

# (B, Hq, Hkv, Sq, Skv, D, causal, dtype, bq, bk, q_offset)
CASES = {
    # the five cases of tests/test_kernels.py:48-54
    "mha": (2, 4, 4, 128, 128, 64, True, "float32", 64, 64, 0),
    "gqa_pads": (2, 4, 2, 96, 160, 64, True, "float32", 32, 64, 0),
    "mqa_bidir": (1, 8, 1, 64, 64, 32, False, "float32", 64, 32, 0),
    "bf16": (2, 4, 4, 128, 128, 64, True, "bfloat16", 64, 64, 0),
    "ragged_pads": (1, 2, 2, 33, 77, 16, True, "float32", 16, 32, 0),
    # tests/test_kernels.py:68, decode-shaped
    "decode_offset": (1, 4, 2, 1, 192, 64, True, "float32", 1, 128, 191),
    # gemma's head width with two q tiles (and two kv tiles)
    "d256_two_q_tiles": (1, 2, 2, 256, 256, 256, True, "float32", 128, 128, 0),
    # a GQA group of 3
    "gqa_group3": (2, 6, 2, 48, 80, 32, True, "float32", 16, 32, 0),
    # D = 128 (deepseek's and mistral's head width), non-causal
    "d128_bidir": (1, 2, 1, 40, 72, 128, False, "float32", 32, 32, 0),
}


def _inputs(case, seed=0):
    B, Hq, Hkv, Sq, Skv, D, _, dtype, *_ = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    # the same values in both frameworks (bf16 rounded once, by JAX)
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_pallas_interpret(name):
    case = CASES[name]
    causal, dtype, bq, bk, off = case[6:]
    jx, tx = _inputs(case)
    kw = dict(causal=causal, q_offset=off, block_q=bq, block_k=bk)
    want = np.asarray(jax_flash(*jx, interpret=True, **kw).astype(jnp.float32))
    got = tfa.flash_attention(*tx, **kw)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=F32_TOL)
    else:
        # both round the same f32 function once: at most one bf16 ulp apart
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(_np(got) - want) <= ulp)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_matches_ref(name):
    """The port's kernel path against the port's oracle at the reference's
    tolerances, and the port's oracle against the JAX oracle."""
    case = CASES[name]
    causal, dtype, bq, bk, off = case[6:]
    jx, tx = _inputs(case, seed=1)
    out = tfa.flash_attention(*tx, causal=causal, q_offset=off, block_q=bq,
                              block_k=bk)
    ref = tfa.attention_ref(*tx, causal=causal, q_offset=off)
    assert np.abs(_np(out) - _np(ref)).max() < REF_TOL[dtype]
    jref = np.asarray(jax_attention_ref(*jx, causal=causal, q_offset=off)
                      .astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else REF_TOL[dtype]
    np.testing.assert_allclose(_np(ref), jref, rtol=0, atol=tol)


def test_negative_offset_masks_whole_rows():
    """q_offset < 0 leaves the first rows with no valid key: the kernels
    give 0 there (both), the oracles NaN (both)."""
    case = (1, 3, 1, 40, 40, 32, True, "float32", 16, 16, -20)
    jx, tx = _inputs(case, seed=2)
    kw = dict(causal=True, q_offset=-20, block_q=16, block_k=16)
    want = np.asarray(jax_flash(*jx, interpret=True, **kw))
    got = _np(tfa.flash_attention(*tx, **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert np.all(got[:, :, :20] == 0) and np.all(want[:, :, :20] == 0)
    assert np.abs(got[:, :, 20:]).max() > 0
    ref = _np(tfa.attention_ref(*tx, causal=True, q_offset=-20))
    jref = np.asarray(jax_attention_ref(*jx, causal=True, q_offset=-20))
    assert np.isnan(ref[:, :, :20]).all() and np.isnan(jref[:, :, :20]).all()
    np.testing.assert_allclose(ref[:, :, 20:], jref[:, :, 20:], rtol=0,
                               atol=F32_TOL)


def test_kernel_on_cpu_is_the_plain_version():
    """On CPU tensors the kernel wrapper is the plain version, bit for bit,
    and counts no launch."""
    jx, tx = _inputs(CASES["gqa_pads"])
    q, k, v = tx
    kw = dict(scale=64 ** -0.5, causal=True, q_offset=0, kv_len=150,
              block_q=32, block_k=32)
    before = dict(build.LAUNCHES)
    a = flash_attention_p(q, k, v, **kw)
    b = flash_attention_p_plain(q, k, v, **kw)
    assert torch.equal(a, b)
    assert build.LAUNCHES == before


def test_flash_attention_strided_inputs():
    """[B, S, H, D] tensors seen as [B, H, S, D] (as attention() passes
    them) give the same result as contiguous copies."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 64, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64, 2, 32)).astype(np.float32))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    a = tfa.flash_attention(*views, block_q=32, block_k=32)
    b = tfa.flash_attention(*[t.contiguous() for t in views], block_q=32,
                            block_k=32)
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["group", "q_blocks", "kv_blocks", "kv_len"])
def test_flash_attention_rejects_bad_shapes(bad):
    q = torch.zeros((1, 4, 32, 16))
    k = torch.zeros((1, 2, 32, 16))
    kw = dict(scale=0.25, causal=True, q_offset=0, kv_len=32, block_q=16,
              block_k=16)
    if bad == "group":
        k = torch.zeros((1, 3, 32, 16))
    elif bad == "q_blocks":
        kw["block_q"] = 24
    elif bad == "kv_blocks":
        kw["block_k"] = 24
    else:
        kw["kv_len"] = 33
    with pytest.raises(ValueError):
        flash_attention_p(q, k, k, **kw)
    if bad == "group":
        with pytest.raises(ValueError):
            tfa.flash_attention(q, k, k)


def _bf16_ulps(got, want):
    """Largest elementwise |got - want| in bf16 ulps of |want|, an ulp being
    at least 5e-6 (for values near 0), as the card's checks count them."""
    w = want.float().abs()
    ulp = torch.exp2(torch.frexp(w)[1].float() - 8)
    ulp = torch.where(w > 0, ulp, 0.0).clamp(min=5e-6)
    return float(((got.float() - want.float()).abs() / ulp).max())


def _p_rounded(q, k, v, scale, how):
    """Causal attention in f32 with p rounded before p v as the bf16
    tensor-core kernel could round it: "hi+lo" splits p into bf16(p) and
    bf16(p - bf16(p)), two products summed in f32 (the kernel's choice);
    "bf16" rounds p once (what plain bf16 FlashAttention does). l is the f32
    sum of the unrounded p."""
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(causal, s, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.bfloat16().float()
    parts = [hi, (p - hi).bfloat16().float()] if how == "hi+lo" else [hi]
    acc = sum(torch.einsum("bhqk,bhkd->bhqd", x, v.float()) for x in parts)
    return (acc / p.sum(-1, keepdim=True)).bfloat16()


def test_split_p_keeps_bf16_within_two_ulps():
    """Why the tensor-core kernel runs P v twice: at gemma-smoke's heads
    (4 x 32), causal, bf16 inputs over 512 positions, splitting p into bf16
    hi + lo stays within the 2 bf16 ulps that the card's checks hold kernel
    12 to against its plain version; rounding p to bf16 alone does not."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 4, 512, 32))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    kw = dict(scale=32 ** -0.5, causal=True, q_offset=0, kv_len=512)
    plain = flash_attention_p_plain(q, k, v, block_q=128, block_k=128, **kw)
    assert _bf16_ulps(_p_rounded(q, k, v, kw["scale"], "hi+lo"), plain) <= 2
    assert _bf16_ulps(_p_rounded(q, k, v, kw["scale"], "bf16"), plain) > 2


def _tf32(x, how):
    """f32 values cut to TF32 (10 mantissa bits), kept as f32: "round" to
    nearest with ties away from zero (the f32 kernel's cvt.rna), or
    "truncate" (the 13 low bits dropped)."""
    bits = x.contiguous().view(torch.int32)
    if how == "round":
        bits = bits + 0x1000
    return (bits & ~0x1FFF).view(torch.float32)


def _tf32_products(eq, a, b, terms, how):
    """einsum ``eq`` of f32 ``a`` and ``b`` as the f32 kernel's tensor cores
    take it: each operand split into hi = tf32(x) and lo = tf32(x - hi), and
    hi hi (+ hi lo + lo hi when ``terms`` is 3) summed in f32. A product of
    two TF32 values is exact in f32."""
    ah, bh = _tf32(a, how), _tf32(b, how)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        al, bl = _tf32(a - ah, how), _tf32(b - bh, how)
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def _tf32_attention(q, k, v, scale, terms, how, block_k=32):
    """Causal attention in the f32 kernel's arithmetic: kv tiles of 32, the
    plain version's online-softmax update with its guards, S = Q K^T and
    P V in ``terms`` TF32 products, l the f32 sum of the unsplit p."""
    S = q.shape[2]
    qi = torch.arange(S)[:, None]
    acc = torch.zeros(q.shape)
    m = torch.full(q.shape[:3], -torch.inf)
    l = torch.zeros(q.shape[:3])
    for j0 in range(0, k.shape[2], block_k):
        kb, vb = k[:, :, j0:j0 + block_k], v[:, :, j0:j0 + block_k]
        s = _tf32_products("bhqd,bhkd->bhqk", q, kb, terms, how) * scale
        valid = qi >= j0 + torch.arange(kb.shape[2])[None, :]
        s = torch.where(valid, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - torch.where(torch.isfinite(m_new), m_new,
                                      0.0)[..., None])
        p = torch.where(valid, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _tf32_products(
            "bhqk,bhkd->bhqd", p, vb, terms, how)
        m = m_new
    return acc / torch.where(l > 0, l, 1.0)[..., None]


@pytest.mark.parametrize("how", ["round", "truncate"])
@pytest.mark.parametrize("D", [128, 256])
def test_three_tf32_products_keep_f32_within_2e5(D, how):
    """Why the f32 kernel runs each product as three TF32 products: causal,
    numpy-seeded inputs over 96 positions (kv tiles of 32, each on the
    diagonal straddling it), 3xTF32 stays within the reference's 2e-5 of the
    plain version at gemma's and deepseek's head widths, with TF32 rounded
    (the kernel's cvt.rna) or truncated; one TF32 product does not."""
    rng = np.random.default_rng(18 + D)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 96, D))
                                .astype(np.float32)) for _ in range(3))
    scale = D ** -0.5
    plain = flash_attention_p_plain(q, k, v, scale=scale, causal=True,
                                    q_offset=0, kv_len=96, block_q=96,
                                    block_k=32)
    err3 = float((_tf32_attention(q, k, v, scale, 3, how) - plain)
                 .abs().max())
    err1 = float((_tf32_attention(q, k, v, scale, 1, how) - plain)
                 .abs().max())
    assert err3 <= REF_TOL["float32"], err3
    assert err1 > REF_TOL["float32"], err1


def test_tf32_key_order_pairs_p_fragments_with_v():
    """The f32 kernel hands S's accumulator to P V as tf32 A fragments
    unshuffled: a thread holds keys 2t and 2t + 1 of each group of 8 (the
    accumulator) where the fragment's columns are t and t + 4, so V^T's
    columns hold each group's keys in the order 0 2 4 6 1 3 5 7. With P and
    V so permuted alike, the product equals the plain one (integer values,
    exact); with V unpermuted it does not."""
    rng = np.random.default_rng(18)
    P = torch.from_numpy(rng.integers(-8, 8, (64, 32)).astype(np.float32))
    V = torch.from_numpy(rng.integers(-8, 8, (32, 16)).astype(np.float32))
    A = torch.zeros(64, 32)
    for w in range(4):
        for lane in range(32):
            g, t = lane // 4, lane % 4

            def acc(i):   # accumulator register i of this thread
                return P[16 * w + g + 8 * ((i >> 1) & 1),
                         8 * (i >> 2) + 2 * t + (i & 1)]
            for kk in range(4):   # a0, a1, a2, a3 = s[4kk], [+2], [+1], [+3]
                A[16 * w + g, 8 * kk + t] = acc(4 * kk)
                A[16 * w + g + 8, 8 * kk + t] = acc(4 * kk + 2)
                A[16 * w + g, 8 * kk + t + 4] = acc(4 * kk + 1)
                A[16 * w + g + 8, 8 * kk + t + 4] = acc(4 * kk + 3)
    Vt = torch.zeros(32, 16)
    for key in range(32):   # the column the kernel writes key ``key`` to
        x = key & 7
        Vt[(key & ~7) | (x >> 1) | ((x & 1) << 2)] = V[key]
    assert torch.equal(A @ Vt, P @ V)
    assert not torch.equal(A @ V, P @ V)
