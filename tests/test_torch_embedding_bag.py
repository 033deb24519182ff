"""The embedding bag of the PyTorch port (kernel 13) against the JAX
package: ``embedding_bag`` (the kernel path, bag axis padded to a multiple
of ``bb``), ``embedding_bag_jnp`` and ``embedding_bag_ref``.

On the CPU the kernel path runs its plain PyTorch version, held here
against the Pallas kernel in interpret mode with tolerance zero, in f32 and
in bf16: both add the rows in ``l`` order in float32 and cast once. The
plain-tensor paths are held to 1e-6 relative: their sums are reductions
over the bag axis that XLA and PyTorch may associate differently (for bf16
tables they also accumulate in float32 and round once, with no order
promised). The CUDA kernel is held against its plain version on the card by
``test_torch_gpu.py``. Inputs are made with numpy; a bf16 table is the same
float32 array rounded by each framework (both round to nearest even).
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.kernels.embedding_bag as j_emb  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag, embedding_bag_jnp, embedding_bag_p, embedding_bag_ref)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(V, D, B, L, dtype, seed):
    """A [V, D] table and [B, L] indices in [0, V] (V is padding), as
    tests/test_kernels.py draws them, for both frameworks."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V + 1, (B, L)).astype(np.int32)
    jd, td = DTYPES[dtype]
    return (jnp.asarray(table, jd), jnp.asarray(idx),
            torch.from_numpy(table).to(td), torch.from_numpy(idx))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


CASES = [  # tests/test_kernels.py's cases, then sum and mean over L 1..7
    (100, 16, 16, 4, "sum", "f32"), (64, 32, 10, 7, "mean", "f32"),
    (128, 8, 8, 3, "sum", "bf16"), (32, 128, 24, 1, "sum", "f32"),
] + [(50, 16, 13, L, mode, dtype) for L in range(1, 8)
     for mode in ("sum", "mean") for dtype in ("f32", "bf16")]


@pytest.mark.parametrize("V,D,B,L,mode,dtype", CASES)
def test_embedding_bag_matches_pallas(V, D, B, L, mode, dtype):
    jt, ji, tt, ti = _inputs(V, D, B, L, dtype, seed=V * L + D)
    before = dict(build.LAUNCHES)
    got = embedding_bag(tt, ti, mode=mode)
    assert build.LAUNCHES == before         # CPU tensors: the plain version
    want = j_emb.embedding_bag(jt, ji, mode=mode, interpret=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, D)
    np.testing.assert_array_equal(_f32(got), _f32(want))


def test_embedding_bag_all_padding():
    table = torch.ones((16, 8))
    idx = torch.full((4, 3), 16, dtype=torch.int32)
    for mode in ("sum", "mean"):
        out = embedding_bag(table, idx, mode=mode)
        assert float(out.abs().max()) == 0.0
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            j_emb.embedding_bag(jnp.ones((16, 8)), jnp.asarray(idx.numpy()),
                                mode=mode)))


@pytest.mark.parametrize("fn", ["embedding_bag_jnp", "embedding_bag_ref"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_tensor_paths_match_reference(fn, mode, dtype):
    jt, ji, tt, ti = _inputs(64, 32, 10, 7, dtype, seed=11)
    port = {"embedding_bag_jnp": embedding_bag_jnp,
            "embedding_bag_ref": embedding_bag_ref}[fn]
    got = port(tt, ti, mode=mode)
    want = getattr(j_emb, fn)(jt, ji, mode=mode)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6, atol=0)


def test_embedding_bag_p_checks_its_operands():
    table = torch.ones((16, 8))
    with pytest.raises(ValueError, match="multiple of bb"):
        embedding_bag_p(table, torch.zeros((10, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, torch.zeros((8, 2), dtype=torch.int32),
                      mode="max")


def _arange_table():
    """V = 10, D = 4, row r = [4r + 1, ..., 4r + 4] (the case of the fault
    found against the reference: negative indices)."""
    return np.arange(40, dtype=np.float32).reshape(10, 4) + 1


@pytest.mark.parametrize("path", ["kernel", "embedding_bag_jnp",
                                  "embedding_bag_ref"])
@pytest.mark.parametrize("mode,first", [("sum", 51.0), ("mean", 17.0)])
def test_negative_indices_wrap(path, mode, first):
    """An index in [-V, 0) reads row V + i and counts, as in all three
    reference paths: bag [1, -1, 2] reads rows 1, 9 and 2, so its first
    column sums to 5 + 37 + 9 = 51 and averages 17."""
    table = _arange_table()
    idx = np.array([[1, -1, 2]] * 8, np.int32)
    port = {"kernel": embedding_bag, "embedding_bag_jnp": embedding_bag_jnp,
            "embedding_bag_ref": embedding_bag_ref}[path]
    got = port(torch.from_numpy(table), torch.from_numpy(idx), mode=mode)
    assert float(got[0, 0]) == first
    jfn = {"kernel": j_emb.embedding_bag, "embedding_bag_jnp":
           j_emb.embedding_bag_jnp, "embedding_bag_ref":
           j_emb.embedding_bag_ref}[path]
    jkw = {"interpret": True} if path == "kernel" else {}
    want = jfn(jnp.asarray(table), jnp.asarray(idx), mode=mode, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_indices_below_minus_v_are_padding():
    """Below -V the port skips the index and does not count it, in every
    path. The reference's paths disagree there and the port follows
    neither: for bag [9, -10, -11] the Pallas kernel reads row 0 for -11 and
    counts it (first column: sum 39, mean 13), ``embedding_bag_jnp`` adds 0
    and counts it (38, 12.67); the port reads rows 9 and 0 (38, 19)."""
    table = torch.from_numpy(_arange_table())
    idx = torch.tensor([[9, -10, -11]] * 8, dtype=torch.int32)
    for port in (embedding_bag, embedding_bag_jnp, embedding_bag_ref):
        assert float(port(table, idx, mode="sum")[0, 0]) == 38.0
        assert float(port(table, idx, mode="mean")[0, 0]) == 19.0
    jt, ji = jnp.asarray(table.numpy()), jnp.asarray(idx.numpy())
    assert float(j_emb.embedding_bag(jt, ji, interpret=True)[0, 0]) == 39.0
    assert float(j_emb.embedding_bag_jnp(jt, ji)[0, 0]) == 38.0
