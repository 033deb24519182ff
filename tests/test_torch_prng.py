"""The port's threefry draws (``repro_torch.core.prng``) against
``jax.random``, bit for bit: the key, ``fold_in``, ``split`` (into 2 and
into n keys), ``uniform`` and ``randint``, on int keys and on batched key
tensors, and the ``[P, K, M]`` draws of the fault injector against
``jax.vmap``. ``normal`` (the weights' draws) against
``jax.random.normal``: its uniforms bit for bit, the normals within 4 ulp
(XLA's ``erf_inv`` polynomial, but another ``log1p``), and a draw in
slices equal to the whole draw bit for bit.

The port reproduces JAX's partitionable threefry only; the first test
fails loudly if a JAX release changes that default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import FaultPlan, prng  # noqa: E402
from repro_torch.core.faults import round_keys  # noqa: E402

SEEDS = (0, 1, 11, 2**31 - 1)
SHAPES = ((1,), (37,), (3, 5), (4, 96))


def _words(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)
                                            if jnp.issubdtype(
                                                key.dtype,
                                                jax.dtypes.prng_key)
                                            else key))


def test_threefry_partitionable_is_jax_default():
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_and_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert _words(key) == prng.prng_key(seed)
    for r in range(10):
        rkey = jax.random.fold_in(key, r)
        pkey = prng.fold_in(prng.prng_key(seed), r)
        assert _words(rkey) == pkey
        for rank in range(10):
            assert (_words(jax.random.fold_in(rkey, rank))
                    == prng.fold_in(pkey, rank))
        a, b = jax.random.split(rkey)
        ta, tb = prng.split(torch.tensor(pkey))
        assert (_words(a), _words(b)) == (tuple(ta.tolist()),
                                          tuple(tb.tolist()))


@pytest.mark.parametrize("seed", [0, 11])
def test_round_keys_match_vmap(seed):
    """The injector's [P, 2] keys of a round (``faults.round_keys``) ==
    ``jax.vmap`` of ``fold_in`` over the ranks, as the reference's round
    derives them."""
    for rnd in (0, 3, 1000):
        rkey = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        want = np.asarray(jax.vmap(lambda r: jax.random.fold_in(rkey, r))(
            jnp.arange(10)))
        got = round_keys(FaultPlan(drop=0.1, seed=seed), rnd, 10, "cpu")
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_randint_match_jax(seed, shape):
    for r in range(10):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), r)
        tkey = torch.tensor(prng.fold_in(prng.prng_key(seed), r))
        u = np.asarray(jax.random.uniform(key, shape))
        tu = prng.uniform(tkey, shape).numpy()
        assert tu.dtype == np.float32
        np.testing.assert_array_equal(tu.view(np.uint32), u.view(np.uint32))
        for hi in (1, 2, 3, 7):
            ri = np.asarray(jax.random.randint(key, shape, 0, hi))
            ti = prng.randint(tkey, shape, 0, hi).numpy()
            assert ti.dtype == ri.dtype
            np.testing.assert_array_equal(ti, ri)


@pytest.mark.parametrize("seed", [0, 12])
def test_shard_batched_draws_match_vmap(seed):
    """The injector's draws: per-shard keys ``fold_in(fold_in(key(seed),
    round), rank)`` as a [P, 2] tensor, draws [P, K, M], against
    ``jax.vmap`` over the shards."""
    P, shape = 8, (3, 40)
    for rnd in (0, 5):
        rkey = jax.random.fold_in(jax.random.PRNGKey(seed), rnd)
        keys = jax.vmap(lambda r: jax.random.fold_in(rkey, r))(
            jnp.arange(P))
        kmode, kslot = jax.vmap(jax.random.split, out_axes=1)(keys)
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
            kmode))
        ri = np.asarray(jax.vmap(
            lambda k: jax.random.randint(k, shape, 0, 3))(kslot))
        tkeys = round_keys(FaultPlan(delay=0.1, seed=seed), rnd, P, "cpu")
        np.testing.assert_array_equal(tkeys.numpy(),
                                      np.asarray(keys).astype(np.int64))
        tmode, tslot = prng.split(tkeys)
        np.testing.assert_array_equal(prng.uniform(tmode, shape).numpy(), u)
        np.testing.assert_array_equal(
            prng.randint(tslot, shape, 0, 3).numpy(), ri)


def test_threefry_known_answer():
    """The Threefry-2x32 known-answer vector of the Random123 suite (20
    rounds, key and counter all ones words)."""
    m = 0xFFFFFFFF
    assert prng.threefry2x32(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)
    assert prng.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)


def test_randint_rejects_a_span_past_16_bits():
    key = torch.tensor(prng.prng_key(0))
    with pytest.raises(ValueError, match="span"):
        prng.randint(key, (4,), 0, 1 << 16)
    with pytest.raises(ValueError, match="span"):
        prng.randint(key, (4,), 3, 3)


def _ordered(bits: np.ndarray) -> np.ndarray:
    """f32 bits as int32 -> ints whose differences count ulps."""
    b = bits.astype(np.int64)
    return np.where(b < 0, -(b & 0x7FFFFFFF), b)


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(_ordered(got.view(np.int32))
                  - _ordered(want.view(np.int32)))


@pytest.mark.parametrize("n", [1, 3, 7])
def test_split_into_n_matches_jax(n):
    for seed in (0, 11):
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.key(seed), n)))
        got = prng.split(prng.key(seed), n)
        assert got.shape == (n, 2) and got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert tuple(prng.key(5).tolist()) == _words(jax.random.key(5))


def test_normal_matches_jax():
    """2**16 draws of one key and a [3, 7, 11] draw of another: the
    uniforms ``normal`` takes equal JAX's bit for bit, the normals within
    4 ulp."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    for seed, shape in ((1, (1 << 16,)), (2, (3, 7, 11))):
        key = jax.random.split(jax.random.key(seed), 3)[1]
        tkey = prng.split(prng.key(seed), 3)[1]
        u = prng.uniform(tkey, shape, float(lo), 1.0).numpy()
        uj = np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=1.0))
        np.testing.assert_array_equal(u.view(np.int32), uj.view(np.int32))
        got = prng.normal(tkey, shape).numpy()
        want = np.asarray(jax.random.normal(key, shape))
        assert got.dtype == np.float32 and got.shape == want.shape
        assert _ulps(got, want).max() <= 4


def test_normal_edges_match_jax():
    """``erf_inv`` at the uniform's lowest value ``nextafter(-1, 0)`` (all
    23 drawn bits 0), at 0, near +1 and at +-1 (+-inf): within 4 ulp of
    ``jax.lax.erf_inv``, the infinities exact."""
    x = np.array([np.nextafter(np.float32(-1), np.float32(0)), 0.0, 0.5,
                  -0.25, np.nextafter(np.float32(1), np.float32(0)), 1.0,
                  -1.0], np.float32)
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isinf(got[-2:]).all() and np.array_equal(got[-2:], want[-2:])
    assert _ulps(got[:-2], want[:-2]).max() <= 4


def test_normal_in_slices_equals_whole_draw():
    key = prng.key(4)
    whole = prng.normal(key, (5, 1000)).reshape(-1)
    cuts = [0, 1, 999, 2500, 4096, 5000]
    parts = torch.cat([prng.normal(key, (b - a,), a)
                       for a, b in zip(cuts, cuts[1:])])
    assert torch.equal(whole.view(torch.int32), parts.view(torch.int32))
    bits = prng.random_bits(key, (5, 1000)).reshape(-1)
    assert torch.equal(prng.random_bits(key, (10,), 2495), bits[2495:2505])
    with pytest.raises(ValueError, match="2\\*\\*31"):
        prng.random_bits(key, (8,), (1 << 31) - 4)
