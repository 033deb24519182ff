"""The port's threefry draws (``repro_torch.core.prng``) against
``jax.random``, bit for bit: the key, ``fold_in``, ``split``, ``uniform``
and ``randint``, on int keys and on batched key tensors, and the
``[P, K, M]`` draws of the fault injector against ``jax.vmap``.

The port reproduces JAX's partitionable threefry only; the first test
fails loudly if a JAX release changes that default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
