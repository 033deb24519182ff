"""Threefry-2x32 draws equal to ``jax.random``'s, bit for bit.

The fault injector (``core/faults.py``) draws its regimes and delay slots
from a counter-based stream keyed by ``(seed, round, shard)``. The port
reproduces JAX's stream exactly, so that a faulted solve drops, delays and
duplicates the same messages as the reference and every fault counter
matches, not only the distances. The recipe is JAX's with
``jax_threefry_partitionable`` on (the default since jax 0.5):

- a key is two uint32 words; ``prng_key(seed)`` is ``(0, seed)``;
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
- ``split(key)`` hashes the counters ``(0, 0)`` and ``(0, 1)``: key ``i``
  is the pair of output words of counter ``i``;
- ``random_bits(key, shape)`` hashes the row-major flat index of every
  element (high and low word) and xors the two output words;
- ``uniform`` puts the top 23 bits under the exponent of 1.0 and subtracts
  1.0; ``randint`` takes two such bit planes from ``split(key)`` and folds
  them into ``[lo, hi)``.

The hash runs on Python ints, which the round loop uses to derive its
per-round keys on the host (``prng_key``, ``fold_in``), masked to 32 bits
after each add and shift; and on int32 tensors, which hold each uint32
word's bits: torch has no uint32 arithmetic, but int32 adds wrap as uint32
adds do, so only the right shifts need a mask. A key tensor is ``[..., 2]``
int64 holding the words, its leading dims batch over keys, and the draws
of ``uniform(keys, shape)`` are ``[..., *shape]``.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter words ``(x0, x1)``
    under the key ``(k1, k2)``: uint32 words as Python ints, or as the bits
    of broadcastable int32 tensors (then the result is int32 too)."""
    ints = not any(isinstance(v, torch.Tensor) for v in (k1, k2, x0, x1))

    def wrap(v):
        return v & MASK if ints else v

    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = wrap(x0 + ks[0])
    x1 = wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            # rotate left by r; the mask makes int32's arithmetic right
            # shift a logical one
            x1 = wrap((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as two words."""
    return 0, int(seed) & MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` of a key pair of ints."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def _bits32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> int32 tensors of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _words(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> the uint32 words they hold, in int64."""
    return bits.to(torch.int64) & MASK


def split(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)`` of a ``[..., 2]`` key tensor into two
    keys, each ``[..., 2]``."""
    k = _bits32(key)
    x1 = torch.arange(2, dtype=torch.int32, device=key.device)
    o0, o1 = (_words(o) for o in threefry2x32(k[..., :1], k[..., 1:], 0, x1))
    return (torch.stack((o0[..., 0], o1[..., 0]), -1),
            torch.stack((o0[..., 1], o1[..., 1]), -1))


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits a draw as int32, ``[..., *shape]`` for a ``[..., 2]``
    key tensor: the hash of each element's flat index (below 2**31, so its
    high word is 0), words xored."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 31:
        raise ValueError(f"a draw of {n} words is past 2**31")
    k = _bits32(key).reshape(*key.shape[:-1], *(1,) * len(shape), 2)
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], 0, idx.reshape(shape))
    return o0 ^ o1


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32, on ``[0, 1)``."""
    bits = ((random_bits(key, shape) >> 9) & 0x7FFFFF) | 0x3F800000
    return bits.view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32), for
    ``0 < maxval - minval < 2**16``: two bit planes folded as JAX folds
    them, ``((hi % n) * (2**32 % n) + lo % n) % n``."""
    span = maxval - minval
    if not 0 < span < 1 << 16:
        raise ValueError(f"randint span {span} outside (0, 2**16)")
    k1, k2 = split(key)
    mult = (((1 << 16) % span) ** 2) % span
    hi = _words(random_bits(k1, shape)) % span
    lo = _words(random_bits(k2, shape)) % span
    return ((hi * mult + lo) % span + minval).to(torch.int32)
