"""Threefry-2x32 draws equal to ``jax.random``'s, bit for bit.

The fault injector (``core/faults.py``) draws its regimes and delay slots
from a counter-based stream keyed by ``(seed, round, shard)``. The port
reproduces JAX's stream exactly, so that a faulted solve drops, delays and
duplicates the same messages as the reference and every fault counter
matches, not only the distances. The recipe is JAX's with
``jax_threefry_partitionable`` on (the default since jax 0.5):

- a key is two uint32 words; ``prng_key(seed)`` (ints) and ``key(seed)``
  (a tensor) are ``(0, seed)``;
- ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
- ``split(key, n)`` hashes the counters ``(0, 0)`` ... ``(0, n - 1)``: key
  ``i`` is the pair of output words of counter ``i``;
- ``random_bits(key, shape)`` hashes the row-major flat index of every
  element (high and low word) and xors the two output words; an
  ``offset`` starts the index past 0, so a large draw can be made in
  slices that equal the whole draw bit for bit;
- ``uniform`` puts the top 23 bits under the exponent of 1.0 and subtracts
  1.0; ``randint`` takes two such bit planes from ``split(key)`` and folds
  them into ``[lo, hi)``; ``normal`` is ``sqrt(2) * erf_inv(u)`` of a
  uniform on ``[nextafter(-1, 0), 1)``, with XLA's f32 ``erf_inv``.

The model weights (``models/params.py: materialize``) draw from ``split``
and ``normal``, so equal seeds give the reference's weights: the uniforms
bit for bit, the normals within a few ulp (``erf_inv`` says why).

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


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as a ``[2]`` int64 key tensor."""
    return torch.tensor(prng_key(seed), dtype=torch.int64, device=device)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in`` of a key pair of ints."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def _bits32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> int32 tensors of the same bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _words(bits: torch.Tensor) -> torch.Tensor:
    """int32 bits -> the uint32 words they hold, in int64."""
    return bits.to(torch.int64) & MASK


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)`` of a ``[..., 2]`` key tensor: ``[n, ...,
    2]``, key ``i`` first, so ``a, b = split(key)`` unpacks two keys of the
    batch's shape."""
    k = _bits32(key)
    x1 = torch.arange(n, dtype=torch.int32, device=key.device)
    o0, o1 = threefry2x32(k[..., :1], k[..., 1:], 0, x1)
    return torch.stack((_words(o0), _words(o1)), -1).movedim(-2, 0)


def random_bits(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """32 random bits a draw as int32, ``[..., *shape]`` for a ``[..., 2]``
    key tensor: the hash of each element's flat index plus ``offset``
    (below 2**31, so its high word is 0), words xored. Elements ``[o, o +
    m)`` of a whole draw's flat view are ``random_bits(key, (m,), o)``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if offset < 0 or offset + n >= 1 << 31:
        raise ValueError(f"a draw of words {offset}..{offset + n} is past "
                         f"2**31")
    k = _bits32(key).reshape(*key.shape[:-1], *(1,) * len(shape), 2)
    idx = torch.arange(offset, offset + n, dtype=torch.int32,
                       device=key.device)
    o0, o1 = threefry2x32(k[..., 0], k[..., 1], 0, idx.reshape(shape))
    return o0 ^ o1


def random_bits_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The 32 bits ``random_bits`` gives the elements at flat ``index``
    (int64, any shape, below 2**64) of a whole draw from one ``[2]`` key:
    the hash of each index's high and low word, words xored (a block of a
    tensor drawn by itself, as a shard of a weight is)."""
    k = _bits32(key)
    hi = _bits32(index >> 32)
    lo = _bits32(index & MASK)
    o0, o1 = threefry2x32(k[0], k[1], hi, lo)
    return o0 ^ o1


def _unit(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    bits = ((bits >> 9) & 0x7FFFFF) | 0x3F800000
    u = bits.view(torch.float32) - 1.0
    if (minval, maxval) == (0.0, 1.0):
        return u
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` in
    f32: a uniform on ``[0, 1)`` scaled to ``[minval, maxval)`` in f32 and
    clamped at ``minval`` from below, as JAX does. ``offset`` as in
    ``random_bits``."""
    return _unit(random_bits(key, shape, offset), minval, maxval)


# xla/hlo/builder/lib/math.cc: ErfInv32 (M. Giles, "Approximating the erfinv
# function"): Horner coefficients for w < 5 and for w >= 5
_ERF_INV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERF_INV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)
_NEXT_ABOVE_MINUS_1 = -0.99999994039535522   # nextafter(-1, 0) in f32
_SQRT2_F32 = 1.41421353816986084             # np.float32(np.sqrt(2))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of an f32 tensor, XLA's ``ErfInv32``
    (xla/hlo/builder/lib/math.cc; the same in StableHLO's CHLO
    decomposition): ``w = -log1p(-x*x)``, a nine-term Horner polynomial in
    ``w - 2.5`` (``w < 5``) or ``sqrt(w) - 3`` (else), times ``x``, and
    ``erf_inv(+-1) = +-inf``.

    XLA's CPU code fuses each Horner step into a fused multiply-add; each
    step here runs in f64 and rounds to f32, which is the same but for
    double rounding. ``log1p`` runs in f64 and rounds to f32, where XLA
    takes its own f32 polynomial, so the result is within a few ulp of
    JAX's (3 over 2**20 draws, 99% equal), not bit for bit; the card's
    and the CPU's are within a few ulp of each other too.
    ``torch.erfinv`` is another approximation (0.4 of the draws equal, up
    to 2e-5 apart) and is not used."""
    f32, f64 = torch.float32, torch.float64
    w = (-torch.log1p((-x * x).to(f64))).to(f32)
    lt = w < 5
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).to(f64)
    lt5 = torch.tensor(_ERF_INV_W_LT_5, dtype=f32, device=x.device)
    ge5 = torch.tensor(_ERF_INV_W_GE_5, dtype=f32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERF_INV_W_LT_5)):
        c = torch.where(lt, lt5[i], ge5[i])
        p = torch.addcmul(c.to(f64), p.to(f64), w).to(f32)
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def normal(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32: ``sqrt(2) * erf_inv(u)``
    of ``u = uniform(key, shape, nextafter(-1, 0), 1)``, the uniforms bit
    for bit, the normals within a few ulp (``erf_inv``). ``offset`` as in
    ``random_bits``."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_1, 1.0, offset)
    return erf_inv(u) * _SQRT2_F32


def normal_at(key: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The elements at flat ``index`` of ``normal(key, shape)`` (see
    ``random_bits_at``)."""
    u = _unit(random_bits_at(key, index), _NEXT_ABOVE_MINUS_1, 1.0)
    return erf_inv(u) * _SQRT2_F32


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
