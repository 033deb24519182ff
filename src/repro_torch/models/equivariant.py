"""Real spherical harmonics and Clebsch-Gordan tables for MACE (the
reference's ``models/equivariant.py``).

Supports l <= L_MAX (default 2). The CG coefficients are built on the host
in numpy, by the reference's own code (complex CG via the Racah formula,
moved to the real basis with the standard complex->real unitary U_l, a
global phase rotated away), so the tables equal the reference's bit for
bit. What the model runs is a dense einsum against these tables.
"""
from __future__ import annotations

import math
from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch

L_MAX = 2


def _cg_complex(j1, j2, j3, m1, m2, m3):
    """Clebsch-Gordan <j1 m1 j2 m2 | j3 m3> (Racah formula)."""
    if m3 != m1 + m2:
        return 0.0
    if not (abs(j1 - j2) <= j3 <= j1 + j2):
        return 0.0
    f = factorial
    pre = sqrt((2 * j3 + 1) * f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
               / f(j1 + j2 + j3 + 1))
    pre *= sqrt(f(j3 + m3) * f(j3 - m3) * f(j1 - m1) * f(j1 + m1)
                * f(j2 - m2) * f(j2 + m2))
    s = 0.0
    for k in range(0, j1 + j2 - j3 + 1):
        denoms = [k, j1 + j2 - j3 - k, j1 - m1 - k, j2 + m2 - k,
                  j3 - j2 + m1 + k, j3 - j1 - m2 + k]
        if any(d < 0 for d in denoms):
            continue
        s += (-1) ** k / np.prod([float(f(d)) for d in denoms])
    return pre * s


def _real_to_complex_u(l):
    """U[m_complex, m_real] with real-SH convention (m<0 sin, m>0 cos)."""
    dim = 2 * l + 1
    U = np.zeros((dim, dim), complex)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            U[i, m + l] = 1j / sqrt(2)
            U[i, -m + l] = -1j / sqrt(2) * (-1) ** m
        elif m == 0:
            U[i, l] = 1.0
        else:
            U[i, -m + l] = 1 / sqrt(2)
            U[i, m + l] = 1 / sqrt(2) * (-1) ** m
    return U


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling coefficients C[m1, m2, m3] as float32 (the
    imaginary parts cancel for an allowed (l1, l2, l3) once the global
    phase is rotated away)."""
    Cc = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1), complex)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if -l3 <= m3 <= l3:
                Cc[m1 + l1, m2 + l2, m3 + l3] = _cg_complex(l1, l2, l3, m1, m2, m3)
    U1 = _real_to_complex_u(l1)
    U2 = _real_to_complex_u(l2)
    U3 = _real_to_complex_u(l3)
    out = np.einsum("abc,ax,by,cz->xyz", Cc, U1, U2, np.conj(U3))
    # a global phase may remain; rotate it away and keep the real part
    mag = np.abs(out).max()
    if mag > 1e-12:
        phase = out.flat[np.argmax(np.abs(out))]
        out = out * np.conj(phase / abs(phase))
    C = np.real(out)
    return C.astype(np.float32)


def spherical_harmonics(vec: torch.Tensor, eps: float = 1e-9) -> dict:
    """Real SH l=0..2 of unit(vec). vec: [..., 3]. Returns {l: [..., 2l+1]}.

    Normalization: Racah (Y_00 = 1), consistent across l for CG coupling."""
    r = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + eps)
    u = vec / r
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    y0 = torch.ones_like(x)[..., None]
    y1 = torch.stack([y, z, x], dim=-1)  # (m=-1, 0, 1) real convention
    s3 = sqrt(3.0)
    y2 = torch.stack([
        s3 * x * y,
        s3 * y * z,
        0.5 * (3 * z * z - 1.0),
        s3 * x * z,
        0.5 * s3 * (x * x - y * y),
    ], dim=-1)
    return {0: y0, 1: y1, 2: y2}


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Bessel radial basis with polynomial cutoff (MACE/NequIP standard)."""
    r = r[..., None]
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    rb = (math.sqrt(2.0 / r_cut) * torch.sin(n * math.pi * r / r_cut)
          / (r + 1e-9))
    x = torch.clamp(r / r_cut, 0.0, 1.0)
    p = 6  # polynomial cutoff order
    fcut = 1 - ((p + 1) * (p + 2) / 2) * x**p + p * (p + 2) * x**(p + 1) \
        - (p * (p + 1) / 2) * x**(p + 2)
    return rb * fcut
