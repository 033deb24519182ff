"""Plain PyTorch oracle for min-plus edge relaxation (the reference's
``kernels/relax/ref.py``).

new_dist[v] = min(dist[v], min_{(u,v,w) in E} dist[u] + w)
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import INF, scatter_min_drop, take_fill


def _wrap(idx, n: int):
    """NumPy-style indices, as ``jnp.take(mode="fill")`` and
    ``.at[].min(mode="drop")`` read them: [-n, 0) wraps to idx + n, and
    anything below -n becomes the out-of-range sentinel n."""
    idx = idx.long()
    return torch.where(idx < 0, torch.where(idx >= -n, idx + n, n), idx)


def relax_ref(dist, src, dst, w):
    """dist: [n] f32; src/dst: [e] int (an index in [-n, 0) wraps; one
    outside [-n, n), the sentinel n in particular, is out of range: such a
    src gathers +inf, such a dst is dropped); w: [e] f32."""
    n = dist.shape[-1]
    d_src = take_fill(dist, _wrap(src, n), INF)
    return scatter_min_drop(dist, _wrap(dst, n), d_src + w)
