"""Plain PyTorch oracle for min-plus edge relaxation (the reference's
``kernels/relax/ref.py``).

new_dist[v] = min(dist[v], min_{(u,v,w) in E} dist[u] + w)
"""
from __future__ import annotations

from repro_torch.kernels.common import INF, scatter_min_drop, take_fill


def relax_ref(dist, src, dst, w):
    """dist: [n] f32; src/dst: [e] int (n = out-of-range sentinel: a
    sentinel src gathers +inf, a sentinel dst is dropped); w: [e] f32."""
    d_src = take_fill(dist, src, INF)
    return scatter_min_drop(dist, dst, d_src + w)
