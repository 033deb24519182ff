"""The schedule that kernels 10 (``relax_dst_tiled_masked``) and 11
(``relax_dst_tiled``) run on the card (``csrc/relax.cu:
relax_sweep_kernel``), emulated in plain PyTorch and held bit for bit
against their plain versions and the JAX package's Pallas kernels in
interpret mode.

The kernel is one Jacobi sweep over the layout's live chunks
(``live_chunks(w_t[None] < inf)``: the chunks holding a finite weight), in
two phases around one grid-wide barrier. Phase A: the groups of a
persistent grid take the live chunks in a strided order, each chunk's
candidates (edges of finite weight, in the frontier for kernel 10)
min-reduced into a slot of partial minima, kernel 10's relaxations
counted. Phase B: each tile is the min of its distances and the partial
minima of its range of the list; a tile with no live chunk keeps its
distances. Where a distance is -inf, phase B also walks every +inf-weight
edge (dead chunks included): -inf + inf is NaN in the plain version, so
its target becomes NaN. The emulation walks those steps with float minima
(NaN propagating, as the kernel's NaN key does) and must equal the plain
versions, which walk every chunk, whatever the groups' order; a list that
drops one live chunk must differ.
"""
import numpy as np
import pytest
from _torch_jax_ref import shared_jax_cache  # noqa: F401 (autouse)

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.graph as jg  # noqa: E402
import repro.kernels.relax as j_relax  # noqa: E402
from repro.graph.structure import graph_to_numpy  # noqa: E402
from repro_torch.kernels.common import live_chunks, take_fill  # noqa: E402
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_tiled_layout, relax_dst_tiled_masked_plain,
    relax_dst_tiled_plain)
from repro_torch.kernels.tile_reduce import tile_min_batch  # noqa: E402

INF = float("inf")


def sweep_live(dist, front, src_t, w_t, dstrel_t, pruned_t, chunks, *,
               vb: int, groups: int = 4):
    """Kernel 10 (``front`` given) or 11 (``front`` None) through the
    card's two phases over the live ``chunks`` (idx [1, n], bounds
    [1, n_vtiles + 1]); ``groups`` sets the order phase A takes the chunks
    in. Returns (dist [bp], relaxations [1] int32)."""
    n_vtiles, n_chunks, eb = src_t.shape
    idx, bounds = chunks[0][0].tolist(), chunks[1][0].tolist()
    n_live = bounds[-1]
    src_c, w_c, rel_c = (a.reshape(-1, eb) for a in (src_t, w_t, dstrel_t))
    prn_c = None if pruned_t is None else pruned_t.reshape(-1, eb)
    partial = torch.full((n_live, vb), INF)
    count = 0
    for j in (j for g in range(groups) for j in range(g, n_live, groups)):
        c = idx[j]
        w = w_c[c] if prn_c is None else torch.where(prn_c[c] > 0, INF,
                                                     w_c[c])
        src = src_c[c].long()
        take = w < INF                      # +inf-weight edges: no gather
        if front is not None:
            take &= front[src] > 0
            count += int(take.sum())
        cand = torch.where(take, dist[src] + w, INF)
        partial[j] = tile_min_batch(cand, rel_c[c], width=vb)
    out = dist.clone().reshape(n_vtiles, vb)
    neg = bool((dist == -INF).any())
    for t in range(n_vtiles):
        acc = out[t]
        for j in range(bounds[t], bounds[t + 1]):
            acc = torch.minimum(acc, partial[j])
        if neg:
            # every +inf-weight edge of the tile, dead chunks included
            w = w_t[t].reshape(-1)
            if pruned_t is not None:
                w = torch.where(pruned_t[t].reshape(-1) > 0, INF, w)
            src = src_t[t].reshape(-1).long()
            hit = (w == INF) & (dist[src] == -INF)
            if front is not None:
                hit &= front[src] > 0
            acc = acc.clone()
            acc[dstrel_t[t].reshape(-1)[hit].long()] = float("nan")
        out[t] = acc
    return out.reshape(-1), torch.tensor([count], dtype=torch.int32)


def _same(got, want):
    """Bit-equal, NaN in the same places (whatever its payload)."""
    got, want = (torch.from_numpy(np.array(a, np.float32))
                 for a in (got, want))
    assert got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


def _case(n, m, vb, eb, seed, *, negative=False, neg_inf=False):
    """tests/test_pallas_solver.py's state on a random graph (dist with 30%
    +inf, a 50% frontier, a 20% Trishla mask), the port's layout and the
    JAX package's. ``negative``: distances and weights of both signs;
    ``neg_inf``: also a few distances at -inf, the padding source's among
    them."""
    rng = np.random.default_rng(seed)
    src, dst, w = graph_to_numpy(jg.random_graph(n, m, seed=seed))
    if negative:
        w = rng.uniform(-20, 20, len(src)).astype(np.float32)
    return _state(rng, src, dst, w, n, vb, eb, negative, neg_inf)


def _state(rng, src, dst, w, n, vb, eb, negative=False, neg_inf=False):
    src_t, w_t, dr_t, eid_t, bp = build_dst_tiled_layout(
        src, dst, w, n, vb=vb, eb=eb, with_eid=True)
    dist = rng.uniform(-50 if negative else 0, 50, bp).astype(np.float32)
    dist[rng.random(bp) < 0.3] = np.inf
    if neg_inf:
        dist[rng.random(bp) < 0.05] = -np.inf
        dist[bp - 1] = -np.inf
    front = (rng.random(bp) < 0.5).astype(np.float32)
    pruned = rng.random(len(src)) < 0.2
    pr_t = take_fill(torch.from_numpy(pruned).to(torch.int32),
                     eid_t.reshape(-1), 0).reshape(eid_t.shape)
    j_lay = j_relax.build_dst_tiled_layout(src, dst, w, n, vb=vb, eb=eb,
                                           with_eid=True)
    j_pr = jnp.take(jnp.asarray(pruned, jnp.int32), j_lay[3], mode="fill",
                    fill_value=0)
    lay = (src_t, w_t, dr_t, pr_t)
    return (torch.from_numpy(dist), torch.from_numpy(front), lay,
            (*j_lay[:3], j_pr), live_chunks(w_t[None] < INF))


def _hub_case(seed=11):
    """600 vertices in tiles of 128, chunks of 64 edges: tile 1 takes 900
    edges into one hub and more (19 chunks, every one live), tile 2 no edge
    at all (a tile with no live chunk), tile 3 the edges of sources 500-599
    only, which the frontier leaves out (a live chunk whose sources are all
    outside it), the rest random."""
    rng = np.random.default_rng(seed)
    n = 600
    src = np.r_[rng.integers(0, 500, 900), rng.integers(500, 600, 100),
                rng.integers(0, n, 700)]
    dst = np.r_[np.full(900, 130), rng.integers(384, 512, 100),
                rng.choice(np.r_[0:256, 512:600], 700)]
    w = rng.uniform(1, 20, len(src)).astype(np.float32)
    out = _state(rng, src, dst, w, n, 128, 64)
    out[1][500:] = 0.0                      # sources 500-599 not in it
    return out


CASES = {
    "kernels-100": lambda: _case(100, 400, 128, 128, 0),
    "kernels-500": lambda: _case(500, 3000, 128, 256, 1),
    "kernels-257": lambda: _case(257, 900, 128, 512, 2),
    "kernels-64": lambda: _case(64, 80, 128, 128, 3),
    "negative": lambda: _case(200, 900, 64, 128, 5, negative=True),
    "neg-inf": lambda: _case(200, 900, 64, 128, 6, negative=True,
                             neg_inf=True),
    "hub": _hub_case,
}


@pytest.mark.parametrize("groups", [1, 4, 13])
@pytest.mark.parametrize("case", sorted(CASES))
def test_live_sweep_equals_plain_and_jax(case, groups):
    """Kernels 11 and 10 through the card's two phases over the live chunks
    equal their plain versions (which walk every chunk) and the JAX
    package's Pallas kernels in interpret mode: distances bit for bit (NaN
    where the plain version adds -inf and +inf) and kernel 10's count,
    whatever the order the groups take the chunks in."""
    dist, front, lay, j_lay, chunks = CASES[case]()
    vb = dist.shape[0] // lay[0].shape[0]
    eb = lay[0].shape[-1]
    got11, _ = sweep_live(dist, None, *lay[:3], None, chunks, vb=vb,
                          groups=groups)
    want11 = relax_dst_tiled_plain(dist, *lay[:3], vb=vb)
    _same(got11, want11)
    _same(want11, j_relax.relax_pallas(jnp.asarray(dist.numpy()),
                                       *j_lay[:3], vb=vb, eb=eb,
                                       interpret=True))
    got10 = sweep_live(dist, front, *lay, chunks, vb=vb, groups=groups)
    want10 = relax_dst_tiled_masked_plain(dist, front, *lay, vb=vb)
    j10 = j_relax.relax_masked_pallas(
        jnp.asarray(dist.numpy()), jnp.asarray(front.numpy()), *j_lay,
        vb=vb, eb=eb, interpret=True)
    _same(got10[0], want10[0])
    _same(want10[0], j10[0])
    assert int(got10[1]) == int(want10[1]) == int(j10[1])
    if case == "neg-inf":
        assert bool(torch.isnan(want11).any())
        assert bool(torch.isnan(want10[0]).any())


def test_hub_case_premise():
    """The hub case has what it claims: a tile of 15 or more live chunks, a
    tile
    with none, a dead chunk, and a live chunk whose sources are all outside
    the frontier."""
    dist, front, lay, _, (idx, bounds) = _hub_case()
    per_tile = bounds[0].diff().tolist()
    assert per_tile[1] >= 15 and per_tile[2] == 0
    assert bounds[0, -1] < idx.shape[1]          # some chunk is dead
    src_t, w_t = lay[0], lay[1]
    tile3 = [c for c in idx[0, :bounds[0, -1]].tolist()
             if c // src_t.shape[1] == 3]
    assert tile3
    for c in tile3:
        s = src_t.reshape(-1, src_t.shape[-1])[c]
        live = w_t.reshape(-1, w_t.shape[-1])[c] < INF
        assert not bool((front[s.long()][live] > 0).any())


@pytest.mark.parametrize("case", ["kernels-500", "hub"])
def test_dropping_a_live_chunk_differs(case):
    """The planted fault: a list that drops one live chunk (the first of
    the heaviest tile) gives another result than the plain version."""
    dist, front, lay, _, (idx, bounds) = CASES[case]()
    vb = dist.shape[0] // lay[0].shape[0]
    t = int(bounds[0].diff().argmax())
    lo = int(bounds[0, t])
    bad_idx = torch.cat([idx[:, :lo], idx[:, lo + 1:], idx[:, lo:lo + 1]], 1)
    bad_bounds = bounds.clone()
    bad_bounds[0, t + 1:] -= 1
    got = sweep_live(dist, front, *lay, (bad_idx, bad_bounds), vb=vb)
    want = relax_dst_tiled_masked_plain(dist, front, *lay, vb=vb)
    got11 = sweep_live(dist, None, *lay[:3], None, (bad_idx, bad_bounds),
                       vb=vb)[0]
    assert not torch.equal(got11, relax_dst_tiled_plain(dist, *lay[:3],
                                                        vb=vb))
    assert not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1]))
