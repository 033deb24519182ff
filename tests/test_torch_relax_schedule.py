"""The schedule of the ragged sweep chain that kernels 2 and 8 run on the
card (``csrc/sweeps_ragged.cuh``), emulated in plain PyTorch and held bit
for bit against the plain version of kernel 2.

The CUDA chain issues the distance gathers of chunk c + d beside chunk c's
reads, from the row in device memory; a run of chunks of one vertex tile
keeps that tile's live values in a shared-memory window slot and writes
them back to the row once, at the run's end. At use time a source whose
tile holds a window slot is read from the slot (the hazard re-read),
every other source from its early gather. The emulation below walks the
same intervals around the kernel's two barriers a chunk, with the frontier
and the improved set as boolean masks (the kernel's bitmasks), so a fault
in the window's size or its eviction order, or a missing hazard re-read,
shows here on the CPU. The planted fault, hazard sources read at issue
time, must differ on a path inside one tile.

The merge and send stages of kernel 8 walk each tile's chunk range
``chunk_bounds(ctile)``; those ranges are held against a numpy reference,
empty tiles and sentinel padding chunks included.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.kernels.common import chunk_bounds  # noqa: E402
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_ragged_layout, fixpoint_operands,
    relax_dst_ragged_fixpoint_batch, relax_dst_ragged_fixpoint_batch_plain)

INF = float("inf")
VB, EB = 32, 64


def _runs(tiles):
    """Run index of each chunk: a run is a maximal stretch of chunks of one
    tile (ctile does not decrease, so a tile has at most one run)."""
    runs, r = [], -1
    for c, t in enumerate(tiles):
        r += c == 0 or t != tiles[c - 1]
        runs.append(r)
    return runs


def _emulate_row(dist, front, ct, src, w, rel, prn, *, vb, n_sweeps, d,
                 hazard):
    """One (shard, query) row through the kernel's schedule with look-ahead
    ``d``. Returns (row, residual frontier f32 0/1, relaxations)."""
    bp = dist.shape[0]
    rows = ct.shape[0]
    tiles = ct.long().clamp(max=bp // vb - 1).tolist()
    runs = _runs(tiles)
    n_slots = 4 * d                          # the window: 4d runs
    glob = dist.clone()                      # the row in device memory
    fr = front > 0                           # frontier bitmask
    imp = torch.zeros(bp, dtype=torch.bool)  # improved in this sweep
    wv = torch.where(prn > 0, INF, w)
    lanes = torch.arange(vb)
    count = 0
    for s in range(n_sweeps):
        if s > 0:                            # the next frontier
            fr, imp = imp, torch.zeros_like(imp)
        if not bool(fr.any()):
            break                            # the per-row early-out
        win = torch.zeros(n_slots, vb)
        tag = [-1] * n_slots
        slot = torch.full((bp // vb,), -1, dtype=torch.long)
        staged, mins = {}, {}

        def opens(c):
            return c == 0 or runs[c] != runs[c - 1]

        def evict(c):                        # thread 0, before the barrier
            if opens(c):
                k = runs[c] % n_slots
                if tag[k] >= 0:
                    slot[tag[k]] = -1
                tag[k] = tiles[c]

        def issue(c):                        # after the barrier
            if opens(c):
                win[runs[c] % n_slots] = glob[tiles[c] * vb + lanes]
            staged[c] = glob[src[c].long()]

        def gather(c):
            nonlocal count
            sv = src[c].long()
            # every tile written since chunk c's gathers were issued holds
            # a published window slot (the window's size argument)
            for t in set(tiles[max(c - d, 0):c + 1]):
                assert int(slot[t]) >= 0
            f = fr[sv]
            count += int((f & (wv[c] < INF)).sum())
            val = staged.pop(c)
            if hazard:
                sl = slot[sv // vb]
                val = torch.where(sl >= 0, win[sl.clamp(min=0), sv % vb], val)
            cand = torch.where(f, val + wv[c], INF)
            mins[c] = torch.full((vb,), INF).scatter_reduce(
                0, rel[c].long(), cand, "amin")

        def write(c):
            k, t = runs[c] % n_slots, tiles[c]
            m = mins.pop(c)
            imp[t * vb + lanes] |= m < win[k]
            win[k] = torch.minimum(win[k], m)
            if c == rows - 1 or runs[c + 1] != runs[c]:
                glob[t * vb + lanes] = win[k]     # the run's write-back

        for c in range(min(d, rows)):             # the sweep's prologue
            evict(c)
            issue(c)
        for c in range(rows):
            # before the first barrier of chunk c: chunk c - 1's writes, the
            # publication of c's run, the eviction for c + d's run
            if c > 0:
                write(c - 1)
            if opens(c):
                slot[tiles[c]] = runs[c] % n_slots
            if c + d < rows:
                evict(c + d)
            # between the barriers: the early gathers of c + d, then chunk
            # c's reads
            if c + d < rows:
                issue(c + d)
            gather(c)
        write(rows - 1)                           # the pipeline drains
    return glob, imp.float(), count


def emulate(dist, front, ctile, src, w, rel, prn, *, vb, n_sweeps, d,
            hazard=True):
    """The kernel's schedule for every (shard, query) row; the plain
    version's returns."""
    P, K, _ = dist.shape
    out, resid = torch.empty_like(dist), torch.empty_like(dist)
    nrel = torch.zeros((P, K), dtype=torch.int32)
    for p in range(P):
        for q in range(K):
            out[p, q], resid[p, q], nrel[p, q] = _emulate_row(
                dist[p, q], front[p, q], ctile[p], src[p], w[p], rel[p],
                prn[p], vb=vb, n_sweeps=n_sweeps, d=d, hazard=hazard)
    return out, resid, nrel


def _stack_ragged(lays, fills):
    """Per-shard ragged planes padded to the longest shard with ``fills``
    (sentinel padding chunks) and stacked [P, ...]."""
    n = max(lay[0].shape[0] for lay in lays)
    return [torch.stack([torch.nn.functional.pad(
        lay[k], (0, 0) * (lay[k].dim() - 1) + (0, n - lay[k].shape[0]),
        value=fill) for lay in lays]) for k, fill in enumerate(fills)]


def _path_layout():
    """Two shards of 128 vertices, chunks of 4 edges. Shard 0: a path 0 ->
    1 -> ... -> 30 inside vertex tile 0, each hop four times (duplicate
    edges, one of weight 0), so each hop fills a chunk of its own and the
    path relaxes end to end in one reference sweep; self loops and random
    edges (a fifth of weight 0) into tiles 1 and 3, none into tile 2.
    Shard 1: a few edges, stacked with sentinel padding chunks."""
    rng = np.random.default_rng(3)
    n, eb = 128, 4
    hop = np.repeat(np.arange(30), 4)
    rand = rng.choice(np.r_[32:64, 96:128], 150)
    w_hop = np.tile([1.0, 1.0, 0.0, 2.0], 30)
    w_rand = rng.uniform(1, 20, 150)
    w_rand[:30] = 0.0
    lays = [build_dst_ragged_layout(
        np.concatenate([hop, np.arange(40, 50), rng.integers(0, n, 150)]),
        np.concatenate([hop + 1, np.arange(40, 50), rand]),
        np.concatenate([w_hop, rng.uniform(0, 3, 10), w_rand]).astype(
            np.float32), n, vb=VB, eb=eb, with_eid=True)]
    lays.append(build_dst_ragged_layout(
        rng.integers(0, n, 12), rng.integers(0, n, 12),
        rng.uniform(1, 9, 12).astype(np.float32), n, vb=VB, eb=eb,
        with_eid=True))
    bp = lays[0][5]
    src, w, rel, eid, ctile = _stack_ragged(
        lays, (bp - 1, INF, 0, 10 ** 6, bp // VB))
    assert ctile[1, -1] == bp // VB          # sentinel padding chunks
    return (ctile, src, w, rel, eid), bp, int(eid[eid < 10 ** 6].max()) + 1


def _shard_layout(g):
    sh = tc.build_shards(g, 2, layout="ragged", relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    src, w, rel, eid, ctile = sh.relax_layout
    return (ctile, src, w, rel, eid), -(-sh.block // VB) * VB, sh.e_loc


@functools.lru_cache(maxsize=None)
def _layout(graph):
    if graph == "rmat":
        return _shard_layout(tg.rmat_graph(scale=8, edge_factor=6, seed=5))
    if graph == "road":
        return _shard_layout(tg.road_grid_graph(side=16, seed=2))
    return _path_layout()


def _operands(graph, K, seed=0):
    """The kernel's operands: row 0 of each shard holds 10 v at local
    vertices v < 31, all in the frontier, +inf elsewhere (on the path
    layout each hop then improves a frontier vertex that a later chunk of
    the same sweep reads); rows 1.. are random mid-solve states (30% +inf, a frontier on
    30% of the finite entries); 20% of the edges Trishla-pruned (none on
    the path layout, so that the path relaxes)."""
    (ctile, src, w, rel, eid), bp, e_loc = _layout(graph)
    rng = np.random.default_rng(seed)
    P = ctile.shape[0]
    dist = rng.uniform(0, 50, (P, K, bp)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = np.inf
    front = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    dist[:, 0] = np.inf
    dist[:, 0, :31] = 10.0 * np.arange(31)
    front[:, 0] = False
    front[:, 0, :31] = True
    pruned = rng.random((P, e_loc)) < (0.0 if graph == "path" else 0.2)
    d, f, prn = fixpoint_operands(torch.from_numpy(dist),
                                  torch.from_numpy(front),
                                  torch.from_numpy(pruned), eid, bp)
    return (d, f, ctile, src, w, rel, prn)


@pytest.mark.parametrize("n_sweeps", [1, 4, 8])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("graph", ["rmat", "road", "path"])
def test_schedule_equals_plain(graph, d, K, n_sweeps):
    args = _operands(graph, K)
    want = relax_dst_ragged_fixpoint_batch_plain(*args, vb=VB,
                                                 n_sweeps=n_sweeps)
    got = emulate(*args, vb=VB, n_sweeps=n_sweeps, d=d)
    assert int(want[2].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # the CPU wrapper is the plain version
    for g, w in zip(relax_dst_ragged_fixpoint_batch(
            *args, vb=VB, n_sweeps=n_sweeps), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_sweeps", [1, 4, 8])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_planted_fault_no_hazard_reread_is_caught(d, K, n_sweeps):
    """Hazard sources read at issue time: the path inside tile 0 then sees
    its own tile's improvements only after the run's write-back, so some
    output differs from the plain version."""
    args = _operands("path", K)
    want = relax_dst_ragged_fixpoint_batch_plain(*args, vb=VB,
                                                 n_sweeps=n_sweeps)
    got = emulate(*args, vb=VB, n_sweeps=n_sweeps, d=d, hazard=False)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


def test_path_layout_has_a_path_inside_one_tile():
    """The planted-fault case's premise: tile 0 of shard 0 holds the path's
    hops only, hop k alone in the k-th chunk, and tile 2 has no chunk."""
    (ctile, src, w, rel, _), bp, _ = _layout("path")
    ct = ctile[0].numpy()
    c0 = np.nonzero(ct == 0)[0]
    assert len(c0) == 30 and 2 not in ct
    for k, c in enumerate(c0):
        assert src[0, c].tolist() == [k] * 4 and rel[0, c].tolist() == [
            k + 1] * 4


def _bounds_numpy(ct, n_tiles):
    """Tile i owns the chunks with ctile == i: [#(ctile < i), #(ctile <= i))."""
    ct = np.asarray(ct)
    return np.array([[int((row < i).sum()) for i in range(n_tiles + 1)]
                     for row in ct], np.int32)


@pytest.mark.parametrize("graph", ["rmat", "road"])
def test_round_tile_ranges_match_numpy(graph):
    """The merge and send chunk ranges kernel 8 walks: the shards' cached
    ``merge_bounds`` / ``send_bounds`` and ``chunk_bounds`` against a numpy
    reference; every chunk of a tile lies in its range."""
    g = (tg.rmat_graph(scale=8, edge_factor=6, seed=5) if graph == "rmat"
         else tg.road_grid_graph(side=16, seed=2))
    sh = tc.build_shards(g, 3, layout="ragged", relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    n_vt = -(-sh.block // VB)
    for ct, n_tiles, got in ((sh.mx_ctile, n_vt, sh.merge_bounds),
                             (sh.tx_ctile, sh.n_stiles, sh.send_bounds)):
        want = _bounds_numpy(ct, n_tiles)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(chunk_bounds(ct, n_tiles).numpy(), want)
        for p in range(ct.shape[0]):
            for i in range(n_tiles):
                assert (ct[p, want[p, i]:want[p, i + 1]] == i).all()


def test_tile_ranges_empty_tiles_and_padding():
    """Empty tiles get empty ranges at the right place; sentinel padding
    chunks (ctile == n_tiles) lie past the last range."""
    ct = torch.tensor([[0, 0, 2, 2, 2, 5, 6, 6],
                       [1, 3, 3, 6, 7, 7, 7, 7],
                       [7, 7, 7, 7, 7, 7, 7, 7]], dtype=torch.int32)
    got = chunk_bounds(ct, 7).numpy()
    np.testing.assert_array_equal(got, _bounds_numpy(ct, 7))
    np.testing.assert_array_equal(got[0], [0, 2, 2, 5, 5, 5, 6, 8])
    np.testing.assert_array_equal(got[1], [0, 0, 1, 1, 3, 3, 3, 4])
    np.testing.assert_array_equal(got[2], [0] * 8)
