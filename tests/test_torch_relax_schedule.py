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

Kernels 1, 9 and 7 run the same chain over the dense layout's live chunks
(``live_chunks``: the chunks holding a finite weight, in layout order, tile
c // n_chunks). The emulation walks those chunks and is held bit for bit
against the plain versions of kernels 1 and 9 (which walk every chunk) and
against the JAX package's kernels 1 and 9 in interpret mode (kernel 1 on
one and four shards, its planted fault differing on a path); the dense
staged solver and the fused round's rescue are checked to hand kernel 1
the shards' own list (``SsspShards.round_chunks[1]``); kernel 7's merge and
send, warp by tile over each tile's live chunks, are emulated beside it and
held against ``fused_round_tiled_plain`` and the JAX package's fused round
in interpret mode. The live-chunk lists are held against numpy: a tile with
no edge, a tile all live, a dead chunk in the middle of a tile. Only the
comparisons with the JAX package import it, so the rest runs without JAX.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch.core as tc  # noqa: E402
import repro_torch.graph as tg  # noqa: E402
from repro_torch.kernels.common import (  # noqa: E402
    chunk_bounds, live_chunks, take_fill)
from repro_torch.kernels.relax import (  # noqa: E402
    build_dst_ragged_layout, build_dst_tiled_layout, fixpoint_operands,
    relax_dst_ragged_fixpoint_batch, relax_dst_ragged_fixpoint_batch_plain,
    relax_dst_tiled_fixpoint_batch, relax_dst_tiled_fixpoint_batch_plain,
    relax_dst_tiled_fixpoint_plain)
from repro_torch.kernels.round import (  # noqa: E402
    fused_round_operands, fused_round_tiled_plain)

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
    if rows == 0:                # no live chunk: the kernel's row is inactive
        return dist.clone(), torch.zeros_like(dist), 0
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


def emulate_live(dist, front, idx, bounds, src_t, w_t, rel_t, prn_t, *, vb,
                 n_sweeps, d, hazard=True):
    """Kernels 9 and 7's relax stage: the kernel's schedule for every
    (shard, query) row over the shard's live chunks ``idx[p, :bounds[p,
    -1]]`` of the dense layout [P, n_vtiles, n_chunks, EB], chunk c in tile
    c // n_chunks; the plain version's returns."""
    P, K, _ = dist.shape
    n_chunks, eb = src_t.shape[2:]
    out, resid = torch.empty_like(dist), torch.empty_like(dist)
    nrel = torch.zeros((P, K), dtype=torch.int32)
    for p in range(P):
        c = idx[p, :int(bounds[p, -1])].long()
        rows = [a[p].reshape(-1, eb)[c] for a in (src_t, w_t, rel_t, prn_t)]
        for q in range(K):
            out[p, q], resid[p, q], nrel[p, q] = _emulate_row(
                dist[p, q], front[p, q], c // n_chunks, *rows, vb=vb,
                n_sweeps=n_sweeps, d=d, hazard=hazard)
    return out, resid, nrel


def _stack_ragged(lays, fills):
    """Per-shard ragged planes padded to the longest shard with ``fills``
    (sentinel padding chunks) and stacked [P, ...]."""
    n = max(lay[0].shape[0] for lay in lays)
    return [torch.stack([torch.nn.functional.pad(
        lay[k], (0, 0) * (lay[k].dim() - 1) + (0, n - lay[k].shape[0]),
        value=fill) for lay in lays]) for k, fill in enumerate(fills)]


def _path_edges():
    """Two shards of 128 vertices. Shard 0: a path 0 -> 1 -> ... -> 30
    inside vertex tile 0, each hop four times (duplicate edges, one of
    weight 0), so that with chunks of 4 edges each hop fills a chunk of its
    own and the path relaxes end to end in one reference sweep; self loops
    and random edges (a fifth of weight 0) into tiles 1 and 3, none into
    tile 2. Shard 1: a few edges. Returns (n, [(src, dst, w)] a shard)."""
    rng = np.random.default_rng(3)
    n = 128
    hop = np.repeat(np.arange(30), 4)
    rand = rng.choice(np.r_[32:64, 96:128], 150)
    w_hop = np.tile([1.0, 1.0, 0.0, 2.0], 30)
    w_rand = rng.uniform(1, 20, 150)
    w_rand[:30] = 0.0
    src0 = np.concatenate([hop, np.arange(40, 50), rng.integers(0, n, 150)])
    dst0 = np.concatenate([hop + 1, np.arange(40, 50), rand])
    w0 = np.concatenate([w_hop, rng.uniform(0, 3, 10), w_rand]).astype(
        np.float32)
    src1, dst1 = rng.integers(0, n, 12), rng.integers(0, n, 12)
    w1 = rng.uniform(1, 9, 12).astype(np.float32)
    return n, [(src0, dst0, w0), (src1, dst1, w1)]


def _path_layout():
    """The path shards in the ragged layout (chunks of 4 edges), shard 1
    stacked with sentinel padding chunks."""
    n, edges = _path_edges()
    lays = [build_dst_ragged_layout(*e, n, vb=VB, eb=4, with_eid=True)
            for e in edges]
    bp = lays[0][5]
    src, w, rel, eid, ctile = _stack_ragged(
        lays, (bp - 1, INF, 0, 10 ** 6, bp // VB))
    assert ctile[1, -1] == bp // VB          # sentinel padding chunks
    return (ctile, src, w, rel, eid), bp, int(eid[eid < 10 ** 6].max()) + 1


def _dense_path_layout():
    """The path shards in the dense layout (chunks of 4 edges), with a dead
    chunk (all +inf, as a real edge of weight +inf leaves one) inserted
    after the tenth chunk of every tile, so tile 0's path runs across it;
    tiles padded to the most chunks of either shard, eids of padding at the
    sentinel 10**6."""
    n, edges = _path_edges()
    lays = [build_dst_tiled_layout(*e, n, vb=VB, eb=4, with_eid=True)
            for e in edges]
    bp = lays[0][4]
    fills = (bp - 1, INF, 0, 10 ** 6)
    n_chunks = max(lay[0].shape[1] for lay in lays) + 1
    planes = []
    for k, fill in enumerate(fills):
        per = []
        for lay in lays:
            a = lay[k]
            dead = torch.full((a.shape[0], 1, a.shape[2]), fill,
                              dtype=a.dtype)
            a = torch.cat([a[:, :10], dead, a[:, 10:]], 1)
            pad = torch.full((a.shape[0], n_chunks - a.shape[1], a.shape[2]),
                             fill, dtype=a.dtype)
            per.append(torch.cat([a, pad], 1))
        planes.append(torch.stack(per))
    src, w, rel, eid = planes
    eid = torch.where(torch.isinf(w), 10 ** 6, eid)
    return (src, w, rel, eid), bp, int(eid[eid < 10 ** 6].max()) + 1


def _shard_layout(g, layout):
    sh = tc.build_shards(g, 2, layout=layout, relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    if layout == "dense":
        return sh.relax_layout, sh.rx_src.shape[1] * VB, sh.e_loc
    src, w, rel, eid, ctile = sh.relax_layout
    return (ctile, src, w, rel, eid), -(-sh.block // VB) * VB, sh.e_loc


@functools.lru_cache(maxsize=None)
def _layout(graph):
    """The relax layout of ``graph``: "rmat", "road" or "path", ragged
    ((ctile, src, w, rel, eid)), or with "-dense" the dense one ((src, w,
    rel, eid), [P, n_vtiles, n_chunks, EB])."""
    name, _, dense = graph.partition("-")
    layout = "dense" if dense else "ragged"
    if name == "rmat":
        return _shard_layout(tg.rmat_graph(scale=8, edge_factor=6, seed=5),
                             layout)
    if name == "road":
        return _shard_layout(tg.road_grid_graph(side=16, seed=2), layout)
    return _dense_path_layout() if dense else _path_layout()


def _operands(graph, K, seed=0):
    """The kernel's operands: row 0 of each shard holds 10 v at local
    vertices v < 31, all in the frontier, +inf elsewhere (on the path
    layout each hop then improves a frontier vertex that a later chunk of
    the same sweep reads); rows 1.. are random mid-solve states (30% +inf,
    a frontier on 30% of the finite entries); 20% of the edges
    Trishla-pruned (none on the path layout, so that the path relaxes).
    Ragged: (dist, front, ctile, src, w, rel, pruned); dense: (dist, front,
    src, w, rel, pruned)."""
    lay, bp, e_loc = _layout(graph)
    eid = lay[-1]
    rng = np.random.default_rng(seed)
    P = eid.shape[0]
    dist = rng.uniform(0, 50, (P, K, bp)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = np.inf
    front = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    dist[:, 0] = np.inf
    dist[:, 0, :31] = 10.0 * np.arange(31)
    front[:, 0] = False
    front[:, 0, :31] = True
    pruned = rng.random((P, e_loc)) < (0.0 if graph.startswith("path")
                                       else 0.2)
    d, f, prn = fixpoint_operands(torch.from_numpy(dist),
                                  torch.from_numpy(front),
                                  torch.from_numpy(pruned), eid, bp)
    return (d, f, *lay[:-1], prn)


def _emulate_dense(args, **kw):
    """``emulate_live`` on dense operands (dist, front, src, w, rel,
    pruned), over the live chunks of ``w``."""
    return emulate_live(*args[:2], *live_chunks(args[3] < INF), *args[2:],
                        **kw)


@pytest.mark.parametrize("n_sweeps", [1, 4, 8])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("graph", ["rmat", "road", "path", "rmat-dense",
                                   "road-dense", "path-dense"])
def test_schedule_equals_plain(graph, d, K, n_sweeps):
    """The chain's schedule bit-equal to the plain version: kernel 2's over
    the ragged layout, kernels 9 and 7's over the dense layout's live
    chunks (against kernel 1's plain version, which walks every chunk)."""
    args = _operands(graph, K)
    kw = dict(vb=VB, n_sweeps=n_sweeps)
    if graph.endswith("dense"):
        want = relax_dst_tiled_fixpoint_batch_plain(*args, **kw)
        got = _emulate_dense(args, d=d, **kw)
    else:
        want = relax_dst_ragged_fixpoint_batch_plain(*args, **kw)
        got = emulate(*args, d=d, **kw)
        # the CPU wrapper is the plain version
        for g, w in zip(relax_dst_ragged_fixpoint_batch(*args, **kw), want):
            assert torch.equal(g, w)
    assert int(want[2].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


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


@pytest.mark.parametrize("n_sweeps", [1, 4, 8])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_planted_fault_over_live_chunks_is_caught(d, K, n_sweeps):
    """The same fault in the schedule over the dense layout's live chunks
    (kernels 1, 9 and 7) differs from the plain version on the path."""
    args = _operands("path-dense", K)
    want = relax_dst_tiled_fixpoint_batch_plain(*args, vb=VB,
                                                n_sweeps=n_sweeps)
    got = _emulate_dense(args, vb=VB, n_sweeps=n_sweeps, d=d, hazard=False)
    assert not all(torch.equal(g, w) for g, w in zip(got, want))


def test_dense_path_layout_premise():
    """The dense path case's premise: tile 0 of shard 0 holds the path's
    hops, one a chunk, with a dead chunk after the tenth; its live list
    skips that chunk; tile 2 has no live chunk."""
    (src, w, rel, _), bp, _ = _layout("path-dense")
    idx, bounds = live_chunks(w < INF)
    n_chunks = src.shape[2]
    b = bounds[0].tolist()
    tile0 = idx[0, b[0]:b[1]].tolist()
    assert tile0 == list(range(10)) + list(range(11, 31))
    assert b[2] == b[3] and bool(torch.isinf(w[0, 2]).all())
    for k, c in enumerate(tile0):
        t, j = divmod(c, n_chunks)
        assert t == 0 and src[0, t, j].tolist() == [k] * 4
        assert rel[0, t, j].tolist() == [k + 1] * 4


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


# ------------------------------------- the dense layout's live chunks (7, 9) --

def _live_numpy(live):
    """[P, n_tiles, n_chunks] live flags -> (idx: live chunks first in
    layout order, then the dead ones; bounds: live chunks before tile i)."""
    P, n_tiles, _ = live.shape
    flat = live.reshape(P, -1)
    idx = np.stack([np.r_[np.nonzero(r)[0], np.nonzero(~r)[0]]
                    for r in flat]).astype(np.int32)
    bounds = np.array([[int(live[p, :i].sum()) for i in range(n_tiles + 1)]
                       for p in range(P)], np.int32)
    return idx, bounds


def _hand_weights():
    """[2, 4, 3, 8] weights. Shard 0: tile 0 all live, tile 1 no edge,
    tile 2 a dead chunk between two live ones (one edge of weight +inf is
    all it holds), tile 3 its first chunk alone. Shard 1: no live chunk."""
    w = np.full((2, 4, 3, 8), np.inf, np.float32)
    w[0, 0, :, :5] = 1.0
    w[0, 2, 0, 0] = 2.0
    w[0, 2, 2, 7] = 0.0
    w[0, 3, 0, 3] = 4.0
    return torch.from_numpy(w)


@functools.lru_cache(maxsize=None)
def _dense_shards(graph):
    g = (tg.rmat_graph(scale=8, edge_factor=6, seed=5) if graph == "rmat"
         else tg.road_grid_graph(side=16, seed=2))
    return tc.build_shards(g, 3, layout="dense", relax_vb=VB, relax_eb=EB,
                           send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)


@pytest.mark.parametrize("case", ["hand", "path", "rmat", "road"])
def test_live_chunks_match_numpy(case):
    """``live_chunks`` against numpy: a tile with no edge, a tile all live,
    a dead chunk in the middle of a tile, a shard with none; on the shards,
    the three lists kernel 7 walks (``round_chunks``: merge by valid,
    relax and send by weight)."""
    if case in ("hand", "path"):
        w = _hand_weights() if case == "hand" else _layout("path-dense")[0][1]
        planes = [w < INF]
    else:
        sh = _dense_shards(case)
        planes = [sh.mx_valid > 0, sh.rx_w < INF, sh.tx_w < INF]
        for got, live in zip(sh.round_chunks, planes):
            for g, want in zip(got, _live_numpy(live.any(-1).numpy())):
                np.testing.assert_array_equal(g.numpy(), want)
    for live in planes:
        idx, bounds = live_chunks(live)
        want = _live_numpy(live.any(-1).numpy())
        assert idx.dtype == bounds.dtype == torch.int32
        np.testing.assert_array_equal(idx.numpy(), want[0])
        np.testing.assert_array_equal(bounds.numpy(), want[1])
    if case == "hand":
        idx, bounds = live_chunks(planes[0])
        np.testing.assert_array_equal(bounds.numpy(),
                                      [[0, 3, 3, 5, 6], [0] * 5])
        assert idx[0, :6].tolist() == [0, 1, 2, 6, 8, 9]
        assert sorted(idx[1].tolist()) == list(range(12))


@pytest.mark.parametrize("graph", ["rmat-dense", "road-dense", "path-dense",
                                   "no-live"])
def test_live_schedule_matches_jax_kernel9(graph):
    """Kernel 9's schedule, one row a shard over the shard's live chunks,
    bit-equal to the port's plain kernel 9 and to the JAX package's kernel
    9 in interpret mode (out, resid, relaxations); "no-live" has no live
    chunk at all, so out == dist, resid empty, no relaxation."""
    jnp = pytest.importorskip("jax.numpy")
    j_relax = pytest.importorskip("repro.kernels.relax")
    args = list(_operands("path-dense" if graph == "no-live" else graph, 1))
    if graph == "no-live":
        args[3] = torch.full_like(args[3], INF)
    eb = args[2].shape[-1]
    kw = dict(vb=VB, n_sweeps=4)
    got = _emulate_dense(args, d=2, **kw)
    for p in range(args[0].shape[0]):
        row = [a[p, 0] for a in args[:2]] + [a[p] for a in args[2:]]
        plain = relax_dst_tiled_fixpoint_plain(*row, **kw)
        ref = j_relax.relax_fixpoint_pallas(
            *(jnp.asarray(a.numpy()) for a in row), eb=eb, interpret=True,
            **kw)
        for g, pl, r in zip(got, plain, ref):
            g = g[p, 0] if g.dim() == 3 else g[p, :1]
            assert torch.equal(g, pl.reshape(g.shape))
            np.testing.assert_array_equal(g.numpy(),
                                          np.asarray(r).reshape(g.shape))
    if graph == "no-live":
        assert torch.equal(got[0], args[0]) and not bool(got[1].any())
        assert int(got[2].sum()) == 0
    else:
        assert int(got[2].sum()) > 0


def _kernel1_case(P, K, seed=0):
    """Kernel 1's operands on P shards of 256 / P vertices (VB 32, EB 4):
    random local edges (weights in [0, 3)), but tile 0 of shard 0 holds
    only a path 0 -> 1 -> ... -> 30 (hops of weight 1, four to a chunk);
    a dead chunk (all +inf) inserted as chunk 5 of every tile, so the path
    runs across it; the last tile of shard 0 with no live chunk; a 20%
    Trishla mask off the path. Rows as ``_operands``: row 0 of each shard
    holds 10 v at v < 31, all in the frontier, the others a random
    mid-solve state. Returns (dist, front, src, w, rel, pruned)."""
    rng = np.random.default_rng(seed + 10 * P)
    nb = 256 // P
    lays = []
    for p in range(P):
        src, dst = rng.integers(0, nb, 2 * nb), rng.integers(0, nb, 2 * nb)
        w = rng.uniform(0, 3, 2 * nb).astype(np.float32)
        if p == 0:
            keep, hop = dst >= VB, np.repeat(np.arange(30), 4)
            src, dst = np.r_[hop, src[keep]], np.r_[hop + 1, dst[keep]]
            w = np.r_[np.ones(len(hop), np.float32), w[keep]]
        lays.append(build_dst_tiled_layout(src, dst, w, nb, vb=VB, eb=4)[:3])
    n_chunks = max(lay[0].shape[1] for lay in lays) + 1
    planes = []
    for k, fill in enumerate((nb - 1, INF, 0)):
        per = []
        for lay in lays:
            a = lay[k]
            dead = torch.full((a.shape[0], 1, 4), fill, dtype=a.dtype)
            a = torch.cat([a[:, :5], dead, a[:, 5:]], 1)
            per.append(torch.cat([a, torch.full(
                (a.shape[0], n_chunks - a.shape[1], 4), fill,
                dtype=a.dtype)], 1))
        planes.append(torch.stack(per))
    src, w, rel = planes
    w[0, -1] = INF                          # shard 0's last tile: none live
    pruned = torch.from_numpy((rng.random(src.shape) < 0.2).astype(np.int32))
    pruned[0, 0] = 0                        # the path is never pruned
    dist = rng.uniform(0, 50, (P, K, nb)).astype(np.float32)
    dist[rng.random(dist.shape) < 0.3] = np.inf
    front = (rng.random(dist.shape) < 0.3) & np.isfinite(dist)
    dist[:, 0] = np.inf
    dist[:, 0, :31] = 10.0 * np.arange(31)
    front[:, 0] = False
    front[:, 0, :31] = True
    return (torch.from_numpy(dist), torch.from_numpy(front.astype(np.float32)),
            src, w, rel, pruned)


@pytest.mark.parametrize("n_sweeps", [1, 8])
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("P", [1, 4])
def test_kernel1_live_schedule_matches_jax(P, K, n_sweeps):
    """Kernel 1's schedule, the K-query chain of every shard over the relax
    layout's live chunks (``live_chunks(w < inf)``, as the engine passes
    them), bit-equal to the port's plain kernel 1 and to the JAX package's
    kernel 1 in interpret mode, shard by shard (distances, residual
    frontier, per-(shard, query) relaxations), on a layout with a dead
    chunk inside every tile, a tile with no live chunk and a Trishla mask;
    the planted fault, hazard sources read at issue time, differs on the
    path."""
    jnp = pytest.importorskip("jax.numpy")
    j_relax = pytest.importorskip("repro.kernels.relax.relax")
    args = _kernel1_case(P, K)
    kw = dict(vb=VB, n_sweeps=n_sweeps)
    idx, bounds = live_chunks(args[3] < INF)
    assert 5 not in idx[0, :int(bounds[0, 1])].tolist()   # the dead chunk
    assert int(bounds[0, -1]) == int(bounds[0, -2])       # a tile none live
    want = relax_dst_tiled_fixpoint_batch_plain(*args, **kw)
    assert int(want[2].sum()) > 0
    got = emulate_live(*args[:2], idx, bounds, *args[2:], d=2, **kw)
    cpu = relax_dst_tiled_fixpoint_batch(*args, **kw, chunks=(idx, bounds))
    for g, c, w in zip(got, cpu, want):
        assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(c, w)
    for p in range(P):
        ref = j_relax.relax_dst_tiled_fixpoint_batch(
            *(jnp.asarray(a[p].numpy()) for a in args), eb=4, interpret=True,
            **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[p].numpy(), np.asarray(r))
    bad = emulate_live(*args[:2], idx, bounds, *args[2:], d=2, hazard=False,
                       **kw)
    assert not torch.equal(bad[0][0, 0], want[0][0, 0])


@pytest.mark.parametrize("fused", [False, True])
def test_dense_solvers_pass_the_relax_chunks(monkeypatch, fused):
    """The dense staged local solver (``_batch_pallas``) and the
    fused round's rescue (``fused_round_rescue``, one sweep a launch so
    that rounds are rescued) hand kernel 1 the shards' own relax live
    chunks, ``SsspShards.round_chunks[1]``, derived once per shards
    object; the solve is unchanged."""
    import repro_torch.kernels.relax.ops as relax_ops
    seen = []
    kernel1 = relax_ops.relax_dst_tiled_fixpoint_batch

    def spy(*args, chunks=None, **kw):
        seen.append(chunks)
        return kernel1(*args, chunks=chunks, **kw)

    g = tg.rmat_graph(scale=8, edge_factor=6, seed=5)
    sh = tc.build_shards(g, 2, layout="dense", relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    cfg = (dict(round="fused", pallas_sweeps=1) if fused else dict(
        local_solver="pallas", send_backend="pallas", merge_backend="pallas"))
    eng = tc.SsspEngine.build(sh, tc.SsspConfig(**cfg), device="cpu")
    want = eng.solve([0, 1])
    monkeypatch.setattr(relax_ops, "relax_dst_tiled_fixpoint_batch", spy)
    got = eng.solve([0, 1])
    assert seen and all(c is eng.shards.round_chunks[1] for c in seen)
    assert eng.shards.relax_chunks is eng.shards.round_chunks[1]
    np.testing.assert_array_equal(got.dist, want.dist)
    assert int(got.stats.relaxations) == int(want.stats.relaxations)


def emulate_round(ops, chunks, *, vb, sb, n_sweeps, dense, d):
    """Kernel 7's schedule: merge and send warp by tile over each tile's
    live chunks (``chunks`` = the (idx, bounds) pairs of merge, relax and
    send), the relax stage the chain over the relax layout's live chunks.
    Returns the plain version's six outputs."""
    dist, front, live, inc, last, valid, mx, rx, tx = ops
    P, K, _ = dist.shape

    def tile_chunks(lay, idx, bounds, p, t):
        c = idx[p, bounds[p, t]:bounds[p, t + 1]].long()
        return [a[p].reshape(-1, a.shape[-1])[c].reshape(-1) for a in lay]

    merged = torch.minimum(dist, inc) if dense else dist.clone()
    if not dense:
        idx, bounds = chunks[0]
        for p in range(P):
            for t in range(bounds.shape[1] - 1):
                pos, rel, ok = tile_chunks(mx, idx, bounds, p, t)
                for q in range(K):
                    cand = torch.where(ok > 0, take_fill(inc[p, q], pos, INF),
                                       INF)
                    m = torch.full((vb,), INF).scatter_reduce(
                        0, rel.long(), cand, "amin")
                    seg = merged[p, q, t * vb:(t + 1) * vb]
                    seg.copy_(torch.minimum(seg, m))
    newf = (merged < dist) & (live[..., None] > 0)
    out, resid, nrel = emulate_live(
        merged, torch.maximum(newf.float(), front), *chunks[1], *rx, vb=vb,
        n_sweeps=n_sweeps, d=d)
    val, new_last = torch.full_like(last, INF), last.clone()
    sends = torch.zeros((P, K), dtype=torch.int32)
    idx, bounds = chunks[2]
    for p in range(P):
        for t in range(bounds.shape[1] - 1):
            src, w, seg, prn = tile_chunks(tx, idx, bounds, p, t)
            w = torch.where(prn > 0, INF, w)
            sl = slice(t * sb, (t + 1) * sb)
            for q in range(K):
                cand = torch.where(w < INF, out[p, q][src.long()] + w, INF)
                m = torch.full((sb,), INF).scatter_reduce(0, seg.long(), cand,
                                                          "amin")
                better = (valid[p, sl] > 0) & (m < last[p, q, sl])
                val[p, q, sl] = torch.where(better, m, INF)
                new_last[p, q, sl] = torch.where(better, m, last[p, q, sl])
                sends[p, q] += int(better.sum())
    return out, resid, val, new_last, nrel, sends


@functools.lru_cache(maxsize=None)
def _round_shards(graph):
    """(JAX shards, port shards with the same arrays), dense, 3 shards."""
    jc = pytest.importorskip("repro.core")
    jg = pytest.importorskip("repro.graph")
    g = (jg.rmat_graph(scale=7, edge_factor=8, seed=3) if graph == "rmat"
         else jg.road_grid_graph(side=12, seed=4))
    sj = jc.build_shards(g, 3, layout="dense", relax_vb=VB, relax_eb=EB,
                         send_sb=VB, send_eb=EB, merge_vb=VB, merge_eb=EB)
    fields = {f.name: (None if getattr(sj, f.name) is None
                       else np.asarray(getattr(sj, f.name)))
              for f in dataclasses.fields(sj)
              if f.metadata.get("static") is not True}
    static = {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)
              if f.metadata.get("static") is True}
    return sj, tc.shards_from_arrays(fields, **static)


@pytest.mark.parametrize("n_sweeps", [2, 8])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("graph", ["rmat", "road"])
def test_round_schedule_over_live_chunks(graph, dense, n_sweeps):
    """Kernel 7's schedule (merge and send by tile over live chunks, the
    chain over the live relax chunks) bit-equal to ``fused_round_tiled_plain``
    and, shard by shard, to the JAX package's fused round in interpret mode
    (all six outputs), with bucket and dense incoming."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    j_round = pytest.importorskip("repro.kernels.round")
    sj, st = _round_shards(graph)
    P, block, S = st.n_parts, st.block, st.n_slots
    rng = np.random.default_rng(n_sweeps + 10 * dense)
    ridx = st.recv_idx.reshape(P, -1).numpy()

    def rows(shape, p_inf):
        return np.where(rng.random(shape) < p_inf, np.float32(np.inf),
                        (rng.random(shape) * 10).astype(np.float32))
    dist = rows((P, 3, block), 0.3)
    front = rng.random(dist.shape) < 0.2
    live = rng.random((P, 3)) < 0.8
    inc = (rows((P, 3, block), 0.5) if dense else np.where(
        (ridx == block)[:, None], np.inf, rows((P, 3, ridx.shape[1]), 0.5)))
    last = np.where(st.slot_valid.numpy()[:, None], rows((P, 3, S), 0.5),
                    np.inf).astype(np.float32)
    prn = (rng.random((P, st.e_loc)) < 0.15, rng.random((P, st.e_cut)) < 0.15)
    state = [torch.from_numpy(np.asarray(a)) for a in (dist, front, live,
                                                       inc, last)]
    ops = fused_round_operands(
        *state, st.slot_valid, st.relax_layout, st.send_layout,
        st.merge_layout, *map(torch.from_numpy, prn), vb=VB, sb=VB,
        dense=dense)
    kw = dict(vb=VB, sb=VB, n_sweeps=n_sweeps, dense=dense)
    want = fused_round_tiled_plain(*ops, **kw)
    got = emulate_round(ops, st.round_chunks, d=2, **kw)
    assert int(want[4].sum()) > 0 and int(want[5].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    # some list skips dead chunks
    assert any(int(b[:, -1].min()) < i.shape[1] for i, b in st.round_chunks)
    for p in range(P):
        s0 = jax.tree_util.tree_map(lambda x: x[p], sj)
        ref = j_round.fused_round_pallas(
            *(jnp.asarray(a[p]) for a in (dist, front, live, inc, last)),
            s0.slot_valid, s0.relax_layout, s0.send_layout, s0.merge_layout,
            jnp.asarray(prn[0][p]), jnp.asarray(prn[1][p]), dense=dense,
            vb=VB, sb=VB, n_sweeps=n_sweeps)
        mine = (got[0][p, :, :block], got[2][p, :, :S], got[3][p, :, :S],
                got[4][p], got[5][p], got[1][p, :, :block])
        for i, (g, r) in enumerate(zip(mine, ref)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                          err_msg=f"output {i} shard {p}")
