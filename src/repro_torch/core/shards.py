"""Host-side shard preprocessing for SP-Async (dense and ragged layouts).

Port of the reference's ``core/shards.py``. Each partition's edges split
into LOCAL (dst owned by the same shard) and CUT (dst owned elsewhere)
lists, and the message routing of the bucketed exchange is precomputed:

- cut edges are grouped by their boundary pair ``(dst_owner, dst_local)``;
  each unique pair is a *message slot*;
- each slot has a static position in the ``[P, C]`` send row, and
  ``recv_idx[q, p, c]`` is the local vertex on shard q addressed by sender
  p's position c (built by transposition).

Three tile layouts ride in the shards, each grouping items by destination
tile: ``rx_*`` (local edges by vertex tile, for the relax kernel),
``tx_*`` (cut edges by message-slot tile, plus the ``tx_payload_slot``
payload inverse, for the send kernel) and ``mx_*`` (receive positions by
vertex tile, for the merge kernel). ``relax_layout=False`` leaves the
``rx_*`` fields None and ``comm_layout=False`` the ``tx_*`` and ``mx_*``
ones: the kernel backends then fall back to plain ops (``core/sssp.py``),
trading speed for the layouts' memory. Each comes in two shapes, chosen by
``layout=``:

- ``"dense"``: ``[P, n_tiles, n_chunks, EB]`` with ``n_chunks`` the max
  over tiles and shards, so every tile is padded to the worst case;
- ``"ragged"``: CSR-chunked flat rows ``[P, total_chunks, EB]`` plus a
  chunk->tile map ``*_ctile [P, total_chunks]`` (non-decreasing; sentinel
  ``n_tiles`` on the padding chunks that stack the shards). Memory follows
  ``sum_t ceil(count_t / EB)``; the chunk contents are the dense ones.

``build_shards`` partitions a materialized ``Graph``;
``build_shards_stream`` consumes an iterator of edge chunks with per-part
accumulators, so a 10M-edge graph never becomes one dense intermediate.
Every array is a host int32/float32/bool torch tensor, stacked
``[P, ...]``; ``SsspShards.to(device)`` moves them.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.partition import partition_1d
from repro_torch.graph.structure import Graph
from repro_torch.kernels.common import chunk_bounds, live_chunks
from repro_torch.kernels.merge.ops import (build_msg_ragged_layout,
                                           build_msg_tiled_layout)
from repro_torch.kernels.relax.ops import (build_dst_ragged_layout,
                                           build_dst_tiled_layout)
from repro_torch.kernels.send.ops import (build_slot_ragged_layout,
                                          build_slot_tiled_layout)

_STATIC = ("n_vertices", "n_parts", "block", "rx_vb", "rx_eb", "tx_sb",
           "tx_eb", "mx_vb", "mx_eb", "layout", "shard_id", "inter_total")


@dataclasses.dataclass(frozen=True)
class SsspShards:
    """All static per-shard state for the SP-Async solver, stacked [P, ...]."""

    # local edges (dst owned by this shard)
    loc_src: torch.Tensor     # [P, e_loc] int32 local ids (block = padding)
    loc_dst: torch.Tensor     # [P, e_loc] int32 local ids
    loc_w: torch.Tensor       # [P, e_loc] f32 (+inf padding)
    # cut edges (dst owned elsewhere), grouped by (owner, dst_local)
    cut_src: torch.Tensor     # [P, e_cut] int32 local ids
    cut_w: torch.Tensor       # [P, e_cut] f32 (+inf padding)
    cut_seg: torch.Tensor     # [P, e_cut] int32 slot id (S = padding)
    # message slots (unique boundary pairs)
    slot_owner: torch.Tensor  # [P, S] int32 destination shard
    slot_dstl: torch.Tensor   # [P, S] int32 dst-local id on the destination
    slot_pos: torch.Tensor    # [P, S] int32 position within the [P, C] row
    slot_valid: torch.Tensor  # [P, S] bool
    # receive routing: local vertex addressed by (sender, bucket position)
    recv_idx: torch.Tensor    # [P, P, C] int32 (block = no message)
    # Trishla triangle candidates: combined edge ids (uj to prune, ui, ij)
    tri_uj: torch.Tensor      # [P, T] int32
    tri_ui: torch.Tensor      # [P, T] int32
    tri_ij: torch.Tensor      # [P, T] int32
    tri_valid: torch.Tensor   # [P, T] bool
    inter_edges: torch.Tensor  # [P] int32 per-shard cut-edge counts
    n_vertices: int
    n_parts: int
    block: int
    # dst-tiled local edges (relax kernel); rx_eid maps a tiled slot back to
    # its local edge id (sentinel e_loc) for the runtime Trishla mask.
    # Dense [P, n_vtiles, n_chunks, EB]; ragged [P, total_chunks, EB] with
    # the chunk->tile map *_ctile [P, total_chunks] int32 (sentinel
    # n_tiles on padding chunks; None when dense). None when built with
    # relax_layout=False. The reference's field order.
    rx_src: torch.Tensor | None = None      # int32
    rx_w: torch.Tensor | None = None        # f32
    rx_dstrel: torch.Tensor | None = None   # int32 in [0, rx_vb)
    rx_eid: torch.Tensor | None = None      # int32
    rx_ctile: torch.Tensor | None = None
    rx_vb: int = 128
    rx_eb: int = 512
    # slot-tiled cut edges (send kernel); tx_eid sentinel e_cut. The tx_*
    # and mx_* fields are None when built with comm_layout=False.
    tx_src: torch.Tensor | None = None      # int32
    tx_w: torch.Tensor | None = None
    tx_segrel: torch.Tensor | None = None
    tx_eid: torch.Tensor | None = None
    tx_ctile: torch.Tensor | None = None
    # [P, P, C] int32 slot feeding (dest, pos); S = none
    tx_payload_slot: torch.Tensor | None = None
    tx_sb: int = 128
    tx_eb: int = 512
    # msg-tiled receive routing (merge kernel): flat positions [0, P*C)
    mx_pos: torch.Tensor | None = None      # int32
    mx_dstrel: torch.Tensor | None = None
    mx_valid: torch.Tensor | None = None
    mx_ctile: torch.Tensor | None = None
    mx_vb: int = 128
    mx_eb: int = 512
    layout: str = "dense"
    # a rank's one-shard view (``shard``): the shard it holds, and the
    # global cut-edge count; None on the full stack
    shard_id: int | None = None
    inter_total: int | None = None

    @property
    def n_rows(self) -> int:
        """Shards in this stack: ``n_parts``, or 1 on a rank's view."""
        return self.loc_src.shape[0]

    @property
    def row0(self) -> int:
        """The shard id of the stack's first row."""
        return 0 if self.shard_id is None else self.shard_id

    def shard(self, r: int) -> "SsspShards":
        """Shard ``r`` as a one-shard stack: row ``r`` of every array
        (shape ``[1, ...]``), for the rank of the ``shmap`` backend that
        owns it. ``n_parts``, ``block`` and the layouts' static sizes stay
        the global ones, and so does ``inter_edges_total`` (toka3's bound
        reads it), which the view carries since its ``inter_edges`` row
        alone would give the local count."""
        if self.shard_id is not None:
            raise ValueError("shard() of a one-shard view")
        if not 0 <= r < self.n_parts:
            raise ValueError(f"shard {r} out of range [0, {self.n_parts})")
        return dataclasses.replace(
            self, **{k: v[r:r + 1].clone()
                     for k, v in self.arrays().items()},
            shard_id=int(r), inter_total=self.inter_edges_total)

    @property
    def e_loc(self) -> int:
        return self.loc_src.shape[1]

    @property
    def e_cut(self) -> int:
        return self.cut_src.shape[1]

    @property
    def n_slots(self) -> int:
        return self.slot_owner.shape[1]

    @property
    def bucket_cap(self) -> int:
        return self.recv_idx.shape[2]

    @property
    def device(self) -> torch.device:
        return self.loc_src.device

    @property
    def n_stiles(self) -> int:
        """Slot tiles of the send layout: ``ceil(S / tx_sb)``."""
        return max(-(-self.n_slots // self.tx_sb), 1)

    @property
    def has_relax_layout(self) -> bool:
        return self.rx_src is not None

    @property
    def relax_layout(self):
        """(src, w, dstrel, eid), plus the chunk->tile map when ragged: the
        consumers dispatch the ragged kernel on the 5-tuple. None without
        the layout."""
        if self.rx_src is None:
            return None
        base = (self.rx_src, self.rx_w, self.rx_dstrel, self.rx_eid)
        return base if self.rx_ctile is None else base + (self.rx_ctile,)

    @property
    def has_send_layout(self) -> bool:
        return self.tx_src is not None

    @property
    def send_layout(self):
        """(src, w, segrel, eid), plus the chunk->tile map when ragged; None
        without the layout."""
        if self.tx_src is None:
            return None
        base = (self.tx_src, self.tx_w, self.tx_segrel, self.tx_eid)
        return base if self.tx_ctile is None else base + (self.tx_ctile,)

    @property
    def has_merge_layout(self) -> bool:
        return self.mx_pos is not None

    @property
    def merge_layout(self):
        """(pos, dstrel, valid), plus the chunk->tile map when ragged (a
        4-tuple); None without the layout."""
        if self.mx_pos is None:
            return None
        base = (self.mx_pos, self.mx_dstrel, self.mx_valid)
        return base if self.mx_ctile is None else base + (self.mx_ctile,)

    @functools.cached_property
    def inter_edges_total(self) -> int:
        """The global cut-edge count on the host (toka3's bound); read
        once per shards object (carried by a rank's one-shard view)."""
        if self.inter_total is not None:
            return self.inter_total
        return int(self.inter_edges.sum(dtype=torch.int32))

    @functools.cached_property
    def send_bounds(self):
        """[P, n_stiles + 1] int32 tile -> chunk ranges of the ragged send
        layout (``chunk_bounds``), None when dense. Derived once per shards
        object, so once per engine and device move, never per round."""
        if self.tx_ctile is None:
            return None
        return chunk_bounds(self.tx_ctile, self.n_stiles)

    @functools.cached_property
    def merge_bounds(self):
        """[P, n_vtiles + 1] int32 tile -> chunk ranges of the ragged merge
        layout, None when dense; derived once, as ``send_bounds``."""
        if self.mx_ctile is None:
            return None
        return chunk_bounds(self.mx_ctile, -(-self.block // self.mx_vb))

    @functools.cached_property
    def relax_chunks(self):
        """The dense relax layout's live chunks (by ``rx_w``), the (idx,
        bounds) pair of ``live_chunks`` that kernels 1 and 7 walk; None
        when ragged or without the layout. Derived once, as
        ``send_bounds``."""
        if self.layout != "dense" or self.rx_w is None:
            return None
        return live_chunks(self.rx_w < float("inf"))

    @functools.cached_property
    def round_chunks(self):
        """The dense layouts' live chunks that kernel 7 walks, (merge by
        ``mx_valid``, relax (``relax_chunks``), send by ``tx_w``), each
        the (idx, bounds) pair of ``live_chunks``; None when ragged or
        without all three layouts. Derived once, as ``send_bounds``."""
        if self.layout != "dense" or not (self.has_relax_layout
                                          and self.has_send_layout
                                          and self.has_merge_layout):
            return None
        return (live_chunks(self.mx_valid > 0), self.relax_chunks,
                live_chunks(self.tx_w < float("inf")))

    def arrays(self) -> dict[str, torch.Tensor]:
        """Every array field by name (the ctile maps only when ragged)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in _STATIC and getattr(self, f.name) is not None}

    def to(self, device) -> "SsspShards":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.arrays().items()})

    def layout_bytes(self) -> dict:
        """Measured memory of each tile-layout family vs the CSR ideal and
        the dense equivalent.

        Per family: ``bytes`` (array storage, the ctile map included),
        ``items`` (real edges / messages it encodes), ``bytes_per_item``,
        ``ideal_bytes`` (4 B per plane per item: 4 planes for the edge
        layouts, 3 for the msg layout) and ``dense_bytes`` (what the dense
        layout costs for the same data; equal to ``bytes`` when dense).
        A family the shards were built without counts 0 bytes.
        ``bytes_per_edge`` divides the edge layouts by real edges."""
        loc_edges = int(torch.isfinite(self.loc_w).sum())
        cut_edges = int(torch.isfinite(self.cut_w).sum())
        msgs = int((self.recv_idx < self.block).sum())
        groups = {}
        for name, arrays, items, planes, n_tiles, eb in (
                ("relax", self.relax_layout, loc_edges, 4,
                 max(-(-self.block // self.rx_vb), 1), self.rx_eb),
                ("send", self.send_layout, cut_edges, 4, self.n_stiles,
                 self.tx_eb),
                ("merge", self.merge_layout, msgs, 3,
                 max(-(-self.block // self.mx_vb), 1), self.mx_eb)):
            arrays = arrays or ()
            b = int(sum(a.numel() * a.element_size() for a in arrays))
            ctile = arrays[planes] if len(arrays) > planes else None
            groups[name] = {
                "bytes": b, "items": items,
                "bytes_per_item": b / max(items, 1),
                "ideal_bytes": items * planes * 4,
                "dense_bytes": (b if ctile is None else _dense_equivalent(
                    ctile, n_tiles, eb, planes))}
        n_edges = loc_edges + cut_edges
        return {"layout": self.layout, "groups": groups,
                "total_bytes": sum(g["bytes"] for g in groups.values()),
                "dense_bytes": sum(g["dense_bytes"] for g in groups.values()),
                "n_edges": n_edges,
                "bytes_per_edge": (groups["relax"]["bytes"]
                                   + groups["send"]["bytes"]) / max(n_edges, 1),
                "ideal_bytes_per_edge": 16.0}


def _dense_equivalent(ctile, n_tiles: int, eb: int, planes: int) -> int:
    """Bytes of the dense layout that holds a ragged layout's chunks: every
    tile of every shard padded to the most chunks any one tile has."""
    ct = ctile.cpu().numpy()
    max_chunks = 1
    for row in ct:
        real = row[row < n_tiles]
        if real.size:
            max_chunks = max(max_chunks,
                             int(np.bincount(real, minlength=n_tiles).max()))
    return int(ct.shape[0] * n_tiles * max_chunks * eb * planes * 4)


def _check_ragged(sh: SsspShards) -> SsspShards:
    """Raise unless ragged shards carry the chunk->tile map of each layout
    they hold, each within [0, n_tiles] and non-decreasing per shard, so
    each tile owns one contiguous chunk range and the sentinel ``n_tiles``
    sits only on trailing padding chunks: the ragged send and merge kernels
    find a tile's chunks by that range."""
    for name, n_tiles, present in (
            ("rx_ctile", -(-sh.block // sh.rx_vb), sh.has_relax_layout),
            ("tx_ctile", sh.n_stiles, sh.has_send_layout),
            ("mx_ctile", -(-sh.block // sh.mx_vb), sh.has_merge_layout)):
        ctile = getattr(sh, name)
        if ctile is None and not present:
            continue
        if ctile is None or not present:
            raise ValueError(f"ragged shards need {name} exactly with its "
                             "layout")
        ct = ctile.numpy()
        if ct.min() < 0 or ct.max() > n_tiles or (np.diff(ct, axis=-1)
                                                  < 0).any():
            raise ValueError(f"{name}: a ragged chunk->tile map must be "
                             f"non-decreasing within [0, {n_tiles}] per "
                             "shard")
    return sh


def _check_layout(layout: str) -> None:
    if layout not in ("dense", "ragged"):
        raise ValueError(f"unknown layout {layout!r}: expected 'dense' or "
                         "'ragged'")


def shards_from_arrays(fields: dict, **static) -> SsspShards:
    """Shards from host arrays (e.g. another package's ``SsspShards`` read
    out as numpy), so both sides solve identical state. ``fields`` maps each
    array field name to an array; entries that are None (such as the ctile
    maps of dense shards) are left out. ``static`` gives the scalar fields
    (n_vertices, n_parts, block, layout, ...)."""
    layout = static.get("layout", "dense")
    _check_layout(layout)
    known = {f.name for f in dataclasses.fields(SsspShards)}
    arrays = {}
    for name, a in fields.items():
        if a is None:
            continue
        if name not in known:
            raise ValueError(f"unknown shard field {name!r}")
        a = np.asarray(a)
        arrays[name] = torch.from_numpy(
            a.copy() if a.dtype == bool else a.astype(
                np.float32 if a.dtype.kind == "f" else np.int32))
    sh = SsspShards(**arrays, **static)
    return _check_ragged(sh) if layout == "ragged" else sh


def shard_distance_rows(rows, n_parts: int, block: int,
                        device=None) -> torch.Tensor:
    """Host distance rows [L, n_vertices] (e.g. the L solved landmark
    sources) in the carry's per-shard layout: ``[P, L, block]`` f32 with
    +inf on the padding vertices, the storage of the engine's landmark
    cache. On the host, as every shard array, unless ``device`` is given."""
    rows = np.asarray(rows, np.float32)
    n_land, n = rows.shape
    full = np.full((n_land, n_parts * block), np.inf, np.float32)
    full[:, :n] = rows
    out = torch.from_numpy(
        np.swapaxes(full.reshape(n_land, n_parts, block), 0, 1).copy())
    return out if device is None else out.to(device)


def _check_weights(w, valid):
    """Raise on NaN / non-finite / negative weights among the valid edges:
    the monotone pipeline needs finite non-negative weights. Padding
    legitimately carries +inf."""
    bad_nan = valid & np.isnan(w)
    bad_inf = valid & ~np.isnan(w) & ~np.isfinite(w)
    bad_neg = valid & (w < 0)
    if bad_nan.any() or bad_inf.any() or bad_neg.any():
        raise ValueError(
            f"invalid edge weights: {int(bad_nan.sum())} NaN, "
            f"{int(bad_inf.sum())} non-finite, {int(bad_neg.sum())} "
            "negative — SSSP requires finite non-negative weights")


def _check_endpoints(src, dst, valid, n_vertices):
    """Raise on out-of-range endpoints among the valid edges."""
    bad_src = valid & ((src < 0) | (src >= n_vertices))
    bad_dst = valid & ((dst < 0) | (dst >= n_vertices))
    if bad_src.any() or bad_dst.any():
        raise ValueError(
            f"out-of-range edge endpoints: {int(bad_src.sum())} src, "
            f"{int(bad_dst.sum())} dst — vertex ids must lie in "
            f"[0, {n_vertices})")


def _pad2(rows, width, fill, dtype):
    out = np.full((len(rows), width), fill, dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _triangles(loc_src, loc_dst, cut_src, cut_seg, slot_owner, slot_dstl,
               p, block, e_loc, budget):
    """Trishla candidates of shard p: (u, vi, vj) with u and vi owned here
    (so (vi, vj) is visible) and all of (u, vi), (u, vj), (vi, vj) present.
    Returns [(uj, ui, ij)] as combined edge ids (local edges first, padded
    to e_loc, then cut edges)."""
    cg = (slot_owner[cut_seg] * block + slot_dstl[cut_seg]
          if len(cut_seg) else np.zeros(0, np.int64))
    all_src = np.concatenate([loc_src, cut_src])
    all_dstg = np.concatenate([loc_dst + p * block, cg])
    eid = np.concatenate([np.arange(len(loc_src)),
                          e_loc + np.arange(len(cut_src))])
    order = np.argsort(all_src, kind="stable")
    s_srt, d_srt, e_srt = all_src[order], all_dstg[order], eid[order]
    starts = np.searchsorted(s_srt, np.arange(block + 1))
    tri = []
    for u in range(block):
        lo, hi = starts[u], starts[u + 1]
        if hi - lo < 2:
            continue
        nbrs = d_srt[lo:hi]
        nbr_eids = e_srt[lo:hi]
        for a in range(len(nbrs)):
            vi = nbrs[a]
            if vi // block != p:
                continue  # (vi, vj) must be visible: vi owned here
            vi_loc = vi - p * block
            vlo, vhi = starts[vi_loc], starts[vi_loc + 1]
            vi_out = d_srt[vlo:vhi]
            vi_out_eids = e_srt[vlo:vhi]
            common, ia, ib = np.intersect1d(nbrs, vi_out, return_indices=True)
            for t in range(len(common)):
                vj = common[t]
                if vj == u + p * block or vj == vi:
                    continue
                tri.append((nbr_eids[ia[t]], nbr_eids[a], vi_out_eids[ib[t]]))
                if budget is not None and len(tri) >= budget:
                    return tri
    return tri


def _stack(per_shard, fills, sentinels, axis: int):
    """Pad per-shard layout planes to the most chunks any shard has (along
    the chunk ``axis`` of the per-shard planes: 1 for dense
    [n_tiles, n_chunks, EB], 0 for ragged [total_chunks, EB] and the
    [total_chunks] ctile) and stack them [P, ...]. ``fills[k]`` pads plane
    k (a float fill makes it float32, else int32); ``sentinels[k][p]`` =
    (own, common) restamps shard p's own padding value in plane k."""
    n = max(lay[0].shape[axis] for lay in per_shard)
    out = []
    for k, fill in enumerate(fills):
        dtype = np.float32 if isinstance(fill, float) else np.int64
        planes = []
        for p, lay in enumerate(per_shard):
            plane = lay[k].numpy().astype(dtype)
            if k in sentinels:
                own, common = sentinels[k][p]
                plane[plane == own] = common
            width = [(0, 0)] * plane.ndim
            width[axis] = (0, n - plane.shape[axis])
            planes.append(np.pad(plane, width, constant_values=fill))
        arr = np.stack(planes)
        out.append(torch.from_numpy(
            arr if dtype == np.float32 else arr.astype(np.int32)))
    return out


def build_shards(g: Graph, n_parts: int,
                 max_triangles_per_part: int | None = None,
                 enumerate_triangles: bool = True, relax_layout: bool = True,
                 relax_vb: int = 128, relax_eb: int = 512,
                 comm_layout: bool = True, send_sb: int = 128,
                 send_eb: int = 512, merge_vb: int = 128,
                 merge_eb: int = 512, layout: str = "dense") -> SsspShards:
    """Partition + preprocess a materialized ``Graph`` (see module doc).
    The parameters are the reference's, in its order. ``layout`` picks the
    tile-layout family: "dense" or "ragged". ``relax_layout=False`` skips
    the ``rx_*`` layout and ``comm_layout=False`` the ``tx_*`` / ``mx_*``
    ones (their fields stay None)."""
    _check_layout(layout)
    w_all = g.weight.numpy()
    v_all = g.valid.numpy()
    _check_weights(w_all, v_all)
    _check_endpoints(g.src.numpy(), g.dst.numpy(), v_all, g.n_vertices)
    pg = partition_1d(g, n_parts)
    src_l = pg.src_local.numpy().astype(np.int64)
    dst_o = pg.dst_owner.numpy().astype(np.int64)
    dst_l = pg.dst_local.numpy().astype(np.int64)
    w = pg.weight.numpy()
    valid = pg.valid.numpy()
    parts = [(src_l[p][vm], dst_o[p][vm], dst_l[p][vm], w[p][vm])
             for p, vm in enumerate(valid)]
    return _assemble_shards(
        parts, pg.n_vertices, pg.n_parts, pg.block,
        max_triangles_per_part=max_triangles_per_part,
        enumerate_triangles=enumerate_triangles, relax_layout=relax_layout,
        relax_vb=relax_vb, relax_eb=relax_eb, comm_layout=comm_layout,
        send_sb=send_sb, send_eb=send_eb, merge_vb=merge_vb,
        merge_eb=merge_eb, layout=layout)


def build_shards_stream(edge_chunks, n_vertices: int, n_parts: int, *,
                        dedup: bool = True,
                        max_triangles_per_part: int | None = None,
                        enumerate_triangles: bool = False,
                        relax_layout: bool = True, relax_vb: int = 128,
                        relax_eb: int = 512, comm_layout: bool = True,
                        send_sb: int = 128, send_eb: int = 512,
                        merge_vb: int = 128, merge_eb: int = 512,
                        layout: str = "ragged") -> SsspShards:
    """Streaming shard build from an iterator of ``(src, dst, w)`` edge
    chunks instead of a materialized ``Graph``.

    Each chunk is checked (weights and endpoints, the errors of
    ``build_shards``) and routed to its owner part (``src // block``) at
    once, so peak memory is one chunk plus the per-part edges: no global
    sort and no ``[P, e_max]`` partition intermediate. Per part, edges are
    then (src, dst)-sorted and min-weight deduplicated with exactly the
    ``csr_from_coo`` recipe, so the shards equal ``build_shards(
    csr_from_coo(...), ...)`` on the concatenated chunks, field for field.

    ``enumerate_triangles`` defaults to False (Trishla's host enumeration
    is superlinear) and ``layout`` to "ragged": this entry point is for
    large graphs. ``relax_layout`` and ``comm_layout`` as in
    ``build_shards``."""
    _check_layout(layout)
    block = max(-(-n_vertices // n_parts), 1)
    acc = [([], [], []) for _ in range(n_parts)]
    for src, dst, w in edge_chunks:
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        w = np.asarray(w, np.float32)
        ok = np.ones(len(src), bool)
        _check_weights(w, ok)
        _check_endpoints(src, dst, ok, n_vertices)
        owner = src // block
        for p in np.unique(owner):
            m = owner == p
            for lst, a in zip(acc[p], (src, dst, w)):
                lst.append(a[m])

    parts = []
    for p in range(n_parts):
        src, dst, w = (np.concatenate(lst) if lst else np.zeros(0, dt)
                       for lst, dt in zip(acc[p], (np.int64, np.int64,
                                                   np.float32)))
        acc[p] = None                       # free each part as it is done
        # csr_from_coo's order: (src, dst) sort, then min-weight dedup by a
        # (key, weight) sort keeping the first of each key
        order = np.lexsort((dst, src))
        src, dst, w = src[order], dst[order], w[order]
        if dedup and len(src):
            key = src * n_vertices + dst
            o2 = np.lexsort((w, key))
            key, src, dst, w = key[o2], src[o2], dst[o2], w[o2]
            keep = np.ones(len(key), bool)
            keep[1:] = key[1:] != key[:-1]
            src, dst, w = src[keep], dst[keep], w[keep]
        dst_o = dst // block
        parts.append((src - p * block, dst_o, dst - dst_o * block, w))
    return _assemble_shards(
        parts, n_vertices, n_parts, block,
        max_triangles_per_part=max_triangles_per_part,
        enumerate_triangles=enumerate_triangles, relax_layout=relax_layout,
        relax_vb=relax_vb, relax_eb=relax_eb, comm_layout=comm_layout,
        send_sb=send_sb, send_eb=send_eb, merge_vb=merge_vb,
        merge_eb=merge_eb, layout=layout)


def _assemble_shards(parts, n, P, block, *, max_triangles_per_part,
                     enumerate_triangles, relax_layout, relax_vb, relax_eb,
                     comm_layout, send_sb, send_eb, merge_vb, merge_eb,
                     layout) -> SsspShards:
    """Shared assembly of both builders: per-part valid edges ->
    ``SsspShards``. ``parts[p]`` = (src_local, dst_owner, dst_local, w),
    each the part's valid edges in (src, dst)-sorted order."""
    loc_src, loc_dst, loc_w = [], [], []
    cut_src, cut_w, cut_seg = [], [], []
    slot_owner, slot_dstl = [], []
    inter_edges = np.zeros(P, np.int64)
    for p, (p_src, p_do, p_dl, p_w) in enumerate(parts):
        cm = p_do != p
        lm = ~cm
        loc_src.append(p_src[lm])
        loc_dst.append(p_dl[lm])
        loc_w.append(p_w[lm])
        # group cut edges by (owner, dst_local)
        co, cl, cs, cw = p_do[cm], p_dl[cm], p_src[cm], p_w[cm]
        order = np.lexsort((cl, co))
        co, cl, cs, cw = co[order], cl[order], cs[order], cw[order]
        key = co * block + cl
        if len(key):
            new_seg = np.ones(len(key), bool)
            new_seg[1:] = key[1:] != key[:-1]
            seg_id = np.cumsum(new_seg) - 1
            u_owner, u_dstl = co[new_seg], cl[new_seg]
        else:
            seg_id = u_owner = u_dstl = np.zeros(0, np.int64)
        cut_src.append(cs)
        cut_w.append(cw)
        cut_seg.append(seg_id)
        slot_owner.append(u_owner)
        slot_dstl.append(u_dstl)
        inter_edges[p] = int(cm.sum())

    e_loc = max(max((len(r) for r in loc_src), default=0), 1)
    e_cut = max(max((len(r) for r in cut_src), default=0), 1)
    S = max(max((len(r) for r in slot_owner), default=0), 1)

    # position of each slot within its destination bucket row
    slot_pos = []
    C = 1
    for p in range(P):
        owners = slot_owner[p]
        pos = np.zeros(len(owners), np.int64)
        for q in np.unique(owners):
            m = owners == q
            pos[m] = np.arange(m.sum())
            C = max(C, int(m.sum()))
        slot_pos.append(pos)

    # receive routing table: recv_idx[q, p, c] = dst_local, by transpose
    recv_idx = np.full((P, P, C), block, np.int64)
    for p in range(P):
        recv_idx[slot_owner[p], p, slot_pos[p]] = slot_dstl[p]

    # Trishla triangle candidates (host-side enumeration)
    tri_rows = [[] for _ in range(P)]
    if enumerate_triangles:
        tri_rows = [_triangles(loc_src[p], loc_dst[p], cut_src[p], cut_seg[p],
                               slot_owner[p], slot_dstl[p], p, block, e_loc,
                               max_triangles_per_part) for p in range(P)]
    T = max(max((len(r) for r in tri_rows), default=0), 1)
    tri = np.zeros((3, P, T), np.int64)
    tri_valid = np.zeros((P, T), bool)
    for p, rows in enumerate(tri_rows):
        if rows:
            tri[:, p, :len(rows)] = np.asarray(rows, np.int64).T
            tri_valid[p, :len(rows)] = True

    ragged = layout == "ragged"
    # the dense layouts pad the chunk axis of [n_tiles, n_chunks, EB]; the
    # ragged ones the flat chunk rows and the ctile map, with its sentinel
    axis = 0 if ragged else 1

    def with_ctile(fills, n_tiles):
        return fills + (n_tiles,) if ragged else fills
    n_vtiles = -(-block // relax_vb)

    layouts = {}
    if relax_layout:
        # dst-tiled local edges (relax kernel); the builder's padding eid is
        # the shard's own edge count, restamped to the uniform sentinel e_loc
        build_rx = (build_dst_ragged_layout if ragged
                    else build_dst_tiled_layout)
        rx = _stack(
            [build_rx(loc_src[p], loc_dst[p], loc_w[p], block, vb=relax_vb,
                      eb=relax_eb, with_eid=True) for p in range(P)],
            fills=with_ctile((n_vtiles * relax_vb - 1, np.inf, 0, e_loc),
                             n_vtiles),
            sentinels={3: [(len(loc_src[p]), e_loc) for p in range(P)]},
            axis=axis)
        layouts.update(rx_src=rx[0], rx_w=rx[1], rx_dstrel=rx[2],
                       rx_eid=rx[3])
        if ragged:
            layouts["rx_ctile"] = rx[4]
    if comm_layout:
        # slot-tiled cut edges (send kernel); padding eid restamped to e_cut
        build_tx = (build_slot_ragged_layout if ragged
                    else build_slot_tiled_layout)
        tx = _stack(
            [build_tx(cut_src[p], cut_seg[p], cut_w[p], S, sb=send_sb,
                      eb=send_eb) for p in range(P)],
            fills=with_ctile((0, np.inf, 0, e_cut), -(-S // send_sb)),
            sentinels={3: [(len(cut_src[p]), e_cut) for p in range(P)]},
            axis=axis)
        # payload-position inverse: each (owner, pos) receives at most one
        # slot
        tx_payload_slot = np.full((P, P, C), S, np.int64)
        for p in range(P):
            tx_payload_slot[p, slot_owner[p], slot_pos[p]] = np.arange(
                len(slot_owner[p]))
        # msg-tiled receive routing (merge kernel)
        build_mx = (build_msg_ragged_layout if ragged
                    else build_msg_tiled_layout)
        mx = _stack(
            [build_mx(recv_idx[q], block, vb=merge_vb, eb=merge_eb)
             for q in range(P)],
            fills=with_ctile((0, 0, 0), -(-block // merge_vb)), sentinels={},
            axis=axis)
        layouts.update(tx_src=tx[0], tx_w=tx[1], tx_segrel=tx[2],
                       tx_eid=tx[3],
                       tx_payload_slot=torch.from_numpy(
                           tx_payload_slot.astype(np.int32)),
                       mx_pos=mx[0], mx_dstrel=mx[1], mx_valid=mx[2])
        if ragged:
            layouts.update(tx_ctile=tx[4], mx_ctile=mx[3])

    def i32(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32))

    sh = SsspShards(
        loc_src=i32(_pad2(loc_src, e_loc, block, np.int64)),
        loc_dst=i32(_pad2(loc_dst, e_loc, block, np.int64)),
        loc_w=torch.from_numpy(_pad2(loc_w, e_loc, np.inf, np.float32)),
        cut_src=i32(_pad2(cut_src, e_cut, block, np.int64)),
        cut_w=torch.from_numpy(_pad2(cut_w, e_cut, np.inf, np.float32)),
        cut_seg=i32(_pad2(cut_seg, e_cut, S, np.int64)),
        slot_owner=i32(_pad2(slot_owner, S, 0, np.int64)),
        slot_dstl=i32(_pad2(slot_dstl, S, 0, np.int64)),
        slot_pos=i32(_pad2(slot_pos, S, 0, np.int64)),
        slot_valid=torch.from_numpy(_pad2(
            [np.ones(len(r), bool) for r in slot_owner], S, False, bool)),
        recv_idx=i32(recv_idx),
        tri_uj=i32(tri[0]), tri_ui=i32(tri[1]), tri_ij=i32(tri[2]),
        tri_valid=torch.from_numpy(tri_valid),
        inter_edges=i32(inter_edges), **layouts,
        n_vertices=n, n_parts=P, block=block, rx_vb=relax_vb,
        rx_eb=relax_eb, tx_sb=send_sb, tx_eb=send_eb, mx_vb=merge_vb,
        mx_eb=merge_eb, layout=layout)
    return _check_ragged(sh) if ragged else sh
