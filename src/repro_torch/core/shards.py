"""Host-side shard preprocessing for SP-Async (dense tile layouts).

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
vertex tile, for the merge kernel). This slice builds the dense form:
``[P, n_tiles, n_chunks, EB]`` with ``n_chunks`` the max over tiles and
shards. Every array is a host int32/float32/bool torch tensor, stacked
``[P, ...]``; ``SsspShards.to(device)`` moves them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.partition import partition_1d
from repro_torch.graph.structure import Graph
from repro_torch.kernels.merge.ops import build_msg_tiled_layout
from repro_torch.kernels.relax.ops import build_dst_tiled_layout
from repro_torch.kernels.send.ops import build_slot_tiled_layout

_STATIC = ("n_vertices", "n_parts", "block", "rx_vb", "rx_eb", "tx_sb",
           "tx_eb", "mx_vb", "mx_eb", "layout")


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
    # dst-tiled local edges (relax kernel); rx_eid maps a tiled slot back to
    # its local edge id (sentinel e_loc) for the runtime Trishla mask
    rx_src: torch.Tensor      # [P, n_vtiles, n_chunks, EB] int32
    rx_w: torch.Tensor        # f32
    rx_dstrel: torch.Tensor   # int32 in [0, rx_vb)
    rx_eid: torch.Tensor      # int32
    # slot-tiled cut edges (send kernel); tx_eid sentinel e_cut
    tx_src: torch.Tensor      # [P, n_stiles, n_chunks, EB] int32
    tx_w: torch.Tensor
    tx_segrel: torch.Tensor
    tx_eid: torch.Tensor
    tx_payload_slot: torch.Tensor  # [P, P, C] int32 slot feeding (dest, pos); S = none
    # msg-tiled receive routing (merge kernel): flat positions [0, P*C)
    mx_pos: torch.Tensor      # [P, n_vtiles, n_chunks, EB] int32
    mx_dstrel: torch.Tensor
    mx_valid: torch.Tensor
    n_vertices: int
    n_parts: int
    block: int
    rx_vb: int = 128
    rx_eb: int = 512
    tx_sb: int = 128
    tx_eb: int = 512
    mx_vb: int = 128
    mx_eb: int = 512
    layout: str = "dense"

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
    def relax_layout(self):
        return (self.rx_src, self.rx_w, self.rx_dstrel, self.rx_eid)

    @property
    def send_layout(self):
        return (self.tx_src, self.tx_w, self.tx_segrel, self.tx_eid)

    @property
    def merge_layout(self):
        return (self.mx_pos, self.mx_dstrel, self.mx_valid)

    def arrays(self) -> dict[str, torch.Tensor]:
        """Every array field by name."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in _STATIC}

    def to(self, device) -> "SsspShards":
        return dataclasses.replace(
            self, **{k: v.to(device) for k, v in self.arrays().items()})

    def layout_bytes(self) -> dict:
        """Measured memory of each tile-layout family vs the CSR ideal.

        Per family: ``bytes`` (array storage), ``items`` (real edges /
        messages it encodes), ``bytes_per_item``, ``ideal_bytes`` (4 B per
        plane per item: 4 planes for the edge layouts, 3 for the msg
        layout) and ``dense_bytes`` (equal to ``bytes``: these shards are
        dense). ``bytes_per_edge`` divides the edge layouts by real edges."""
        loc_edges = int(torch.isfinite(self.loc_w).sum())
        cut_edges = int(torch.isfinite(self.cut_w).sum())
        msgs = int((self.recv_idx < self.block).sum())
        groups = {}
        for name, arrays, items, planes in (
                ("relax", self.relax_layout, loc_edges, 4),
                ("send", self.send_layout, cut_edges, 4),
                ("merge", self.merge_layout, msgs, 3)):
            b = int(sum(a.numel() * a.element_size() for a in arrays))
            groups[name] = {"bytes": b, "items": items,
                            "bytes_per_item": b / max(items, 1),
                            "ideal_bytes": items * planes * 4,
                            "dense_bytes": b}
        total = sum(g["bytes"] for g in groups.values())
        n_edges = loc_edges + cut_edges
        return {"layout": self.layout, "groups": groups, "total_bytes": total,
                "dense_bytes": total, "n_edges": n_edges,
                "bytes_per_edge": (groups["relax"]["bytes"]
                                   + groups["send"]["bytes"]) / max(n_edges, 1),
                "ideal_bytes_per_edge": 16.0}


def shards_from_arrays(fields: dict, **static) -> SsspShards:
    """Shards from host arrays (e.g. another package's ``SsspShards`` read
    out as numpy), so both sides solve identical state. ``fields`` maps each
    array field name to an array; entries that are None (layout families
    this slice does not port, such as the ragged chunk maps) are ignored.
    ``static`` gives the scalar fields (n_vertices, n_parts, block, ...)."""
    if static.get("layout", "dense") != "dense":
        raise NotImplementedError(
            "ragged shards are not ported yet (ROADMAP Queue 2, kernels 2, "
            "4 and 6)")
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
    return SsspShards(**arrays, **static)


def _check_weights(w, valid):
    """Raise on NaN / non-finite / negative weights among the valid edges:
    the monotone pipeline (and the kernels' int-reinterpreted atomicMin)
    needs finite non-negative weights. Padding legitimately carries +inf."""
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


def _stack_tiled(per_shard, fills, sentinels, eb):
    """Pad per-shard [n_tiles, n_chunks_p, EB] layouts to the max chunk
    count and stack them to [P, n_tiles, n_chunks, EB]. ``sentinels[k]``
    (own, common) restamps the k-th plane's per-shard padding value."""
    n_tiles = per_shard[0][0].shape[0]
    n_chunks = max(lay[0].shape[1] for lay in per_shard)
    P = len(per_shard)
    out = []
    for k, fill in enumerate(fills):
        dtype = np.float32 if isinstance(fill, float) else np.int64
        arr = np.full((P, n_tiles, n_chunks, eb), fill, dtype)
        for p, lay in enumerate(per_shard):
            plane = lay[k].numpy().astype(dtype)
            if k in sentinels:
                own, common = sentinels[k][p]
                plane[plane == own] = common
            arr[p, :, :plane.shape[1]] = plane
        out.append(torch.from_numpy(arr.astype(np.float32 if dtype == np.float32
                                               else np.int32)))
    return out


def build_shards(g: Graph, n_parts: int,
                 max_triangles_per_part: int | None = None,
                 enumerate_triangles: bool = True, relax_vb: int = 128,
                 relax_eb: int = 512, send_sb: int = 128, send_eb: int = 512,
                 merge_vb: int = 128, merge_eb: int = 512,
                 layout: str = "dense") -> SsspShards:
    """Partition + preprocess a ``Graph`` (see module doc)."""
    if layout == "ragged":
        raise NotImplementedError(
            "layout='ragged' is not ported yet (ROADMAP Queue 2, kernels 2, "
            "4 and 6)")
    if layout != "dense":
        raise ValueError(f"unknown layout {layout!r}: expected 'dense' or "
                         "'ragged'")
    w_all = g.weight.numpy()
    v_all = g.valid.numpy()
    _check_weights(w_all, v_all)
    _check_endpoints(g.src.numpy(), g.dst.numpy(), v_all, g.n_vertices)
    pg = partition_1d(g, n_parts)
    P, block, n = pg.n_parts, pg.block, pg.n_vertices

    src_l = pg.src_local.numpy().astype(np.int64)
    dst_o = pg.dst_owner.numpy().astype(np.int64)
    dst_l = pg.dst_local.numpy().astype(np.int64)
    w = pg.weight.numpy()
    valid = pg.valid.numpy()

    loc_src, loc_dst, loc_w = [], [], []
    cut_src, cut_w, cut_seg = [], [], []
    slot_owner, slot_dstl = [], []
    inter_edges = np.zeros(P, np.int64)
    for p in range(P):
        vm = valid[p]
        p_src, p_do, p_dl, p_w = src_l[p][vm], dst_o[p][vm], dst_l[p][vm], w[p][vm]
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

    # dst-tiled local edges (relax kernel); the builder's padding eid is the
    # shard's own edge count, restamped to the uniform sentinel e_loc
    rx = _stack_tiled(
        [build_dst_tiled_layout(loc_src[p], loc_dst[p], loc_w[p], block,
                                vb=relax_vb, eb=relax_eb)
         for p in range(P)],
        fills=(-(-block // relax_vb) * relax_vb - 1, np.inf, 0, e_loc),
        sentinels={3: [(len(loc_src[p]), e_loc) for p in range(P)]},
        eb=relax_eb)

    # slot-tiled cut edges (send kernel); padding eid restamped to e_cut
    tx = _stack_tiled(
        [build_slot_tiled_layout(cut_src[p], cut_seg[p], cut_w[p], S,
                                 sb=send_sb, eb=send_eb) for p in range(P)],
        fills=(0, np.inf, 0, e_cut),
        sentinels={3: [(len(cut_src[p]), e_cut) for p in range(P)]},
        eb=send_eb)
    # payload-position inverse: each (owner, pos) receives at most one slot
    tx_payload_slot = np.full((P, P, C), S, np.int64)
    for p in range(P):
        tx_payload_slot[p, slot_owner[p], slot_pos[p]] = np.arange(
            len(slot_owner[p]))

    # msg-tiled receive routing (merge kernel)
    mx = _stack_tiled(
        [build_msg_tiled_layout(recv_idx[q], block, vb=merge_vb, eb=merge_eb)
         for q in range(P)],
        fills=(0, 0, 0), sentinels={}, eb=merge_eb)

    def i32(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32))

    return SsspShards(
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
        inter_edges=i32(inter_edges),
        rx_src=rx[0], rx_w=rx[1], rx_dstrel=rx[2], rx_eid=rx[3],
        tx_src=tx[0], tx_w=tx[1], tx_segrel=tx[2], tx_eid=tx[3],
        tx_payload_slot=i32(tx_payload_slot),
        mx_pos=mx[0], mx_dstrel=mx[1], mx_valid=mx[2],
        n_vertices=n, n_parts=P, block=block, rx_vb=relax_vb,
        rx_eb=relax_eb, tx_sb=send_sb, tx_eb=send_eb, mx_vb=merge_vb,
        mx_eb=merge_eb, layout=layout)
