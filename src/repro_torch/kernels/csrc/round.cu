// One SP-Async round in one launch: merge the delivered messages, chase the
// local frontier, pack the boundary sends; dense and ragged layouts.
//
// Replaces: kernels/round/round.py: fused_round_tiled (the Pallas kernel
// _fused_round_kernel, grid (stage, tile, chunk)) and fused_round_ragged
// (the Pallas kernel _fused_round_ragged_kernel, grid (stage, flat chunk),
// with the three chunk->tile maps scalar-prefetched).
//
// What it computes, per (shard, query) row, in three stages:
//   merge   out = min(dist, incoming): an elementwise min with a [bp] row of
//           remote minima (dense = 1), or the bucket messages scatter-min'd
//           through the msg-tiled layout (pos, dstrel, valid); then the
//           frontier ((out < dist) & live) | front and the sweep snapshot;
//   relax   up to n_sweeps Gauss-Seidel sweeps, as in the relax kernel,
//           then the residual frontier of the last sweep run;
//   send    per message slot, the min over cut edges of out[src] + w,
//           finalized against last_sent: improved = valid & (min < last);
//           send value min where improved, else +inf; new last_sent min
//           where improved, else the old value; count of improved slots.
// Outputs: out, resid, val, new_last, nrel [P, K], sends [P, K].
//
// The Pallas grid runs its stages in order over one shard, with a
// shard-wide early-out flag for the sweeps. Every read and write of the
// three stages stays inside one (shard, query) row, and the flag only gates
// work that does nothing (a row with no frontier relaxes nothing and keeps
// prev == out), so a per-row early-out gives the same rows and counts. So:
// one CTA per (shard, query) row, a grid of P*K, runs all stages with only
// block barriers between them and needs no grid barrier.
//
// Kernels 8 (ragged layouts) and 7 (dense layouts), redesigned for Hopper
// as one kernel template (fused_round_chain_kernel; kernel 7 is its kList
// instance). The relax stage is the chain of sweeps_ragged.cuh (a producer
// warp streams the layout through a ring of bulk copies; frontier and
// improved sets as shared bitmasks; distance gathers issued two chunks
// ahead with the hazard re-read): over the ragged layout for kernel 8,
// over the dense layout's live chunks (those holding a finite weight, in
// layout order) for kernel 7; a chunk of +inf weights is an exact no-op,
// and at the scale-1e6 shards 1,006 of the relax layout's 1,536 chunks
// are. Merge and send have no chain: every tile reduces on its own. Each
// warp takes whole tiles (tile i to warp i mod 17), walks the tile's
// chunks, reduces into its own slice of shared memory and finalizes the
// tile: merge mins it into the row; send finalizes the slot tile against
// last_sent. Kernel 8 finds a tile's chunks from the tile -> chunk bounds
// (chunk_bounds; ctile does not decrease, so a tile's chunks are
// contiguous); kernel 7 from the tile's range of its stage's live-chunk
// list, so it skips the chunks that hold no edge (send, by w) or no
// message (merge, by valid). The engine derives both once per shards
// object, never per round. A slot tile with no chunk finalizes to +inf and
// last_sent, as the reference's global finalize leaves it. No block
// barrier per chunk or per tile: only between stages (send reads the
// relaxed row). What bounds it now: the relax stage's chain of chunk steps
// (see sweeps_ragged.cuh), then bytes: each of a shard's K rows reads the
// shard's merge and send layouts once (at scale-1e7 with K = 16, 2.9 GB of
// send layout a launch, more than L2 holds, so device memory's rate)
// beside a gather a slot.
#include "sweeps_ragged.cuh"

namespace {

// One stage's chunk rows [P, rows, eb]: a = src (relax, send) or pos
// (merge), w = weights (null for merge), rel = tile-relative target,
// mask = pruned (relax, send) or valid (merge). Kernel 8 (ragged): ct, the
// chunk -> tile map [P, rows] (its relax stage); bounds, the tile -> chunk
// ranges [P, n_tiles + 1] (its merge and send). Kernel 7 (dense, rows =
// n_tiles * chunks): idx, the live chunks [P, rows], first in layout order
// (live_chunks); bounds, the tile -> range of idx [P, n_tiles + 1], whose
// last entry is the shard's live count.
struct Stage {
  const int* ct;
  const int* bounds;
  const int* idx;
  const int* a;
  const float* w;
  const int* rel;
  const int* mask;
  int rows;            // chunks per shard
  int chunks;          // chunks per tile (dense layout), else 1
  int n_tiles;
  int eb;
};

// The merge and send of kernels 8 and 7: warp w of the block takes tiles
// w, w + 17, ...; for tile i it reduces the edge slots of the tile's chunks
// into the warp's own tile of keys sl, then finalizes the tile (flush(i)).
// Kernel 8's tile i owns chunks [b[i], b[i+1]); kernel 7's (kList) owns
// the live chunks idx[b[i] .. b[i+1]), the dead ones of its dense range
// skipped (no order to keep: min is exact). No block barrier: tiles are
// independent. item(x, rel, key) reads slot x (shard-relative) into its
// target and key (left at kInfBits for no candidate). Each slot is a load
// of the layout planes and a dependent gather, two round trips to device
// memory, so the lanes take a chunk's worth of slots, 16 each, before
// reducing: 16 chains of each warp in flight.
template <bool kList, typename Item, typename Flush>
__device__ void reduce_by_warp(const int* b, const int* idx, int n_tiles,
                               int eb, int* sl, Item item, Flush flush) {
  constexpr int kUnroll = 16;
  const int lane = threadIdx.x & 31;
  // slots [x0, x1), 32 * kUnroll at a time
  auto span = [&](long long x0, long long x1) {
    for (long long x = x0 + lane; x - lane < x1; x += kUnroll * 32) {
      int rel[kUnroll], key[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rel[u] = -1;
        key[u] = repro::kInfBits;
        if (x + u * 32 < x1) item(x + u * 32, rel[u], key[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (key[u] != repro::kInfBits) atomicMin(sl + rel[u], key[u]);
    }
  };
  for (int i = threadIdx.x >> 5; i < n_tiles; i += repro::ragged::kWarps) {
    if constexpr (kList) {
      for (int j = b[i]; j < b[i + 1]; ++j) {
        const long long x0 = static_cast<long long>(idx[j]) * eb;
        span(x0, x0 + eb);
      }
    } else {
      span(static_cast<long long>(b[i]) * eb,
           static_cast<long long>(b[i + 1]) * eb);
    }
    __syncwarp();
    flush(i);
    __syncwarp();
  }
}

// Kernels 8 and 7 (kList): one block of ragged::kThreads per (shard,
// query) row. vstate: the rows' vertex state in device memory, used only
// when it does not fit in shared memory (bits_smem 0).
template <bool kHazard, bool kList>
__global__ void __launch_bounds__(repro::ragged::kThreads, 1)
fused_round_chain_kernel(const float* __restrict__ dist,
                         const float* __restrict__ front,
                         const float* __restrict__ live,
                         const float* __restrict__ inc,
                         const float* __restrict__ last,
                         const int* __restrict__ valid, Stage mx, Stage rx,
                         Stage tx, float* out, float* resid, float* val,
                         float* new_last, int* nrel, int* sends,
                         uint32_t* vstate, int K, int bp, int sp, int m,
                         int dense, int vb, int sb, int n_sweeps,
                         int bits_smem) {
  namespace rg = repro::ragged;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;              // p * K + q
  const int p = row / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long roff = static_cast<long long>(row) * bp;
  const long long soff = static_cast<long long>(row) * sp;
  const float* d = dist + roff;
  float* o = out + roff;
  const int n_vtiles = rx.n_tiles;
  const int wslice = max(vb, sb);
  const int vbytes = rg::vstate_bytes(bp);
  const rg::Layout L = rg::smem_layout(rx.eb, vb, n_vtiles,
                                       rg::kWarps * wslice * 4,
                                       bits_smem ? vbytes : 0);
  int* slices = reinterpret_cast<int*>(smem + L.extra);
  int* sl = slices + (tid >> 5) * wslice;  // this warp's tile of keys
  int* totals = reinterpret_cast<int*>(smem + L.ctl) + 4;  // relaxations, sends
  for (int x = tid; x < rg::kWarps * wslice; x += rg::kThreads)
    slices[x] = repro::kInfBits;
  if (tid < 2) totals[tid] = 0;

  // ---- merge ----
  const float* in = inc + static_cast<long long>(row) * m;
  {
    const float4* d4 = reinterpret_cast<const float4*>(d);
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* o4 = reinterpret_cast<float4*>(o);
    for (int i = tid; i < bp / 4; i += rg::kThreads) {
      float4 x = d4[i];
      if (dense) {
        const float4 y = in4[i];
        x = make_float4(y.x < x.x ? y.x : x.x, y.y < x.y ? y.y : x.y,
                        y.z < x.z ? y.z : x.z, y.w < x.w ? y.w : x.w);
      }
      o4[i] = x;
    }
  }
  __syncthreads();
  if (!dense) {
    const long long lay = static_cast<long long>(p) * mx.rows * mx.eb;
    const int* pos = mx.a + lay;
    const int* rel = mx.rel + lay;
    const int* ok = mx.mask + lay;
    reduce_by_warp<kList>(
        mx.bounds + static_cast<long long>(p) * (mx.n_tiles + 1),
        kList ? mx.idx + static_cast<long long>(p) * mx.rows : nullptr,
        mx.n_tiles, mx.eb, sl,
        [&](long long i, int& r, int& k) {
          const int oki = ok[i], pi = pos[i];
          r = rel[i];
          if (oki > 0) k = rg::cand_key(in[pi]);
        },
        [&](int t) {
          float* ot = o + static_cast<long long>(t) * vb;
          for (int v = lane; v < vb; v += 32) {
            const float mv = repro::key_value(sl[v]);
            if (mv < ot[v]) ot[v] = mv;
            sl[v] = repro::kInfBits;
          }
        });
    __syncthreads();
  }
  // the round's frontier as a bitmask, the improved set empty
  uint32_t* vs =
      bits_smem ? reinterpret_cast<uint32_t*>(smem + L.vstate)
                : vstate + static_cast<long long>(row) * (vbytes / 4);
  const int words = rg::bit_words(bp);
  const bool lv = live[row] > 0.f;
  const float4* d4 = reinterpret_cast<const float4*>(d);
  const float4* o4 = reinterpret_cast<const float4*>(o);
  const float4* f4 = reinterpret_cast<const float4*>(front + roff);
  unsigned any = 0;
  // (i - lane keeps the loop warp-uniform)
  for (int i = tid; i - lane < bp / 4; i += rg::kThreads) {
    const bool in_row = i < bp / 4;
    unsigned nib = 0;
    if (in_row) {
      nib = rg::nibble(f4[i]);
      if (lv) {
        const float4 a = o4[i], b = d4[i];
        nib |= (a.x < b.x) | (a.y < b.y) << 1 | (a.z < b.z) << 2 |
               (a.w < b.w) << 3;
      }
      if ((i & 7) == 0) vs[words + (i >> 3)] = 0;
    }
    any |= nib;
    rg::pack_nibbles(vs, i, nib, in_row);
  }
  int active = __syncthreads_or(any != 0);

  // ---- relax ----
  const long long rlay = static_cast<long long>(p) * rx.rows * rx.eb;
  const long long rcp = static_cast<long long>(p) * rx.rows;
  int chain_rows = rx.rows;
  if constexpr (kList)   // the shard's live relax chunks
    chain_rows = rx.bounds[static_cast<long long>(p) * (n_vtiles + 1) +
                           n_vtiles];
  const rg::Chain ch{o, {vs, vs + words},
                     kList ? nullptr : rx.ct + rcp, rx.a + rlay, rx.w + rlay,
                     rx.rel + rlay, rx.mask + rlay, bp, n_vtiles, chain_rows,
                     rx.eb, vb, n_sweeps, kList ? rx.idx + rcp : nullptr,
                     rx.chunks};
  // no live chunk: the sweeps relax nothing
  if constexpr (kList) active = active && chain_rows > 0;
  int r;
  const int count = rg::sweeps<kHazard, kList>(smem, L, ch, active, &r);
  rg::unpack_bits(resid + roff, ch.bits[r], bp, rg::kThreads);

  // ---- send (the relaxed row is final behind the chain's barrier) ----
  const float* ls = last + soff;
  const int* svd = valid + static_cast<long long>(p) * sp;
  float* vo = val + soff;
  float* nl = new_last + soff;
  const long long tlay = static_cast<long long>(p) * tx.rows * tx.eb;
  const int* src = tx.a + tlay;
  const float* w = tx.w + tlay;
  const int* seg = tx.rel + tlay;
  const int* prn = tx.mask + tlay;
  int scount = 0;
  reduce_by_warp<kList>(
      tx.bounds + static_cast<long long>(p) * (tx.n_tiles + 1),
      kList ? tx.idx + static_cast<long long>(p) * tx.rows : nullptr,
      tx.n_tiles, tx.eb, sl,
      [&](long long i, int& r, int& k) {
        const float wi = w[i];
        const int pi = prn[i], si = src[i];
        r = seg[i];
        if (wi < repro::inf_f() && pi == 0) k = rg::cand_key(o[si] + wi);
      },
      [&](int t) {
        for (int x = lane; x < sb; x += 32) {
          const int slot = t * sb + x;
          const float mv = repro::key_value(sl[x]);
          const float before = ls[slot];
          const bool improved = svd[slot] > 0 && mv < before;
          vo[slot] = improved ? mv : repro::inf_f();
          nl[slot] = improved ? mv : before;
          scount += improved;
          sl[x] = repro::kInfBits;
        }
      });

  if (count) atomicAdd(&totals[0], count);
  if (scount) atomicAdd(&totals[1], scount);
  __syncthreads();
  if (tid == 0) {
    nrel[row] = totals[0];
    sends[row] = totals[1];
  }
}

// the per-warp tiles of kernels 8 and 7, bytes
int warp_tiles(int vb, int sb) {
  return repro::ragged::kWarps * (vb > sb ? vb : sb) * 4;
}

template <bool kHazard, bool kList>
int launch_chain(const float* dist, const float* front, const float* live,
                 const float* inc, const float* last, const int* valid,
                 Stage mx, Stage rx, Stage tx, float* out, float* resid,
                 float* val, float* new_last, int* nrel, int* sends,
                 uint32_t* vstate, int P, int K, int bp, int sp, int m,
                 int dense, int vb, int sb, int n_sweeps,
                 cudaStream_t stream) {
  namespace rg = repro::ragged;
  const int extra = warp_tiles(vb, sb);
  const int need = rg::scratch_bytes(bp, rx.n_tiles, rx.eb, vb, extra);
  if (need < 0 || (need > 0 && vstate == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bits_smem = need == 0;
  const rg::Layout L = rg::smem_layout(
      rx.eb, vb, rx.n_tiles, extra, bits_smem ? rg::vstate_bytes(bp) : 0);
  auto kernel = fused_round_chain_kernel<kHazard, kList>;
  cudaError_t err = repro::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P * K, rg::kThreads, L.total, stream>>>(
      dist, front, live, inc, last, valid, mx, rx, tx, out, resid, val,
      new_last, nrel, sends, vstate, K, bp, sp, m, dense, vb, sb, n_sweeps,
      bits_smem);
  return static_cast<int>(cudaGetLastError());
}

template <bool kList>
int launch(const float* dist, const float* front, const float* live,
           const float* inc, const float* last, const int* valid, Stage mx,
           Stage rx, Stage tx, float* out, float* resid, float* val,
           float* new_last, int* nrel, int* sends, uint32_t* vstate, int P,
           int K, int bp, int sp, int m, int dense, int vb, int sb,
           int n_sweeps, int hazard, cudaStream_t stream) {
  if (P * K == 0) return 0;
  if (!hazard)
    return launch_chain<false, kList>(dist, front, live, inc, last, valid,
                                      mx, rx, tx, out, resid, val, new_last,
                                      nrel, sends, vstate, P, K, bp, sp, m,
                                      dense, vb, sb, n_sweeps, stream);
  return launch_chain<true, kList>(dist, front, live, inc, last, valid, mx,
                                   rx, tx, out, resid, val, new_last, nrel,
                                   sends, vstate, P, K, bp, sp, m, dense, vb,
                                   sb, n_sweeps, stream);
}

}  // namespace

// Bytes of vertex state a row of kernel 8 or 7 needs in device memory: 0
// when its bitmasks fit in shared memory, -1 when the row is past the
// chain's cap (sweeps_ragged.cuh: layout_fits).
extern "C" int round_ragged_scratch_bytes(int bp, int n_vtiles, int eb,
                                          int vb, int sb) {
  return repro::ragged::scratch_bytes(bp, n_vtiles, eb, vb,
                                      warp_tiles(vb, sb));
}

// Kernel 7. Dense layouts: mx [P, bp / vb, mx_chunks, mx_eb] (unused when
// dense), rx [P, bp / vb, rx_chunks, rx_eb], tx [P, sp / sb, tx_chunks,
// tx_eb], each with its live chunks *_idx [P, tiles * chunks] and their
// tile ranges *_bounds [P, tiles + 1] (common.py: live_chunks). vstate
// [P * K, round_ragged_scratch_bytes / 4] or null when that is 0. hazard 0
// is the planted fault of the checks.
extern "C" int fused_round_tiled(
    const float* dist, const float* front, const float* live, const float* inc,
    const float* last, const int* valid, const int* mx_idx,
    const int* mx_bounds, const int* mx_pos, const int* mx_dstrel,
    const int* mx_valid, const int* rx_idx, const int* rx_bounds,
    const int* rx_src, const float* rx_w, const int* rx_dstrel,
    const int* rx_pruned, const int* tx_idx, const int* tx_bounds,
    const int* tx_src, const float* tx_w, const int* tx_segrel,
    const int* tx_pruned, float* out, float* resid, float* val,
    float* new_last, int* nrel, int* sends, uint32_t* vstate, int P, int K,
    int bp, int sp, int m, int dense, int mx_chunks, int mx_eb,
    int rx_chunks, int rx_eb, int tx_chunks, int tx_eb, int vb, int sb,
    int n_sweeps, int hazard, cudaStream_t stream) {
  const int n_vtiles = bp / vb;
  const int n_stiles = sp / sb;
  const Stage mx{nullptr, mx_bounds, mx_idx, mx_pos, nullptr, mx_dstrel,
                 mx_valid, n_vtiles * mx_chunks, mx_chunks, n_vtiles, mx_eb};
  const Stage rx{nullptr, rx_bounds, rx_idx, rx_src, rx_w, rx_dstrel,
                 rx_pruned, n_vtiles * rx_chunks, rx_chunks, n_vtiles, rx_eb};
  const Stage tx{nullptr, tx_bounds, tx_idx, tx_src, tx_w, tx_segrel,
                 tx_pruned, n_stiles * tx_chunks, tx_chunks, n_stiles, tx_eb};
  return launch<true>(dist, front, live, inc, last, valid, mx, rx, tx, out,
                      resid, val, new_last, nrel, sends, vstate, P, K, bp, sp,
                      m, dense, vb, sb, n_sweeps, hazard, stream);
}

// Kernel 8. Ragged layouts: flat chunk rows [P, *_rows, *_eb]; the merge
// and send layouts with their tile -> chunk ranges *_bounds [P, n_tiles +
// 1] (chunk_bounds), the relax layout with its chunk -> tile map rx_ct
// [P, rx_rows] (mx unused when dense). vstate [P * K,
// round_ragged_scratch_bytes / 4] or null when that is 0. hazard 0 is the
// planted fault of the checks.
extern "C" int fused_round_ragged(
    const float* dist, const float* front, const float* live, const float* inc,
    const float* last, const int* valid, const int* mx_bounds,
    const int* mx_pos, const int* mx_dstrel, const int* mx_valid,
    const int* rx_ct, const int* rx_src, const float* rx_w,
    const int* rx_dstrel, const int* rx_pruned, const int* tx_bounds,
    const int* tx_src, const float* tx_w, const int* tx_segrel,
    const int* tx_pruned, float* out, float* resid, float* val,
    float* new_last, int* nrel, int* sends, uint32_t* vstate, int P, int K,
    int bp, int sp, int m, int dense, int mx_rows, int mx_eb, int rx_rows,
    int rx_eb, int tx_rows, int tx_eb, int vb, int sb, int n_sweeps,
    int hazard, cudaStream_t stream) {
  const int n_vtiles = bp / vb;
  const int n_stiles = sp / sb;
  const Stage mx{nullptr, mx_bounds, nullptr, mx_pos, nullptr, mx_dstrel,
                 mx_valid, mx_rows, 1, n_vtiles, mx_eb};
  const Stage rx{rx_ct, nullptr, nullptr, rx_src, rx_w, rx_dstrel, rx_pruned,
                 rx_rows, 1, n_vtiles, rx_eb};
  const Stage tx{nullptr, tx_bounds, nullptr, tx_src, tx_w, tx_segrel,
                 tx_pruned, tx_rows, 1, n_stiles, tx_eb};
  return launch<false>(dist, front, live, inc, last, valid, mx, rx, tx, out,
                       resid, val, new_last, nrel, sends, vstate, P, K, bp,
                       sp, m, dense, vb, sb, n_sweeps, hazard, stream);
}
