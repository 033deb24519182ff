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
// Kernel 7 (dense layouts): merge and send walk their chunks in layout
// order and reduce each run of chunks of one tile into a shared tile
// (tile_min_into), flushed when the tile changes (merge mins the tile into
// the row; send finalizes the slot tile); the relax stage is sweeps.cuh.
// What bounds it: the relax stage's dependent chain (see relax.cu), and
// then the walk of every merge and send chunk of the shard by each of the
// shard's K CTAs, with a pair of block barriers at every tile change.
//
// Kernel 8 (ragged layouts), redesigned for Hopper. The relax stage is the
// chain of sweeps_ragged.cuh (a producer warp streams the layout through a
// ring of bulk copies; frontier and improved sets as shared bitmasks;
// distance gathers issued two chunks ahead with the hazard re-read). Merge
// and send have no chain: every tile reduces on its own. Each warp takes
// whole tiles (tile i to warp i mod 17), walks the tile's chunk range from
// the tile -> chunk bounds the engine derives once (chunk_bounds; ctile
// does not decrease, so a tile's chunks are contiguous), reduces into its
// own slice of shared memory and finalizes the tile: merge mins it into
// the row; send finalizes the slot tile against last_sent. A slot tile with
// no chunk finalizes to +inf and last_sent, as the reference's global
// finalize leaves it. No block barrier per chunk or per tile: only between
// stages (send reads the relaxed row). What bounds it now: the relax
// stage's chain of chunk steps (see sweeps_ragged.cuh), then bytes: each
// of a shard's K rows reads the shard's merge and send layouts once (at
// scale-1e7 with K = 16, 2.9 GB of send layout a launch, more than L2
// holds, so device memory's rate) beside a gather a slot.
#include "sweeps.cuh"
#include "sweeps_ragged.cuh"

namespace {

// One stage's chunk rows [P, rows, eb]: a = src (relax, send) or pos
// (merge), w = weights (null for merge), rel = tile-relative target,
// mask = pruned (relax, send) or valid (merge). ct: the ragged chunk ->
// tile map [P, rows] (kernel 8's relax stage); bounds: the ragged tile ->
// chunk ranges [P, n_tiles + 1] (kernel 8's merge and send); both null in
// the dense layout.
struct Stage {
  const int* ct;
  const int* bounds;
  const int* a;
  const float* w;
  const int* rel;
  const int* mask;
  int rows;            // chunks per shard
  int chunks;          // chunks per tile (dense layout), else 1
  int n_tiles;
  int eb;
};

// Kernel 7: walk the stage's dense chunks in order, calling cand(i) for
// every edge slot i (shard-relative) to reduce it into the shared tile,
// and flush(t) once after each run of chunks of tile t.
template <typename Cand, typename Flush>
__device__ void reduce_by_tile(const Stage& st, Cand cand, Flush flush) {
  int cur = -1;
  for (int c = 0; c < st.rows; ++c) {
    const int t = c / st.chunks;
    if (t != cur) {
      __syncthreads();
      if (cur >= 0) flush(cur);
      __syncthreads();
      cur = t;
    }
    const long long base = static_cast<long long>(c) * st.eb;
    for (int e = threadIdx.x; e < st.eb; e += blockDim.x) cand(base + e);
  }
  __syncthreads();
  if (cur >= 0) flush(cur);
  __syncthreads();
}

__global__ void __launch_bounds__(repro::kThreads)
fused_round_kernel(const float* __restrict__ dist,
                   const float* __restrict__ front,
                   const float* __restrict__ live,
                   const float* __restrict__ inc,
                   const float* __restrict__ last,
                   const int* __restrict__ valid, Stage mx, Stage rx,
                   Stage tx, float* out, float* resid, float* val,
                   float* new_last, int* nrel, int* sends, float* prev,
                   float* fcur, int K, int bp, int sp, int m, int dense,
                   int vb, int sb, int n_sweeps) {
  extern __shared__ int tile[];            // [max(vb, sb)] minima as keys
  __shared__ int totals[2];                // relaxations, sends
  const int row = blockIdx.x;              // p * K + q
  const int p = row / K;
  const long long roff = static_cast<long long>(row) * bp;
  const long long soff = static_cast<long long>(row) * sp;
  const float* d = dist + roff;
  float* o = out + roff;
  float* pv = prev + roff;
  float* fc = fcur + roff;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int v = tid; v < max(vb, sb); v += nt) tile[v] = repro::kInfBits;
  if (tid < 2) totals[tid] = 0;

  // ---- merge ----
  const float* in = inc + static_cast<long long>(row) * m;
  if (dense) {
    for (int v = tid; v < bp; v += nt) o[v] = in[v] < d[v] ? in[v] : d[v];
  } else {
    for (int v = tid; v < bp; v += nt) o[v] = d[v];
    const long long lay = static_cast<long long>(p) * mx.rows * mx.eb;
    const int* pos = mx.a + lay;
    const int* rel = mx.rel + lay;
    const int* ok = mx.mask + lay;
    reduce_by_tile(
        mx,
        [&](long long i) {
          if (ok[i] > 0) repro::tile_min_into(tile, rel[i], in[pos[i]]);
        },
        [&](int t) {
          float* ot = o + static_cast<long long>(t) * vb;
          for (int v = tid; v < vb; v += nt) {
            const float mv = repro::key_value(tile[v]);
            if (mv < ot[v]) ot[v] = mv;
            tile[v] = repro::kInfBits;
          }
        });
  }
  __syncthreads();
  // the round's frontier and the first sweep's snapshot
  const bool lv = live[row] > 0.f;
  int any = 0;
  for (int v = tid; v < bp; v += nt) {
    const float ov = o[v];
    const float f = fmaxf(lv && ov < d[v] ? 1.f : 0.f, front[roff + v]);
    fc[v] = f;
    pv[v] = ov;
    any |= f > 0.f;
  }
  const int active = __syncthreads_or(any);

  // ---- relax ----
  const long long rlay = static_cast<long long>(p) * rx.rows * rx.eb;
  const int count = repro::relax_sweeps(
      o, pv, fc, tile, active, rx.a + rlay, rx.w + rlay, rx.rel + rlay,
      rx.mask + rlay, bp, rx.rows, rx.chunks, rx.eb, vb, n_sweeps);
  for (int v = tid; v < bp; v += nt) resid[roff + v] = o[v] < pv[v] ? 1.f : 0.f;

  // ---- send ----
  const float* ls = last + soff;
  const int* sv = valid + static_cast<long long>(p) * sp;
  float* vo = val + soff;
  float* nl = new_last + soff;
  for (int x = tid; x < sp; x += nt) {     // slot tiles with no chunk
    vo[x] = repro::inf_f();
    nl[x] = ls[x];
  }
  const long long tlay = static_cast<long long>(p) * tx.rows * tx.eb;
  const int* src = tx.a + tlay;
  const float* w = tx.w + tlay;
  const int* seg = tx.rel + tlay;
  const int* prn = tx.mask + tlay;
  int scount = 0;
  reduce_by_tile(
      tx,
      [&](long long i) {
        const float wi = prn[i] > 0 ? repro::inf_f() : w[i];
        if (wi < repro::inf_f()) repro::tile_min_into(tile, seg[i], o[src[i]] + wi);
      },
      [&](int t) {
        for (int x = tid; x < sb; x += nt) {
          const int slot = t * sb + x;
          const float mv = repro::key_value(tile[x]);
          const float before = ls[slot];
          const bool improved = sv[slot] > 0 && mv < before;
          vo[slot] = improved ? mv : repro::inf_f();
          nl[slot] = improved ? mv : before;
          scount += improved;
          tile[x] = repro::kInfBits;
        }
      });

  atomicAdd(&totals[0], count);
  atomicAdd(&totals[1], scount);
  __syncthreads();
  if (tid == 0) {
    nrel[row] = totals[0];
    sends[row] = totals[1];
  }
}

// Kernel 8's merge and send: warp w of the block takes tiles w, w + 17,
// ...; for tile i it reduces the edge slots of the tile's chunk range
// [b[i], b[i+1]) into the warp's own tile of keys sl, then finalizes the
// tile (flush(i)). No block barrier: tiles are independent. item(x, rel,
// key) reads slot x (shard-relative) into its target and key (left at
// kInfBits for no candidate). Each slot is a load of the layout planes and
// a dependent gather, two round trips to device memory, so the lanes take
// a chunk's worth of slots, 16 each, before reducing: 16 chains of each
// warp in flight.
template <typename Item, typename Flush>
__device__ void reduce_by_warp(const int* b, int n_tiles, int eb, int* sl,
                               Item item, Flush flush) {
  constexpr int kUnroll = 16;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < n_tiles; i += repro::ragged::kWarps) {
    const long long x1 = static_cast<long long>(b[i + 1]) * eb;
    for (long long x = static_cast<long long>(b[i]) * eb + lane; x - lane < x1;
         x += kUnroll * 32) {
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
    __syncwarp();
    flush(i);
    __syncwarp();
  }
}

// Kernel 8: one block of ragged::kThreads per (shard, query) row. vstate:
// the rows' vertex state in device memory, used only when it does not fit
// in shared memory (bits_smem 0).
template <bool kHazard>
__global__ void __launch_bounds__(repro::ragged::kThreads, 1)
fused_round_ragged_kernel(const float* __restrict__ dist,
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
    reduce_by_warp(
        mx.bounds + static_cast<long long>(p) * (mx.n_tiles + 1), mx.n_tiles,
        mx.eb, sl,
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
  const int active = __syncthreads_or(any != 0);

  // ---- relax ----
  const long long rlay = static_cast<long long>(p) * rx.rows * rx.eb;
  const rg::Chain ch{o, {vs, vs + words},
                     rx.ct + static_cast<long long>(p) * rx.rows, rx.a + rlay,
                     rx.w + rlay, rx.rel + rlay, rx.mask + rlay, bp, n_vtiles,
                     rx.rows, rx.eb, vb, n_sweeps};
  int r;
  const int count = rg::sweeps<kHazard>(smem, L, ch, active, &r);
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
  reduce_by_warp(
      tx.bounds + static_cast<long long>(p) * (tx.n_tiles + 1), tx.n_tiles,
      tx.eb, sl,
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

int launch_tiled(const float* dist, const float* front, const float* live,
                 const float* inc, const float* last, const int* valid,
                 Stage mx, Stage rx, Stage tx, float* out, float* resid,
                 float* val, float* new_last, int* nrel, int* sends,
                 float* prev, float* fcur, int P, int K, int bp, int sp,
                 int m, int dense, int vb, int sb, int n_sweeps,
                 cudaStream_t stream) {
  if (P * K == 0) return 0;
  const size_t smem = static_cast<size_t>(vb > sb ? vb : sb) * sizeof(int);
  cudaError_t err = repro::allow_smem(fused_round_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_round_kernel<<<P * K, repro::kThreads, smem, stream>>>(
      dist, front, live, inc, last, valid, mx, rx, tx, out, resid, val,
      new_last, nrel, sends, prev, fcur, K, bp, sp, m, dense, vb, sb,
      n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

// kernel 8's per-warp tiles, bytes
int warp_tiles(int vb, int sb) {
  return repro::ragged::kWarps * (vb > sb ? vb : sb) * 4;
}

template <bool kHazard>
int launch_ragged(const float* dist, const float* front, const float* live,
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
  auto kernel = fused_round_ragged_kernel<kHazard>;
  cudaError_t err = repro::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P * K, rg::kThreads, L.total, stream>>>(
      dist, front, live, inc, last, valid, mx, rx, tx, out, resid, val,
      new_last, nrel, sends, vstate, K, bp, sp, m, dense, vb, sb, n_sweeps,
      bits_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dense layouts: mx [P, bp / vb, mx_chunks, mx_eb] (unused when dense),
// rx [P, bp / vb, rx_chunks, rx_eb], tx [P, sp / sb, tx_chunks, tx_eb].
extern "C" int fused_round_tiled(
    const float* dist, const float* front, const float* live, const float* inc,
    const float* last, const int* valid, const int* mx_pos,
    const int* mx_dstrel, const int* mx_valid, const int* rx_src,
    const float* rx_w, const int* rx_dstrel, const int* rx_pruned,
    const int* tx_src, const float* tx_w, const int* tx_segrel,
    const int* tx_pruned, float* out, float* resid, float* val,
    float* new_last, int* nrel, int* sends, float* prev, float* fcur, int P,
    int K, int bp, int sp, int m, int dense, int mx_chunks, int mx_eb,
    int rx_chunks, int rx_eb, int tx_chunks, int tx_eb, int vb, int sb,
    int n_sweeps, cudaStream_t stream) {
  const int n_vtiles = bp / vb;
  const int n_stiles = sp / sb;
  const Stage mx{nullptr, nullptr, mx_pos, nullptr, mx_dstrel, mx_valid,
                 n_vtiles * mx_chunks, mx_chunks, n_vtiles, mx_eb};
  const Stage rx{nullptr, nullptr, rx_src, rx_w, rx_dstrel, rx_pruned,
                 n_vtiles * rx_chunks, rx_chunks, n_vtiles, rx_eb};
  const Stage tx{nullptr, nullptr, tx_src, tx_w, tx_segrel, tx_pruned,
                 n_stiles * tx_chunks, tx_chunks, n_stiles, tx_eb};
  return launch_tiled(dist, front, live, inc, last, valid, mx, rx, tx, out,
                      resid, val, new_last, nrel, sends, prev, fcur, P, K, bp,
                      sp, m, dense, vb, sb, n_sweeps, stream);
}

// Bytes of vertex state a row of kernel 8 needs in device memory: 0 when
// its bitmasks fit in shared memory, -1 when the row is past the chain's
// cap (sweeps_ragged.cuh: layout_fits).
extern "C" int round_ragged_scratch_bytes(int bp, int n_vtiles, int eb,
                                          int vb, int sb) {
  return repro::ragged::scratch_bytes(bp, n_vtiles, eb, vb,
                                      warp_tiles(vb, sb));
}

// Ragged layouts: flat chunk rows [P, *_rows, *_eb]; the merge and send
// layouts with their tile -> chunk ranges *_bounds [P, n_tiles + 1]
// (chunk_bounds), the relax layout with its chunk -> tile map rx_ct
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
  if (P * K == 0) return 0;
  const int n_vtiles = bp / vb;
  const int n_stiles = sp / sb;
  const Stage mx{nullptr, mx_bounds, mx_pos, nullptr, mx_dstrel, mx_valid,
                 mx_rows, 1, n_vtiles, mx_eb};
  const Stage rx{rx_ct, nullptr, rx_src, rx_w, rx_dstrel, rx_pruned, rx_rows,
                 1, n_vtiles, rx_eb};
  const Stage tx{nullptr, tx_bounds, tx_src, tx_w, tx_segrel, tx_pruned,
                 tx_rows, 1, n_stiles, tx_eb};
  if (!hazard)
    return launch_ragged<false>(dist, front, live, inc, last, valid, mx, rx,
                                tx, out, resid, val, new_last, nrel, sends,
                                vstate, P, K, bp, sp, m, dense, vb, sb,
                                n_sweeps, stream);
  return launch_ragged<true>(dist, front, live, inc, last, valid, mx, rx, tx,
                             out, resid, val, new_last, nrel, sends, vstate,
                             P, K, bp, sp, m, dense, vb, sb, n_sweeps, stream);
}
