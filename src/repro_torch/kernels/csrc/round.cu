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
//   relax   up to n_sweeps Gauss-Seidel sweeps (sweeps.cuh, as in the relax
//           kernel), then the residual frontier of the last sweep run;
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
// Merge and send walk their chunks in layout order and reduce each run of
// chunks of one tile into a shared tile (tile_min_into), flushed when the
// tile changes: merge mins the tile into the row; send finalizes the slot
// tile. A tile's chunks are contiguous in both layouts (dense: by
// construction; ragged: ctile is non-decreasing, checked when the shards are
// built), so each send tile is finalized once, after all its chunks; slot
// tiles with no chunk keep the +inf / last_sent written up front, as the
// reference's global finalize leaves them.
//
// What bounds it: the relax stage's dependent chain (see relax.cu), and
// then the walk of every merge and send chunk of the shard by each of the
// shard's K CTAs: the layouts are read K times, where the staged send and
// merge kernels read them once and spread them over one CTA per tile. This
// is the simple, exact design; spreading merge and send over (shard, tile)
// CTAs behind a grid barrier is later work. One template serves both
// layouts; kRagged picks the tile maps.
#include "sweeps.cuh"

namespace {

// One stage's chunk rows [P, rows, eb]: a = src (relax, send) or pos
// (merge), w = weights (null for merge), rel = tile-relative target,
// mask = pruned (relax, send) or valid (merge).
struct Stage {
  const int* ct;       // [P, rows] chunk -> tile (ragged), else null
  const int* a;
  const float* w;
  const int* rel;
  const int* mask;
  int rows;            // chunks per shard
  int chunks;          // chunks per tile (dense layout)
  int n_tiles;
  int eb;
};

// Walk the stage's chunks of shard p in order, calling cand(i) for every
// edge slot i (shard-relative) to reduce it into the shared tile, and
// flush(t) once after each run of chunks of tile t.
template <bool kRagged, typename Cand, typename Flush>
__device__ void reduce_by_tile(const Stage& st, int p, Cand cand, Flush flush) {
  const int* ct = kRagged ? st.ct + static_cast<long long>(p) * st.rows : nullptr;
  int cur = -1;
  for (int c = 0; c < st.rows; ++c) {
    const int t = kRagged ? min(ct[c], st.n_tiles - 1) : c / st.chunks;
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

template <bool kRagged>
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
    reduce_by_tile<kRagged>(
        mx, p,
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
  const int count = repro::relax_sweeps<kRagged>(
      o, pv, fc, tile, active,
      kRagged ? rx.ct + static_cast<long long>(p) * rx.rows : nullptr,
      rx.a + rlay, rx.w + rlay, rx.rel + rlay, rx.mask + rlay, bp, rx.n_tiles,
      rx.rows, rx.chunks, rx.eb, vb, n_sweeps);
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
  reduce_by_tile<kRagged>(
      tx, p,
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

template <bool kRagged>
int launch(const float* dist, const float* front, const float* live,
           const float* inc, const float* last, const int* valid, Stage mx,
           Stage rx, Stage tx, float* out, float* resid, float* val,
           float* new_last, int* nrel, int* sends, float* prev, float* fcur,
           int P, int K, int bp, int sp, int m, int dense, int vb, int sb,
           int n_sweeps, cudaStream_t stream) {
  if (P * K == 0) return 0;
  const size_t smem = static_cast<size_t>(vb > sb ? vb : sb) * sizeof(int);
  cudaError_t err = repro::allow_smem(fused_round_kernel<kRagged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_round_kernel<kRagged><<<P * K, repro::kThreads, smem, stream>>>(
      dist, front, live, inc, last, valid, mx, rx, tx, out, resid, val,
      new_last, nrel, sends, prev, fcur, K, bp, sp, m, dense, vb, sb,
      n_sweeps);
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
  const Stage mx{nullptr, mx_pos, nullptr, mx_dstrel, mx_valid,
                 n_vtiles * mx_chunks, mx_chunks, n_vtiles, mx_eb};
  const Stage rx{nullptr, rx_src, rx_w, rx_dstrel, rx_pruned,
                 n_vtiles * rx_chunks, rx_chunks, n_vtiles, rx_eb};
  const Stage tx{nullptr, tx_src, tx_w, tx_segrel, tx_pruned,
                 n_stiles * tx_chunks, tx_chunks, n_stiles, tx_eb};
  return launch<false>(dist, front, live, inc, last, valid, mx, rx, tx, out,
                       resid, val, new_last, nrel, sends, prev, fcur, P, K,
                       bp, sp, m, dense, vb, sb, n_sweeps, stream);
}

// Ragged layouts: flat chunk rows [P, *_rows, *_eb], each with its
// chunk->tile map *_ct [P, *_rows] (mx unused when dense).
extern "C" int fused_round_ragged(
    const float* dist, const float* front, const float* live, const float* inc,
    const float* last, const int* valid, const int* mx_ct, const int* mx_pos,
    const int* mx_dstrel, const int* mx_valid, const int* rx_ct,
    const int* rx_src, const float* rx_w, const int* rx_dstrel,
    const int* rx_pruned, const int* tx_ct, const int* tx_src,
    const float* tx_w, const int* tx_segrel, const int* tx_pruned, float* out,
    float* resid, float* val, float* new_last, int* nrel, int* sends,
    float* prev, float* fcur, int P, int K, int bp, int sp, int m, int dense,
    int mx_rows, int mx_eb, int rx_rows, int rx_eb, int tx_rows, int tx_eb,
    int vb, int sb, int n_sweeps, cudaStream_t stream) {
  const int n_vtiles = bp / vb;
  const int n_stiles = sp / sb;
  const Stage mx{mx_ct, mx_pos, nullptr, mx_dstrel, mx_valid, mx_rows, 1,
                 n_vtiles, mx_eb};
  const Stage rx{rx_ct, rx_src, rx_w, rx_dstrel, rx_pruned, rx_rows, 1,
                 n_vtiles, rx_eb};
  const Stage tx{tx_ct, tx_src, tx_w, tx_segrel, tx_pruned, tx_rows, 1,
                 n_stiles, tx_eb};
  return launch<true>(dist, front, live, inc, last, valid, mx, rx, tx, out,
                      resid, val, new_last, nrel, sends, prev, fcur, P, K, bp,
                      sp, m, dense, vb, sb, n_sweeps, stream);
}
