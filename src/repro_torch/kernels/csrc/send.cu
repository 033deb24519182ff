// Send-phase pack: per message slot, min over cut edges of dist[src] + w,
// for all K queries, masked against last_sent; dense and ragged layouts.
//
// Replaces: kernels/send/send.py: send_pack_tiled (the Pallas kernel
// _send_pack_kernel, grid (slot tile, chunk)) and send_pack_ragged (the
// Pallas kernel _send_pack_ragged_kernel, grid (chunk,), with the
// chunk->tile map ctile scalar-prefetched and a global init and finalize).
//
// What it computes: for slot tile i of shard p, the per-slot minima of the
// tile's cut-edge candidates (Trishla-pruned edges count as +inf), then the
// tile finalizer of the reference: improved = valid & (min < last_sent);
// send value = min where improved, else +inf; new last_sent = min where
// improved, else the old value; per-query counts of improved slots. The
// dense layout gives every tile n_chunks chunks; the ragged layout gives
// tile i the chunk range [bounds[i], bounds[i+1]), which the builders make
// contiguous (ctile is non-decreasing) and which may be empty. The
// reference finalizes the ragged layout once, over the whole row, after
// its last chunk; finalizing per tile, after the tile's own chunks, gives
// the same values, because accumulation never reads the mask, and a tile
// with no chunks finalizes to +inf with no send, as there.
//
// What bounds it: bytes. Each layout chunk (src, w, segrel, pruned) is read
// once and serves all K queries; the distance gathers and the [K, S] rows
// are the rest of the traffic. The arithmetic is one add and one min per
// (edge, query).
//
// Design: one CTA per (shard, slot tile), a grid of P*n_stiles. Tiles have
// no dependency on each other, so they run in parallel; the CTA loops over
// the tile's chunks and, inside, over the K queries, min-reducing into a
// [K, SB] shared-memory tile (tile_min_into). The finalizer runs in the
// same CTA once all chunks are in; per-query counts are summed in shared
// memory and added to the [P, K] output with one atomicAdd per query. One
// template serves both layouts; kRagged picks how a tile finds its chunks.
#include "tile_reduce.cuh"

namespace {

template <bool kRagged>
__global__ void __launch_bounds__(repro::kThreads)
send_pack_kernel(const float* __restrict__ dist,
                 const float* __restrict__ last,
                 const int* __restrict__ valid,
                 const int* __restrict__ bounds,
                 const int* __restrict__ src_t,
                 const float* __restrict__ w_t,
                 const int* __restrict__ segrel_t,
                 const int* __restrict__ pruned_t, float* val, float* new_last,
                 int* sends, int K, int bp, int sp, int n_stiles, int n_rows,
                 int n_chunks, int eb, int sb) {
  extern __shared__ int smem[];
  int* tile = smem;                        // [K, sb] minima as keys (min_key)
  int* cnt = smem + K * sb;                // [K] improved slots
  const int p = blockIdx.x / n_stiles;
  const int i = blockIdx.x % n_stiles;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int x = tid; x < K * sb; x += nt) tile[x] = repro::kInfBits;
  for (int q = tid; q < K; q += nt) cnt[q] = 0;
  __syncthreads();

  // the tile's chunks [c0, c1) among the shard's n_rows chunks
  int c0 = i * n_chunks;
  int c1 = c0 + n_chunks;
  if (kRagged) {
    const int* b = bounds + static_cast<long long>(p) * (n_stiles + 1);
    c0 = b[i];
    c1 = b[i + 1];
  }
  const float* drow = dist + static_cast<long long>(p) * K * bp;
  const long long lay = static_cast<long long>(p) * n_rows * eb;
  for (int j = c0; j < c1; ++j) {
    const long long c = lay + static_cast<long long>(j) * eb;
    for (int e = tid; e < eb; e += nt) {
      const float w = pruned_t[c + e] > 0 ? repro::inf_f() : w_t[c + e];
      if (!(w < repro::inf_f())) continue;
      const int sv = src_t[c + e];
      const int r = segrel_t[c + e];
      for (int q = 0; q < K; ++q)
        repro::tile_min_into(tile + q * sb, r,
                             drow[static_cast<long long>(q) * bp + sv] + w);
    }
  }
  __syncthreads();

  for (int x = tid; x < K * sb; x += nt) {
    const int q = x / sb;
    const int slot = i * sb + x % sb;
    const long long o = (static_cast<long long>(p) * K + q) * sp + slot;
    const float m = repro::key_value(tile[x]);
    const float before = last[o];
    const bool improved = valid[static_cast<long long>(p) * sp + slot] > 0 && m < before;
    val[o] = improved ? m : repro::inf_f();
    new_last[o] = improved ? m : before;
    if (improved) atomicAdd(cnt + q, 1);
  }
  __syncthreads();
  for (int q = tid; q < K; q += nt)
    if (cnt[q]) atomicAdd(sends + p * K + q, cnt[q]);
}

template <bool kRagged>
int launch(const float* dist, const float* last, const int* valid,
           const int* bounds, const int* src_t, const float* w_t,
           const int* segrel_t, const int* pruned_t, float* val,
           float* new_last, int* sends, int P, int K, int bp, int sp,
           int n_stiles, int n_rows, int n_chunks, int eb, int sb,
           cudaStream_t stream) {
  if (P * K * n_stiles == 0) return 0;
  const size_t smem = static_cast<size_t>(K) * (sb + 1) * sizeof(int);
  cudaError_t err = repro::allow_smem(send_pack_kernel<kRagged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  send_pack_kernel<kRagged><<<P * n_stiles, repro::kThreads, smem, stream>>>(
      dist, last, valid, bounds, src_t, w_t, segrel_t, pruned_t, val, new_last,
      sends, K, bp, sp, n_stiles, n_rows, n_chunks, eb, sb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dense layout [P, n_stiles, n_chunks, eb].
extern "C" int send_pack_tiled(const float* dist, const float* last,
                               const int* valid, const int* src_t,
                               const float* w_t, const int* segrel_t,
                               const int* pruned_t, float* val, float* new_last,
                               int* sends, int P, int K, int bp, int sp,
                               int n_stiles, int n_chunks, int eb, int sb,
                               cudaStream_t stream) {
  return launch<false>(dist, last, valid, nullptr, src_t, w_t, segrel_t,
                       pruned_t, val, new_last, sends, P, K, bp, sp, n_stiles,
                       n_stiles * n_chunks, n_chunks, eb, sb, stream);
}

// Ragged layout [P, total_chunks, eb]; bounds [P, n_stiles + 1] are the
// tile -> chunk ranges of the chunk->tile map.
extern "C" int send_pack_ragged(const float* dist, const float* last,
                                const int* valid, const int* bounds,
                                const int* src_r, const float* w_r,
                                const int* segrel_r, const int* pruned_r,
                                float* val, float* new_last, int* sends, int P,
                                int K, int bp, int sp, int n_stiles,
                                int total_chunks, int eb, int sb,
                                cudaStream_t stream) {
  return launch<true>(dist, last, valid, bounds, src_r, w_r, segrel_r,
                      pruned_r, val, new_last, sends, P, K, bp, sp, n_stiles,
                      total_chunks, 0, eb, sb, stream);
}
