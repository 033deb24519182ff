// Send-phase pack: per message slot, min over cut edges of dist[src] + w,
// for all K queries, masked against last_sent.
//
// Replaces: kernels/send/send.py: send_pack_tiled (the Pallas kernel
// _send_pack_kernel, grid (slot tile, chunk)).
//
// What it computes: for slot tile i of shard p, the per-slot minima of the
// tile's cut-edge candidates (Trishla-pruned edges count as +inf), then the
// tile finalizer of the reference: improved = valid & (min < last_sent);
// send value = min where improved, else +inf; new last_sent = min where
// improved, else the old value; per-query counts of improved slots.
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
// memory and added to the [P, K] output with one atomicAdd per query.
#include "tile_reduce.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
send_pack_tiled_kernel(const float* __restrict__ dist,
                       const float* __restrict__ last,
                       const int* __restrict__ valid,
                       const int* __restrict__ src_t,
                       const float* __restrict__ w_t,
                       const int* __restrict__ segrel_t,
                       const int* __restrict__ pruned_t, float* val,
                       float* new_last, int* sends, int K, int bp, int sp,
                       int n_stiles, int n_chunks, int eb, int sb) {
  extern __shared__ int smem[];
  int* tile = smem;                        // [K, sb] int-reinterpreted minima
  int* cnt = smem + K * sb;                // [K] improved slots
  const int p = blockIdx.x / n_stiles;
  const int i = blockIdx.x % n_stiles;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int x = tid; x < K * sb; x += nt) tile[x] = repro::kInfBits;
  for (int q = tid; q < K; q += nt) cnt[q] = 0;
  __syncthreads();

  const float* drow = dist + static_cast<long long>(p) * K * bp;
  const long long base = (static_cast<long long>(p) * n_stiles + i) * n_chunks * eb;
  for (int j = 0; j < n_chunks; ++j) {
    const long long c = base + static_cast<long long>(j) * eb;
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
    const float m = __int_as_float(tile[x]);
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

}  // namespace

extern "C" int send_pack_tiled(const float* dist, const float* last,
                               const int* valid, const int* src_t,
                               const float* w_t, const int* segrel_t,
                               const int* pruned_t, float* val, float* new_last,
                               int* sends, int P, int K, int bp, int sp,
                               int n_stiles, int n_chunks, int eb, int sb,
                               cudaStream_t stream) {
  if (P * K * n_stiles == 0) return 0;
  const size_t smem = static_cast<size_t>(K) * (sb + 1) * sizeof(int);
  cudaError_t err = repro::allow_smem(send_pack_tiled_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  send_pack_tiled_kernel<<<P * n_stiles, repro::kThreads, smem, stream>>>(
      dist, last, valid, src_t, w_t, segrel_t, pruned_t, val, new_last, sends,
      K, bp, sp, n_stiles, n_chunks, eb, sb);
  return static_cast<int>(cudaGetLastError());
}
