// Merge-phase scatter-min of the incoming [K, P*C] boundary messages.
//
// Replaces: kernels/merge/merge.py: merge_scatter_tiled (the Pallas kernel
// _merge_scatter_kernel, grid (vertex tile, chunk)).
//
// What it computes: for vertex tile i of shard p, new = min(dist, incoming
// messages routed to the tile through the static msg-tiled layout (pos,
// dstrel, valid)), the next frontier new < dist, and per-query counts of
// finite messages received.
//
// What bounds it: bytes. The layout (pos, dstrel, valid) is read once per
// merge for all K queries; the message gathers and the [K, block] rows are
// the rest. There is one min per (message, query).
//
// Design: one CTA per (shard, vertex tile), a grid of P*n_vtiles, with no
// dependency between tiles. The CTA seeds a [K, VB] shared-memory tile
// with the current distances, loops over the tile's chunks and the K
// queries, and min-reduces each finite message into the tile
// (tile_min_into). Receive counts are taken a warp at a time with a ballot
// and summed in shared memory, then added to the [P, K] output with one
// atomicAdd per query. The finalizer (new row, frontier plane) runs in the
// same CTA.
#include "tile_reduce.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
merge_scatter_tiled_kernel(const float* __restrict__ dist,
                           const float* __restrict__ incoming,
                           const int* __restrict__ pos_t,
                           const int* __restrict__ dstrel_t,
                           const int* __restrict__ valid_t, float* out,
                           float* front, int* recvs, int K, int bp, int m,
                           int n_vtiles, int n_chunks, int eb, int vb) {
  extern __shared__ int smem[];
  int* tile = smem;                        // [K, vb] int-reinterpreted minima
  int* cnt = smem + K * vb;                // [K] finite messages seen
  const int p = blockIdx.x / n_vtiles;
  const int i = blockIdx.x % n_vtiles;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  for (int x = tid; x < K * vb; x += nt) {
    const int q = x / vb;
    tile[x] = __float_as_int(
        dist[(static_cast<long long>(p) * K + q) * bp + i * vb + x % vb]);
  }
  for (int q = tid; q < K; q += nt) cnt[q] = 0;
  __syncthreads();

  const float* in = incoming + static_cast<long long>(p) * K * m;
  const long long base = (static_cast<long long>(p) * n_vtiles + i) * n_chunks * eb;
  for (int j = 0; j < n_chunks; ++j) {
    const long long c = base + static_cast<long long>(j) * eb;
    // warp-uniform trip count, so every lane takes part in the ballots
    for (int e0 = 0; e0 < eb; e0 += nt) {
      const int e = e0 + tid;
      const bool ok = e < eb && valid_t[c + e] > 0;
      const int ps = ok ? pos_t[c + e] : 0;
      const int r = ok ? dstrel_t[c + e] : 0;
      for (int q = 0; q < K; ++q) {
        const float v = ok ? in[static_cast<long long>(q) * m + ps] : repro::inf_f();
        const bool fin = v < repro::inf_f();
        const unsigned b = __ballot_sync(0xffffffffu, fin);
        if (lane == 0 && b) atomicAdd(cnt + q, __popc(b));
        if (fin) atomicMin(tile + q * vb + r, __float_as_int(v));
      }
    }
  }
  __syncthreads();

  for (int x = tid; x < K * vb; x += nt) {
    const int q = x / vb;
    const long long o = (static_cast<long long>(p) * K + q) * bp + i * vb + x % vb;
    const float nv = __int_as_float(tile[x]);
    out[o] = nv;
    front[o] = nv < dist[o] ? 1.f : 0.f;
  }
  __syncthreads();
  for (int q = tid; q < K; q += nt)
    if (cnt[q]) atomicAdd(recvs + p * K + q, cnt[q]);
}

}  // namespace

extern "C" int merge_scatter_tiled(const float* dist, const float* incoming,
                                   const int* pos_t, const int* dstrel_t,
                                   const int* valid_t, float* out, float* front,
                                   int* recvs, int P, int K, int bp, int m,
                                   int n_vtiles, int n_chunks, int eb, int vb,
                                   cudaStream_t stream) {
  if (P * K * n_vtiles == 0) return 0;
  const size_t smem = static_cast<size_t>(K) * (vb + 1) * sizeof(int);
  cudaError_t err = repro::allow_smem(merge_scatter_tiled_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_scatter_tiled_kernel<<<P * n_vtiles, repro::kThreads, smem, stream>>>(
      dist, incoming, pos_t, dstrel_t, valid_t, out, front, recvs, K, bp, m,
      n_vtiles, n_chunks, eb, vb);
  return static_cast<int>(cudaGetLastError());
}
