// Merge-phase scatter-min of the incoming [K, P*C] boundary messages, dense
// and ragged layouts.
//
// Replaces: kernels/merge/merge.py: merge_scatter_tiled (the Pallas kernel
// _merge_scatter_kernel, grid (vertex tile, chunk)) and merge_scatter_ragged
// (the Pallas kernel _merge_scatter_ragged_kernel, grid (chunk,), with the
// chunk->tile map ctile scalar-prefetched and a global init and finalize).
//
// What it computes: for vertex tile i of shard p, new = min(dist, incoming
// messages routed to the tile through the static msg-tiled layout (pos,
// dstrel, valid)), the next frontier new < dist, and per-query counts of
// finite messages received. The dense layout gives every tile n_chunks
// chunks; the ragged layout gives tile i the contiguous, possibly empty,
// chunk range [bounds[i], bounds[i+1]). The reference inits and finalizes
// the ragged layout once over the whole row; doing both per tile gives the
// same values, since accumulation never reads the frontier, and a tile with
// no chunks keeps its distances with an empty frontier, as there.
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
// same CTA. One template serves both layouts; kRagged picks how a tile
// finds its chunks.
#include "tile_reduce.cuh"

namespace {

template <bool kRagged>
__global__ void __launch_bounds__(repro::kThreads)
merge_scatter_kernel(const float* __restrict__ dist,
                     const float* __restrict__ incoming,
                     const int* __restrict__ bounds,
                     const int* __restrict__ pos_t,
                     const int* __restrict__ dstrel_t,
                     const int* __restrict__ valid_t, float* out, float* front,
                     int* recvs, int K, int bp, int m, int n_vtiles, int n_rows,
                     int n_chunks, int eb, int vb) {
  extern __shared__ int smem[];
  int* tile = smem;                        // [K, vb] minima as keys (min_key)
  int* cnt = smem + K * vb;                // [K] finite messages seen
  const int p = blockIdx.x / n_vtiles;
  const int i = blockIdx.x % n_vtiles;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  for (int x = tid; x < K * vb; x += nt) {
    const int q = x / vb;
    tile[x] = repro::min_key(
        dist[(static_cast<long long>(p) * K + q) * bp + i * vb + x % vb]);
  }
  for (int q = tid; q < K; q += nt) cnt[q] = 0;
  __syncthreads();

  // the tile's chunks [c0, c1) among the shard's n_rows chunks
  int c0 = i * n_chunks;
  int c1 = c0 + n_chunks;
  if (kRagged) {
    const int* b = bounds + static_cast<long long>(p) * (n_vtiles + 1);
    c0 = b[i];
    c1 = b[i + 1];
  }
  const float* in = incoming + static_cast<long long>(p) * K * m;
  const long long lay = static_cast<long long>(p) * n_rows * eb;
  for (int j = c0; j < c1; ++j) {
    const long long c = lay + static_cast<long long>(j) * eb;
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
        repro::tile_min_into(tile + q * vb, r, v);
      }
    }
  }
  __syncthreads();

  for (int x = tid; x < K * vb; x += nt) {
    const int q = x / vb;
    const long long o = (static_cast<long long>(p) * K + q) * bp + i * vb + x % vb;
    const float nv = repro::key_value(tile[x]);
    out[o] = nv;
    front[o] = nv < dist[o] ? 1.f : 0.f;
  }
  __syncthreads();
  for (int q = tid; q < K; q += nt)
    if (cnt[q]) atomicAdd(recvs + p * K + q, cnt[q]);
}

template <bool kRagged>
int launch(const float* dist, const float* incoming, const int* bounds,
           const int* pos_t, const int* dstrel_t, const int* valid_t,
           float* out, float* front, int* recvs, int P, int K, int bp, int m,
           int n_vtiles, int n_rows, int n_chunks, int eb, int vb,
           cudaStream_t stream) {
  if (P * K * n_vtiles == 0) return 0;
  const size_t smem = static_cast<size_t>(K) * (vb + 1) * sizeof(int);
  cudaError_t err = repro::allow_smem(merge_scatter_kernel<kRagged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_scatter_kernel<kRagged><<<P * n_vtiles, repro::kThreads, smem, stream>>>(
      dist, incoming, bounds, pos_t, dstrel_t, valid_t, out, front, recvs, K,
      bp, m, n_vtiles, n_rows, n_chunks, eb, vb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dense layout [P, n_vtiles, n_chunks, eb].
extern "C" int merge_scatter_tiled(const float* dist, const float* incoming,
                                   const int* pos_t, const int* dstrel_t,
                                   const int* valid_t, float* out, float* front,
                                   int* recvs, int P, int K, int bp, int m,
                                   int n_vtiles, int n_chunks, int eb, int vb,
                                   cudaStream_t stream) {
  return launch<false>(dist, incoming, nullptr, pos_t, dstrel_t, valid_t, out,
                       front, recvs, P, K, bp, m, n_vtiles,
                       n_vtiles * n_chunks, n_chunks, eb, vb, stream);
}

// Ragged layout [P, total_chunks, eb]; bounds [P, n_vtiles + 1] are the
// tile -> chunk ranges of the chunk->tile map.
extern "C" int merge_scatter_ragged(const float* dist, const float* incoming,
                                    const int* bounds, const int* pos_r,
                                    const int* dstrel_r, const int* valid_r,
                                    float* out, float* front, int* recvs,
                                    int P, int K, int bp, int m, int n_vtiles,
                                    int total_chunks, int eb, int vb,
                                    cudaStream_t stream) {
  return launch<true>(dist, incoming, bounds, pos_r, dstrel_r, valid_r, out,
                      front, recvs, P, K, bp, m, n_vtiles, total_chunks, 0, eb,
                      vb, stream);
}
