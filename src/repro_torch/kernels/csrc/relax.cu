// K-query local fixpoint over the dst-tiled local edges, dense and ragged.
//
// Replaces: kernels/relax/relax.py: relax_dst_tiled_fixpoint_batch (the
// Pallas kernel _relax_fixpoint_batch_kernel, grid (sweep, vtile, chunk,
// query)) and relax_dst_ragged_fixpoint_batch (the Pallas kernel
// _relax_ragged_fixpoint_batch_kernel, grid (sweep, chunk, query), with the
// chunk->tile map ctile scalar-prefetched).
//
// What it computes, per (shard, query) row: up to n_sweeps frontier-chased
// Gauss-Seidel min-plus sweeps. A sweep walks the shard's edge chunks in
// layout order; each chunk gathers dist[src] + w for the edges whose source
// is in the sweep's frontier (Trishla-pruned edges count as +inf),
// min-reduces them per destination, and mins its vertex tile into the live
// row, so later chunks see earlier improvements. The dense layout holds
// n_chunks chunks for every tile (chunk c is in tile c / n_chunks); the
// ragged layout holds only each tile's own chunks, flat, with chunk c in
// tile min(ctile[c], n_vtiles - 1): the padding chunks that stack shards
// to one chunk count carry the sentinel tile and w = +inf, so they are
// no-ops. The ragged order is the dense order minus the dense layout's
// all-padding chunks, so both give the same rows and the same counts. A
// row whose sweep changes nothing stops (the per-query early-out).
// Outputs: the distances, the residual frontier (vertices improved in the
// last sweep run) and the per-query relaxation count.
//
// What bounds it: the order. Each chunk reads the row that every earlier
// chunk of the sweep wrote, so the work of one row is a chain of
// n_sweeps * chunks-per-shard dependent steps, each a gather, a block
// barrier, a shared-memory reduce and a barrier. Bytes are not the limit.
// The ragged layout shortens that chain to the chunks that hold edges.
//
// Design: one CTA per (shard, query) row, a grid of P*K. The CTA walks
// sweeps -> chunks in the Pallas grid order, which reproduces the
// reference's sequence of reads and writes exactly, so the relaxation
// count is exact and not merely bounded. Per chunk every thread gathers
// and atomicMins its candidates into a shared VB-tile (tile_min_into);
// after a barrier the tile is min'd into the row, then reset. The gathers
// of a chunk all precede its writes, as in the reference. The rows (live
// distances, previous sweep, frontier) stay in global memory, reached
// through L1 and L2. Parallelism is only P*K CTAs: this is the simple,
// exact design, to be made faster later. One template serves both
// layouts; kRagged picks the tile map.
#include "sweeps.cuh"

namespace {

template <bool kRagged>
__global__ void __launch_bounds__(repro::kThreads)
relax_fixpoint_kernel(const float* __restrict__ dist,
                      const float* __restrict__ front,
                      const int* __restrict__ ctile,
                      const int* __restrict__ src_t,
                      const float* __restrict__ w_t,
                      const int* __restrict__ dstrel_t,
                      const int* __restrict__ pruned_t, float* out,
                      float* resid, int* nrel, float* prev, float* fcur, int K,
                      int bp, int n_vtiles, int n_rows, int n_chunks, int eb,
                      int vb, int n_sweeps) {
  extern __shared__ int tile[];            // [vb] int-reinterpreted minima
  __shared__ int total;
  const int row = blockIdx.x;              // p * K + q
  const int p = row / K;
  const long long roff = static_cast<long long>(row) * bp;
  // n_rows chunks of eb edges per shard: n_vtiles * n_chunks dense,
  // total_chunks ragged
  const long long lay = static_cast<long long>(p) * n_rows * eb;
  const int* ct = kRagged ? ctile + static_cast<long long>(p) * n_rows : nullptr;
  float* o = out + roff;
  float* pv = prev + roff;
  float* fc = fcur + roff;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  int any = 0;
  for (int v = tid; v < bp; v += nt) {
    const float d = dist[roff + v];
    const float f = front[roff + v];
    o[v] = d;
    pv[v] = d;
    fc[v] = f;
    any |= f > 0.f;
  }
  for (int v = tid; v < vb; v += nt) tile[v] = repro::kInfBits;
  if (tid == 0) total = 0;
  const int active = __syncthreads_or(any);

  const int count = repro::relax_sweeps<kRagged>(
      o, pv, fc, tile, active, ct, src_t + lay, w_t + lay, dstrel_t + lay,
      pruned_t + lay, bp, n_vtiles, n_rows, n_chunks, eb, vb, n_sweeps);

  for (int v = tid; v < bp; v += nt) resid[roff + v] = o[v] < pv[v] ? 1.f : 0.f;
  atomicAdd(&total, count);
  __syncthreads();
  if (tid == 0) nrel[row] = total;
}

template <bool kRagged>
int launch(const float* dist, const float* front, const int* ctile,
           const int* src_t, const float* w_t, const int* dstrel_t,
           const int* pruned_t, float* out, float* resid, int* nrel,
           float* prev, float* fcur, int P, int K, int bp, int n_vtiles,
           int n_rows, int n_chunks, int eb, int vb, int n_sweeps,
           cudaStream_t stream) {
  if (P * K == 0) return 0;
  const size_t smem = static_cast<size_t>(vb) * sizeof(int);
  cudaError_t err = repro::allow_smem(relax_fixpoint_kernel<kRagged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_fixpoint_kernel<kRagged><<<P * K, repro::kThreads, smem, stream>>>(
      dist, front, ctile, src_t, w_t, dstrel_t, pruned_t, out, resid, nrel,
      prev, fcur, K, bp, n_vtiles, n_rows, n_chunks, eb, vb, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dense layout [P, n_vtiles, n_chunks, eb].
extern "C" int relax_fixpoint_batch(const float* dist, const float* front,
                                    const int* src_t, const float* w_t,
                                    const int* dstrel_t, const int* pruned_t,
                                    float* out, float* resid, int* nrel,
                                    float* prev, float* fcur, int P, int K,
                                    int bp, int n_vtiles, int n_chunks, int eb,
                                    int vb, int n_sweeps, cudaStream_t stream) {
  return launch<false>(dist, front, nullptr, src_t, w_t, dstrel_t, pruned_t,
                       out, resid, nrel, prev, fcur, P, K, bp, n_vtiles,
                       n_vtiles * n_chunks, n_chunks, eb, vb, n_sweeps,
                       stream);
}

// Ragged layout [P, total_chunks, eb] with the chunk->tile map ctile
// [P, total_chunks].
extern "C" int relax_ragged_fixpoint_batch(
    const float* dist, const float* front, const int* ctile, const int* src_r,
    const float* w_r, const int* dstrel_r, const int* pruned_r, float* out,
    float* resid, int* nrel, float* prev, float* fcur, int P, int K, int bp,
    int n_vtiles, int total_chunks, int eb, int vb, int n_sweeps,
    cudaStream_t stream) {
  return launch<true>(dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, out,
                      resid, nrel, prev, fcur, P, K, bp, n_vtiles,
                      total_chunks, 1, eb, vb, n_sweeps, stream);
}
