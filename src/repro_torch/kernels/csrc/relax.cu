// K-query local fixpoint over the dst-tiled local edges.
//
// Replaces: kernels/relax/relax.py: relax_dst_tiled_fixpoint_batch (the
// Pallas kernel _relax_fixpoint_batch_kernel, grid (sweep, vtile, chunk,
// query)).
//
// What it computes, per (shard, query) row: up to n_sweeps frontier-chased
// Gauss-Seidel min-plus sweeps. A sweep walks vertex tiles, then the
// tile's [EB] edge chunks; each chunk gathers dist[src] + w for the edges
// whose source is in the sweep's frontier (Trishla-pruned edges count as
// +inf), min-reduces them per destination, and mins the tile into the live
// row, so later chunks and tiles see earlier improvements. A row whose
// sweep changes nothing stops (the per-query early-out). Outputs: the
// distances, the residual frontier (vertices improved in the last sweep
// run) and the per-query relaxation count.
//
// What bounds it: the order. Each chunk reads the row that every earlier
// chunk of the sweep wrote, so the work of one row is a chain of
// n_sweeps * n_vtiles * n_chunks dependent steps, each a gather, a block
// barrier, a shared-memory reduce and a barrier. Bytes are not the limit.
//
// Design: one CTA per (shard, query) row, a grid of P*K. The CTA walks
// sweeps -> tiles -> chunks in the Pallas grid order, which reproduces the
// reference's sequence of reads and writes exactly, so the relaxation
// count is exact and not merely bounded. Per chunk every thread gathers
// and atomicMins its candidates into a shared VB-tile (tile_min_into);
// after a barrier the tile is min'd into the row, then reset. The gathers
// of a chunk all precede its writes, as in the reference. The rows (live
// distances, previous sweep, frontier) stay in global memory, where the
// row of a 8,192-vertex block (32 KB) stays resident in L1/L2. Parallelism
// is only P*K CTAs: this is the simple, exact design, to be made faster
// later.
#include "tile_reduce.cuh"

namespace {

__global__ void __launch_bounds__(repro::kThreads)
relax_fixpoint_batch_kernel(const float* __restrict__ dist,
                            const float* __restrict__ front,
                            const int* __restrict__ src_t,
                            const float* __restrict__ w_t,
                            const int* __restrict__ dstrel_t,
                            const int* __restrict__ pruned_t,
                            float* out, float* resid, int* nrel, float* prev,
                            float* fcur, int K, int bp, int n_vtiles,
                            int n_chunks, int eb, int vb, int n_sweeps) {
  extern __shared__ int tile[];            // [vb] int-reinterpreted minima
  __shared__ int total;
  const int row = blockIdx.x;              // p * K + q
  const int p = row / K;
  const long long roff = static_cast<long long>(row) * bp;
  const long long lay = static_cast<long long>(p) * n_vtiles * n_chunks * eb;
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
  int active = __syncthreads_or(any);

  int count = 0;
  for (int s = 0; s < n_sweeps && active; ++s) {
    if (s > 0) {
      // advance the frontier: vertices improved during sweep s-1
      int anyf = 0;
      for (int v = tid; v < bp; v += nt) {
        const float ov = o[v];
        const bool nf = ov < pv[v];
        fc[v] = nf ? 1.f : 0.f;
        pv[v] = ov;
        anyf |= nf;
      }
      active = __syncthreads_or(anyf);
      if (!active) break;
    }
    for (int i = 0; i < n_vtiles; ++i) {
      float* ot = o + static_cast<long long>(i) * vb;
      for (int j = 0; j < n_chunks; ++j) {
        const long long c = lay + (static_cast<long long>(i) * n_chunks + j) * eb;
        for (int e = tid; e < eb; e += nt) {
          const int sv = src_t[c + e];
          if (fc[sv] > 0.f) {
            const float w = pruned_t[c + e] > 0 ? repro::inf_f() : w_t[c + e];
            count += w < repro::inf_f();
            repro::tile_min_into(tile, dstrel_t[c + e], o[sv] + w);
          }
        }
        __syncthreads();
        for (int v = tid; v < vb; v += nt) {
          const float m = __int_as_float(tile[v]);
          if (m < ot[v]) ot[v] = m;
          tile[v] = repro::kInfBits;
        }
        __syncthreads();
      }
    }
  }

  for (int v = tid; v < bp; v += nt) resid[roff + v] = o[v] < pv[v] ? 1.f : 0.f;
  atomicAdd(&total, count);
  __syncthreads();
  if (tid == 0) nrel[row] = total;
}

}  // namespace

extern "C" int relax_fixpoint_batch(const float* dist, const float* front,
                                    const int* src_t, const float* w_t,
                                    const int* dstrel_t, const int* pruned_t,
                                    float* out, float* resid, int* nrel,
                                    float* prev, float* fcur, int P, int K,
                                    int bp, int n_vtiles, int n_chunks, int eb,
                                    int vb, int n_sweeps, cudaStream_t stream) {
  if (P * K == 0) return 0;
  const size_t smem = static_cast<size_t>(vb) * sizeof(int);
  cudaError_t err = repro::allow_smem(relax_fixpoint_batch_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_fixpoint_batch_kernel<<<P * K, repro::kThreads, smem, stream>>>(
      dist, front, src_t, w_t, dstrel_t, pruned_t, out, resid, nrel, prev, fcur,
      K, bp, n_vtiles, n_chunks, eb, vb, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}
