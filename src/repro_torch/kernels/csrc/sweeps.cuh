// The plain Gauss-Seidel sweep chain of one (shard, query) row over the
// dense layout, walking every chunk, the all-padding ones included: the
// relax stage of kernel 1 alone (csrc/relax.cu, relax_fixpoint_batch).
// Kernels 2 and 8 (ragged) and 9 and 7 (the dense layout's live chunks) run
// the Hopper chain of sweeps_ragged.cuh.
//
// Up to n_sweeps frontier-chased min-plus sweeps. A sweep walks the shard's
// n_rows edge chunks of eb edges in layout order; chunk c lands in vertex
// tile c / n_chunks. Each chunk gathers o[src] + w for the edges whose
// source is in the sweep's frontier (Trishla-pruned edges count as +inf),
// min-reduces them per destination in the shared tile (tile_min_into) and,
// after a barrier, mins the tile into the row, so later chunks see earlier
// improvements. The gathers of a chunk
// all precede its writes, as in the reference. A sweep after the first
// opens by making the vertices improved in the previous sweep the frontier;
// a row whose sweep changed nothing stops (the per-query early-out).
#pragma once

#include "tile_reduce.cuh"

namespace repro {

// o, pv, fc: the row's live distances, its values at the start of the
// sweep, and the sweep's frontier (0/1), in global memory. The layout
// pointers are the shard's own rows. `active` (block-uniform) says whether
// the row starts with a frontier. tile: [vb] shared ints, +inf bits on entry
// and on exit. Returns this thread's share of the relaxation count; on
// return, o[v] < pv[v] is the residual frontier.
__device__ inline int relax_sweeps(float* o, float* pv, float* fc, int* tile,
                                   int active, const int* src_t,
                                   const float* w_t, const int* dstrel_t,
                                   const int* pruned_t, int bp, int n_rows,
                                   int n_chunks, int eb, int vb,
                                   int n_sweeps) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
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
    for (int c = 0; c < n_rows; ++c) {
      const int t = c / n_chunks;
      float* ot = o + static_cast<long long>(t) * vb;
      const long long base = static_cast<long long>(c) * eb;
      for (int e = tid; e < eb; e += nt) {
        const int sv = src_t[base + e];
        if (fc[sv] > 0.f) {
          const float w = pruned_t[base + e] > 0 ? inf_f() : w_t[base + e];
          count += w < inf_f();
          tile_min_into(tile, dstrel_t[base + e], o[sv] + w);
        }
      }
      __syncthreads();
      for (int v = tid; v < vb; v += nt) {
        const float m = key_value(tile[v]);
        if (m < ot[v]) ot[v] = m;
        tile[v] = kInfBits;
      }
      __syncthreads();
    }
  }
  return count;
}

}  // namespace repro
