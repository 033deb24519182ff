// The relax family: the K-query local fixpoint over the dst-tiled local
// edges (dense and ragged) and the three single-query kernels of the
// standalone kernel API.
//
// Replaces: kernels/relax/relax.py: relax_dst_tiled_fixpoint_batch (the
// Pallas kernel _relax_fixpoint_batch_kernel, grid (sweep, vtile, chunk,
// query)) and relax_dst_ragged_fixpoint_batch (the Pallas kernel
// _relax_ragged_fixpoint_batch_kernel, grid (sweep, chunk, query), with the
// chunk->tile map ctile scalar-prefetched); and, for one query on one
// block, relax_dst_tiled_fixpoint (_relax_fixpoint_kernel, grid (sweep,
// vtile, chunk)), relax_dst_tiled_masked (_relax_masked_kernel, grid
// (vtile, chunk)) and relax_dst_tiled (_relax_kernel, grid (vtile, chunk)).
//
// What the fixpoint kernels compute, per (shard, query) row: up to n_sweeps
// frontier-chased Gauss-Seidel min-plus sweeps. A sweep walks the shard's
// edge chunks in layout order; each chunk gathers dist[src] + w for the
// edges whose source is in the sweep's frontier (Trishla-pruned edges count
// as +inf), min-reduces them per destination, and mins its vertex tile into
// the live row, so later chunks see earlier improvements. The dense layout
// holds n_chunks chunks for every tile (chunk c is in tile c / n_chunks);
// the ragged layout holds only each tile's own chunks, flat, with chunk c in
// tile min(ctile[c], n_vtiles - 1): the padding chunks that stack shards
// to one chunk count carry the sentinel tile and w = +inf, so they are
// no-ops. The ragged order is the dense order minus the dense layout's
// all-padding chunks, so both give the same rows and the same counts. A
// row whose sweep changes nothing stops (the per-query early-out).
// Outputs: the distances, the residual frontier (vertices improved in the
// last sweep run) and the per-query relaxation count. The single-query
// fixpoint (relax_fixpoint) is the same chain for one row.
//
// What bounds the fixpoint kernels: the order. Each chunk reads the row
// that every earlier chunk of the sweep wrote, so the work of one row is a
// chain of n_sweeps * chunks-per-shard dependent steps. Bytes are not the
// limit.
//
// Design of the dense fixpoint kernels (1 and 9): one CTA per (shard,
// query) row, a grid of P*K (a grid of 1 for relax_fixpoint), walking
// sweeps -> chunks in the Pallas grid order (sweeps.cuh), which reproduces
// the reference's sequence of reads and writes exactly, so the relaxation
// count is exact and not merely bounded. Per chunk every thread gathers and
// atomicMins its candidates into a shared VB-tile (tile_min_into); after a
// barrier the tile is min'd into the row, then reset. The rows (live
// distances, previous sweep, frontier) stay in global memory, reached
// through L1 and L2, so each chunk step waits on a chain of device-memory
// round trips: the simple, exact design.
//
// Design of the ragged fixpoint kernel (2), redesigned for Hopper: the same
// grid and the same order, on the chain of sweeps_ragged.cuh: a producer
// warp streams the layout through a ring of shared-memory stages with bulk
// copies, the frontier and the improved set are bitmasks in shared memory,
// and the distance gathers are issued two chunks ahead, a source whose tile
// may have been written since being read again from a shared window of the
// live tiles. What bounds it now: the chain of chunk steps, each the SM's
// own work (an L1 request per early gather, shared-memory reads and
// atomics) between two barriers of the consumer warps; no step waits on
// device memory.
//
// The two single sweeps (relax_sweep, relax_masked) are Jacobi: every
// gather reads the INPUT distances, so vertex tiles are independent and
// the order of a tile's chunks does not matter (min is exact). What bounds
// them: bytes, the layout planes streamed once (the 256 KB distance and
// frontier vectors of a 65,536-vertex block sit in L2). Design: one CTA per
// vertex tile, a grid of n_vtiles; it seeds a shared VB-tile from
// dist[tile], walks the tile's chunks gathering dist[src] + w from global
// memory and min-reducing into the tile, and writes the tile out once. The
// masked sweep also gathers front[src], folds the Trishla mask into w and
// counts f_src & (w < inf) per CTA, added to nrel[0] with one integer
// atomicAdd per CTA (exact in any order; the wrapper zeroes nrel first).
// Both take any non-NaN distances (tile_reduce.cuh: min_key).
#include "sweeps.cuh"
#include "sweeps_ragged.cuh"

namespace {

// One (shard, query) row's dense fixpoint: the rows at offset roff; the
// layout pointers are the shard's own.
__device__ void fixpoint_row(const float* __restrict__ dist,
                             const float* __restrict__ front,
                             const int* src_t, const float* w_t,
                             const int* dstrel_t, const int* pruned_t,
                             float* out, float* resid, int* nrel, float* prev,
                             float* fcur, long long roff, int bp, int n_vtiles,
                             int n_rows, int n_chunks, int eb, int vb,
                             int n_sweeps) {
  extern __shared__ int tile[];            // [vb] minima as keys (min_key)
  __shared__ int total;
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

  const int count = repro::relax_sweeps(
      o, pv, fc, tile, active, src_t, w_t, dstrel_t, pruned_t, bp, n_rows,
      n_chunks, eb, vb, n_sweeps);

  for (int v = tid; v < bp; v += nt) resid[roff + v] = o[v] < pv[v] ? 1.f : 0.f;
  atomicAdd(&total, count);
  __syncthreads();
  if (tid == 0) *nrel = total;
}

__global__ void __launch_bounds__(repro::kThreads)
relax_fixpoint_kernel(const float* __restrict__ dist,
                      const float* __restrict__ front,
                      const int* __restrict__ src_t,
                      const float* __restrict__ w_t,
                      const int* __restrict__ dstrel_t,
                      const int* __restrict__ pruned_t, float* out,
                      float* resid, int* nrel, float* prev, float* fcur, int K,
                      int bp, int n_vtiles, int n_chunks, int eb, int vb,
                      int n_sweeps) {
  const int row = blockIdx.x;              // p * K + q
  const int p = row / K;
  const long long lay = static_cast<long long>(p) * n_vtiles * n_chunks * eb;
  fixpoint_row(dist, front, src_t + lay, w_t + lay, dstrel_t + lay,
               pruned_t + lay, out, resid, nrel + row, prev, fcur,
               static_cast<long long>(row) * bp, bp, n_vtiles,
               n_vtiles * n_chunks, n_chunks, eb, vb, n_sweeps);
}

// Kernel 2: one block of ragged::kThreads per (shard, query) row on the
// chain of sweeps_ragged.cuh. vstate: the rows' vertex state in device
// memory, used only when it does not fit in shared memory (bits_smem 0).
template <bool kHazard>
__global__ void __launch_bounds__(repro::ragged::kThreads, 1)
relax_ragged_kernel(const float* __restrict__ dist,
                    const float* __restrict__ front,
                    const int* __restrict__ ctile, const int* src_r,
                    const float* w_r, const int* dstrel_r, const int* pruned_r,
                    float* out, float* resid, int* nrel, uint32_t* vstate,
                    int K, int bp, int n_vtiles, int rows, int eb, int vb,
                    int n_sweeps, int bits_smem) {
  namespace rg = repro::ragged;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;              // p * K + q
  const int p = row / K;
  const int tid = threadIdx.x;
  const long long roff = static_cast<long long>(row) * bp;
  const int vbytes = rg::vstate_bytes(bp);
  const rg::Layout L =
      rg::smem_layout(eb, vb, n_vtiles, 0, bits_smem ? vbytes : 0);
  uint32_t* vs =
      bits_smem ? reinterpret_cast<uint32_t*>(smem + L.vstate)
                : vstate + static_cast<long long>(row) * (vbytes / 4);
  const int words = rg::bit_words(bp);
  const long long lay = static_cast<long long>(p) * rows * eb;
  const rg::Chain ch{out + roff, {vs, vs + words},
                     ctile + static_cast<long long>(p) * rows, src_r + lay,
                     w_r + lay, dstrel_r + lay, pruned_r + lay, bp, n_vtiles,
                     rows, eb, vb, n_sweeps};
  int* total = reinterpret_cast<int*>(smem + L.ctl) + 4;
  if (tid == 0) *total = 0;
  // the row, the frontier bitmask, the improved one empty (bp is a
  // multiple of 32: four vertices a lane, a word per 8 lanes)
  const float4* d4 = reinterpret_cast<const float4*>(dist + roff);
  const float4* f4 = reinterpret_cast<const float4*>(front + roff);
  float4* o4 = reinterpret_cast<float4*>(ch.o);
  unsigned any = 0;
  // (i - lane keeps the loop warp-uniform)
  for (int i = tid; i - (tid & 31) < bp / 4; i += rg::kThreads) {
    const bool in = i < bp / 4;
    unsigned nib = 0;
    if (in) {
      o4[i] = d4[i];
      nib = rg::nibble(f4[i]);
      if ((i & 7) == 0) vs[words + (i >> 3)] = 0;
    }
    any |= nib;
    rg::pack_nibbles(vs, i, nib, in);
  }
  const int active = __syncthreads_or(any != 0);
  int r;
  const int count = rg::sweeps<kHazard>(smem, L, ch, active, &r);
  rg::unpack_bits(resid + roff, ch.bits[r], bp, rg::kThreads);
  if (count) atomicAdd(total, count);
  __syncthreads();
  if (tid == 0) nrel[row] = *total;
}

// Kernel 9: the single-query fixpoint, one CTA over the whole block.
__global__ void __launch_bounds__(repro::kThreads)
relax_single_kernel(const float* __restrict__ dist,
                    const float* __restrict__ front,
                    const int* __restrict__ src_t,
                    const float* __restrict__ w_t,
                    const int* __restrict__ dstrel_t,
                    const int* __restrict__ pruned_t, float* out, float* resid,
                    int* nrel, float* prev, float* fcur, int bp, int n_vtiles,
                    int n_chunks, int eb, int vb, int n_sweeps) {
  fixpoint_row(dist, front, src_t, w_t, dstrel_t, pruned_t, out, resid, nrel,
               prev, fcur, 0, bp, n_vtiles, n_vtiles * n_chunks, n_chunks, eb,
               vb, n_sweeps);
}

// Kernels 11 (kMasked false) and 10 (kMasked true): one Jacobi sweep, one
// CTA per vertex tile. front, pruned_t and nrel are read / written only
// when kMasked.
template <bool kMasked>
__global__ void __launch_bounds__(repro::kThreads)
relax_sweep_kernel(const float* __restrict__ dist,
                   const float* __restrict__ front,
                   const int* __restrict__ src_t,
                   const float* __restrict__ w_t,
                   const int* __restrict__ dstrel_t,
                   const int* __restrict__ pruned_t, float* __restrict__ out,
                   int* nrel, int n_chunks, int eb, int vb) {
  extern __shared__ int tile[];            // [vb] minima as keys (min_key)
  __shared__ int total;
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* dt = dist + static_cast<long long>(t) * vb;
  for (int v = tid; v < vb; v += nt) tile[v] = repro::min_key(dt[v]);
  if (tid == 0) total = 0;
  __syncthreads();

  int count = 0;
  const long long lay = static_cast<long long>(t) * n_chunks * eb;
  for (long long i = lay + tid; i < lay + static_cast<long long>(n_chunks) * eb;
       i += nt) {
    const int sv = src_t[i];
    if (kMasked) {
      if (front[sv] > 0.f) {
        const float w = pruned_t[i] > 0 ? repro::inf_f() : w_t[i];
        count += w < repro::inf_f();
        repro::tile_min_into(tile, dstrel_t[i], dist[sv] + w);
      }
    } else {
      repro::tile_min_into(tile, dstrel_t[i], dist[sv] + w_t[i]);
    }
  }
  if (kMasked) atomicAdd(&total, count);
  __syncthreads();

  float* ot = out + static_cast<long long>(t) * vb;
  for (int v = tid; v < vb; v += nt) ot[v] = repro::key_value(tile[v]);
  if (kMasked && tid == 0 && total) atomicAdd(nrel, total);
}

template <bool kHazard>
int launch_ragged(const float* dist, const float* front, const int* ctile,
                  const int* src_r, const float* w_r, const int* dstrel_r,
                  const int* pruned_r, float* out, float* resid, int* nrel,
                  uint32_t* vstate, int P, int K, int bp, int n_vtiles,
                  int rows, int eb, int vb, int n_sweeps,
                  cudaStream_t stream) {
  namespace rg = repro::ragged;
  const int need = rg::scratch_bytes(bp, n_vtiles, eb, vb, 0);
  if (need < 0 || (need > 0 && vstate == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bits_smem = need == 0;
  const rg::Layout L = rg::smem_layout(
      eb, vb, n_vtiles, 0, bits_smem ? rg::vstate_bytes(bp) : 0);
  auto kernel = relax_ragged_kernel<kHazard>;
  cudaError_t err = repro::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P * K, rg::kThreads, L.total, stream>>>(
      dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, out, resid, nrel,
      vstate, K, bp, n_vtiles, rows, eb, vb, n_sweeps, bits_smem);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
cudaError_t allow_tile(Kernel kernel, int vb) {
  return repro::allow_smem(kernel, static_cast<size_t>(vb) * sizeof(int));
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
  if (P * K == 0) return 0;
  const size_t smem = static_cast<size_t>(vb) * sizeof(int);
  cudaError_t err = repro::allow_smem(relax_fixpoint_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_fixpoint_kernel<<<P * K, repro::kThreads, smem, stream>>>(
      dist, front, src_t, w_t, dstrel_t, pruned_t, out, resid, nrel, prev,
      fcur, K, bp, n_vtiles, n_chunks, eb, vb, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

// Bytes of vertex state a row of the ragged kernel needs in device memory:
// 0 when its bitmasks fit in shared memory, -1 when the row is past the
// chain's cap (sweeps_ragged.cuh: layout_fits).
extern "C" int relax_ragged_scratch_bytes(int bp, int n_vtiles, int eb,
                                          int vb) {
  return repro::ragged::scratch_bytes(bp, n_vtiles, eb, vb, 0);
}

// Ragged layout [P, total_chunks, eb] with the chunk->tile map ctile
// [P, total_chunks]; vstate [P * K, relax_ragged_scratch_bytes / 4] or null
// when that is 0. hazard 0 is the planted fault of the checks (every
// source read from its early gather).
extern "C" int relax_ragged_fixpoint_batch(
    const float* dist, const float* front, const int* ctile, const int* src_r,
    const float* w_r, const int* dstrel_r, const int* pruned_r, float* out,
    float* resid, int* nrel, uint32_t* vstate, int P, int K, int bp,
    int n_vtiles, int total_chunks, int eb, int vb, int n_sweeps,
    int hazard, cudaStream_t stream) {
  if (P * K == 0) return 0;
  if (!hazard)
    return launch_ragged<false>(dist, front, ctile, src_r, w_r, dstrel_r,
                                pruned_r, out, resid, nrel, vstate, P, K, bp,
                                n_vtiles, total_chunks, eb, vb, n_sweeps,
                                stream);
  return launch_ragged<true>(dist, front, ctile, src_r, w_r, dstrel_r,
                             pruned_r, out, resid, nrel, vstate, P, K, bp,
                             n_vtiles, total_chunks, eb, vb, n_sweeps, stream);
}

// Kernel 9: one query, dense layout [n_vtiles, n_chunks, eb]; rows [bp],
// nrel [1].
extern "C" int relax_fixpoint(const float* dist, const float* front,
                              const int* src_t, const float* w_t,
                              const int* dstrel_t, const int* pruned_t,
                              float* out, float* resid, int* nrel, float* prev,
                              float* fcur, int bp, int n_vtiles, int n_chunks,
                              int eb, int vb, int n_sweeps,
                              cudaStream_t stream) {
  cudaError_t err = allow_tile(relax_single_kernel, vb);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_single_kernel<<<1, repro::kThreads, vb * sizeof(int), stream>>>(
      dist, front, src_t, w_t, dstrel_t, pruned_t, out, resid, nrel, prev,
      fcur, bp, n_vtiles, n_chunks, eb, vb, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 10: one masked, counted Jacobi sweep; nrel [1] zeroed by the
// caller on the same stream.
extern "C" int relax_masked(const float* dist, const float* front,
                            const int* src_t, const float* w_t,
                            const int* dstrel_t, const int* pruned_t,
                            float* out, int* nrel, int n_vtiles, int n_chunks,
                            int eb, int vb, cudaStream_t stream) {
  if (n_vtiles == 0) return 0;
  cudaError_t err = allow_tile(relax_sweep_kernel<true>, vb);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_sweep_kernel<true><<<n_vtiles, repro::kThreads, vb * sizeof(int),
                             stream>>>(dist, front, src_t, w_t, dstrel_t,
                                       pruned_t, out, nrel, n_chunks, eb, vb);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 11: one unmasked Jacobi sweep.
extern "C" int relax_sweep(const float* dist, const int* src_t,
                           const float* w_t, const int* dstrel_t, float* out,
                           int n_vtiles, int n_chunks, int eb, int vb,
                           cudaStream_t stream) {
  if (n_vtiles == 0) return 0;
  cudaError_t err = allow_tile(relax_sweep_kernel<false>, vb);
  if (err != cudaSuccess) return static_cast<int>(err);
  relax_sweep_kernel<false><<<n_vtiles, repro::kThreads, vb * sizeof(int),
                              stream>>>(dist, nullptr, src_t, w_t, dstrel_t,
                                        nullptr, out, nullptr, n_chunks, eb,
                                        vb);
  return static_cast<int>(cudaGetLastError());
}
