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
// Design of the three fixpoint kernels, for Hopper: one block per (shard,
// query) row (a grid of P*K; kernel 9: one), walking sweeps -> chunks in
// the Pallas grid order, which reproduces the reference's sequence of
// reads and writes exactly, so the relaxation count is exact and not
// merely bounded. The walk is the chain of sweeps_ragged.cuh: a producer
// warp streams the layout through a ring of shared-memory stages with bulk
// copies, the frontier and the improved set are bitmasks in shared memory,
// and the distance gathers are issued two chunks ahead, a source whose tile
// may have been written since being read again from a shared window of the
// live tiles. Kernel 2 walks the ragged layout. Kernels 1 (K queries, P
// shards) and 9 (one row) walk the dense layout's live chunks (those
// holding a finite weight), in layout order: a chunk of +inf weights is an
// exact no-op, and at the scale-1e6 shards 1,006 of kernel 1's 1,536
// chunks are (6,076 of 8,192 at kernel 9's block). Kernel 1 takes the list
// from its caller (the engine derives it once per shards object,
// SsspShards.round_chunks), its length the last entry of the tile bounds,
// read on the device; a caller without one, and kernel 9, get it from the
// entry point's pre-pass, ahead of the chain on the same stream, with no
// host sync: a pass over the weights (a warp a chunk) sets a flag a chunk,
// and one block a shard compacts the flags into the list and its length by
// a block-wide scan. One query is one chain, on one SM: the order makes the
// count exact, so the row is not split. What bounds them now: the chain of
// chunk steps, each the SM's own work (an L1 request per early gather,
// shared-memory reads and atomics) between two barriers of the consumer
// warps; no step waits on device memory.
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
#include "sweeps_ragged.cuh"

namespace {

// Kernels 2, 1 and 9: one block of ragged::kThreads per (shard, query) row
// on the chain of sweeps_ragged.cuh. Kernel 2 (kList false) walks the
// ragged layout [P, rows, eb] with its chunk -> tile map ctile; kernels 1
// and 9 (kList) walk the live chunks live_idx[p][0 .. live_n[p * n_stride])
// of the dense layout [P, rows = n_vtiles * n_chunks, eb] (the caller's
// list, or the pre-pass's below). vstate: the rows' vertex state in device
// memory, used only when it does not fit in shared memory (bits_smem 0).
template <bool kHazard, bool kList>
__global__ void __launch_bounds__(repro::ragged::kThreads, 1)
relax_ragged_kernel(const float* __restrict__ dist,
                    const float* __restrict__ front,
                    const int* __restrict__ ctile, const int* src_r,
                    const float* w_r, const int* dstrel_r, const int* pruned_r,
                    float* out, float* resid, int* nrel, uint32_t* vstate,
                    const int* live_idx, const int* live_n, int n_stride,
                    int K, int bp, int n_vtiles, int rows, int n_chunks,
                    int eb, int vb, int n_sweeps, int bits_smem) {
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
  const long long cp = static_cast<long long>(p) * rows;
  int chain_rows = rows;
  if constexpr (kList) chain_rows = live_n[static_cast<long long>(p) * n_stride];
  const rg::Chain ch{out + roff, {vs, vs + words},
                     kList ? nullptr : ctile + cp, src_r + lay, w_r + lay,
                     dstrel_r + lay, pruned_r + lay, bp, n_vtiles,
                     chain_rows, eb, vb, n_sweeps,
                     kList ? live_idx + cp : nullptr, n_chunks};
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
  int active = __syncthreads_or(any != 0);
  // no live chunk: the sweeps relax nothing (out = dist, resid empty)
  if constexpr (kList) active = active && chain_rows > 0;
  int r;
  const int count = rg::sweeps<kHazard, kList>(smem, L, ch, active, &r);
  rg::unpack_bits(resid + roff, ch.bits[r], bp, rg::kThreads);
  if (count) atomicAdd(total, count);
  __syncthreads();
  if (tid == 0) nrel[row] = *total;
}

// The live-chunk pre-pass of kernels 1 and 9, part 1: flags[c] = 1 when
// chunk c of the dense layout (every shard's chunks, flat) holds a finite
// weight (a warp a chunk, four weights a lane at a time; eb a multiple of
// 4).
__global__ void live_flags_kernel(const float* __restrict__ w, int* flags,
                                  int rows, int eb) {
  const long long c =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= rows) return;                   // whole warps
  const float4* w4 = reinterpret_cast<const float4*>(w + c * eb);
  const float inf = repro::inf_f();
  bool any = false;
  for (int i = lane; i < eb / 4; i += 32) {
    const float4 x = w4[i];
    any |= x.x < inf || x.y < inf || x.z < inf || x.w < inf;
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) flags[c] = any;
}

// The pre-pass, part 2 (one block a shard p): idx[p][0 .. n) = the shard's
// chunks whose flag is set, in layout order, and n_live[p] = n; blockDim.x
// flags a round, a block-wide exclusive scan of the flags placing each
// live chunk.
__global__ void __launch_bounds__(1024)
live_list_kernel(const int* __restrict__ flags, int* idx, int* n_live,
                 int rows) {
  const long long off = static_cast<long long>(blockIdx.x) * rows;
  flags += off;
  idx += off;
  __shared__ int sums[32];                 // warps' live counts, scanned
  __shared__ int carry;                    // live chunks of earlier rounds
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < rows; base += blockDim.x) {
    const int c = base + tid;
    const bool f = c < rows && flags[c] != 0;
    const unsigned b = __ballot_sync(0xffffffffu, f);
    if (lane == 0) sums[warp] = __popc(b);
    __syncthreads();
    if (warp == 0) {                       // inclusive scan over the warps
      int v = lane < n_warps ? sums[lane] : 0;
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += u;
      }
      sums[lane] = v;
    }
    __syncthreads();
    if (f)
      idx[carry + (warp ? sums[warp - 1] : 0) +
          __popc(b & ((1u << lane) - 1u))] = c;
    __syncthreads();
    if (tid == 0) carry += sums[31];
    __syncthreads();
  }
  if (tid == 0) n_live[blockIdx.x] = carry;
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

template <bool kHazard, bool kList>
int launch_ragged(const float* dist, const float* front, const int* ctile,
                  const int* src_r, const float* w_r, const int* dstrel_r,
                  const int* pruned_r, float* out, float* resid, int* nrel,
                  uint32_t* vstate, const int* live_idx, const int* live_n,
                  int n_stride, int P, int K, int bp, int n_vtiles, int rows,
                  int n_chunks, int eb, int vb, int n_sweeps,
                  cudaStream_t stream) {
  namespace rg = repro::ragged;
  const int need = rg::scratch_bytes(bp, n_vtiles, eb, vb, 0);
  if (need < 0 || (need > 0 && vstate == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bits_smem = need == 0;
  const rg::Layout L = rg::smem_layout(
      eb, vb, n_vtiles, 0, bits_smem ? rg::vstate_bytes(bp) : 0);
  auto kernel = relax_ragged_kernel<kHazard, kList>;
  cudaError_t err = repro::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<P * K, rg::kThreads, L.total, stream>>>(
      dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, out, resid, nrel,
      vstate, live_idx, live_n, n_stride, K, bp, n_vtiles, rows, n_chunks, eb,
      vb, n_sweeps, bits_smem);
  return static_cast<int>(cudaGetLastError());
}

// Kernels 1 and 9 over the dense layout [P, rows = n_vtiles * n_chunks,
// eb]: the caller's live chunks (idx [P, rows], the shard's count at
// live_n[p * n_stride]), or, when idx is null, the pre-pass's, written to
// `live` ([2 * P * rows + P] int32: the chunks' flags, the lists, the
// counts) on the same stream; then the chain.
int launch_live(const float* dist, const float* front, const int* src_t,
                const float* w_t, const int* dstrel_t, const int* pruned_t,
                float* out, float* resid, int* nrel, const int* idx,
                const int* live_n, int n_stride, int* live, uint32_t* vstate,
                int P, int K, int bp, int n_vtiles, int n_chunks, int eb,
                int vb, int n_sweeps, int hazard, cudaStream_t stream) {
  const int rows = n_vtiles * n_chunks;
  if (idx == nullptr) {
    const long long all = static_cast<long long>(P) * rows;
    int* flags = live;
    int* list = live + all;
    int* counts = live + 2 * all;
    live_flags_kernel<<<static_cast<unsigned>((all + 15) / 16), 512, 0,
                        stream>>>(w_t, flags, static_cast<int>(all), eb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    live_list_kernel<<<P, 1024, 0, stream>>>(flags, list, counts, rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    idx = list;
    live_n = counts;
    n_stride = 1;
  }
  if (!hazard)
    return launch_ragged<false, true>(
        dist, front, nullptr, src_t, w_t, dstrel_t, pruned_t, out, resid,
        nrel, vstate, idx, live_n, n_stride, P, K, bp, n_vtiles, rows,
        n_chunks, eb, vb, n_sweeps, stream);
  return launch_ragged<true, true>(
      dist, front, nullptr, src_t, w_t, dstrel_t, pruned_t, out, resid, nrel,
      vstate, idx, live_n, n_stride, P, K, bp, n_vtiles, rows, n_chunks, eb,
      vb, n_sweeps, stream);
}

template <typename Kernel>
cudaError_t allow_tile(Kernel kernel, int vb) {
  return repro::allow_smem(kernel, static_cast<size_t>(vb) * sizeof(int));
}

}  // namespace

// Bytes of vertex state a row of the chain needs in device memory: 0 when
// its bitmasks fit in shared memory, -1 when the row is past the chain's
// cap (sweeps_ragged.cuh: layout_fits).
extern "C" int relax_ragged_scratch_bytes(int bp, int n_vtiles, int eb,
                                          int vb) {
  return repro::ragged::scratch_bytes(bp, n_vtiles, eb, vb, 0);
}

// Kernel 1: dense layout [P, n_vtiles, n_chunks, eb], rows [P, K, bp].
// chunk_idx [P, n_vtiles * n_chunks] and chunk_bounds [P, n_vtiles + 1]:
// the live chunks (common.py: live_chunks), the shard's count the last
// bound; or both null, and the pre-pass fills live [2 * P * n_vtiles *
// n_chunks + P]. vstate [P * K, relax_ragged_scratch_bytes / 4] or null
// when that is 0. hazard 0 is the planted fault of the checks (every
// source read from its early gather).
extern "C" int relax_fixpoint_batch(
    const float* dist, const float* front, const int* src_t, const float* w_t,
    const int* dstrel_t, const int* pruned_t, float* out, float* resid,
    int* nrel, const int* chunk_idx, const int* chunk_bounds, int* live,
    uint32_t* vstate, int P, int K, int bp, int n_vtiles, int n_chunks,
    int eb, int vb, int n_sweeps, int hazard, cudaStream_t stream) {
  if (P * K == 0) return 0;
  return launch_live(dist, front, src_t, w_t, dstrel_t, pruned_t, out, resid,
                     nrel, chunk_idx,
                     chunk_bounds ? chunk_bounds + n_vtiles : nullptr,
                     n_vtiles + 1, live, vstate, P, K, bp, n_vtiles,
                     n_chunks, eb, vb, n_sweeps, hazard, stream);
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
    return launch_ragged<false, false>(
        dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, out, resid, nrel,
        vstate, nullptr, nullptr, 0, P, K, bp, n_vtiles, total_chunks, 1, eb,
        vb, n_sweeps, stream);
  return launch_ragged<true, false>(
      dist, front, ctile, src_r, w_r, dstrel_r, pruned_r, out, resid, nrel,
      vstate, nullptr, nullptr, 0, P, K, bp, n_vtiles, total_chunks, 1, eb,
      vb, n_sweeps, stream);
}

// Kernel 9: one query, dense layout [n_vtiles, n_chunks, eb]; rows [bp],
// nrel [1]. live: [2 * n_vtiles * n_chunks + 1] int32 scratch (the chunks'
// flags, the live list, its length), filled by the pre-pass on the same
// stream; vstate [relax_ragged_scratch_bytes / 4] or null when that is 0.
// hazard 0 is the planted fault of the checks.
extern "C" int relax_fixpoint(const float* dist, const float* front,
                              const int* src_t, const float* w_t,
                              const int* dstrel_t, const int* pruned_t,
                              float* out, float* resid, int* nrel, int* live,
                              uint32_t* vstate, int bp, int n_vtiles,
                              int n_chunks, int eb, int vb, int n_sweeps,
                              int hazard, cudaStream_t stream) {
  return launch_live(dist, front, src_t, w_t, dstrel_t, pruned_t, out, resid,
                     nrel, nullptr, nullptr, 1, live, vstate, 1, 1, bp,
                     n_vtiles, n_chunks, eb, vb, n_sweeps, hazard, stream);
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
