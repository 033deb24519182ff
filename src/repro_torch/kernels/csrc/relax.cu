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
// The two single sweeps (relax_sweep, kernel 11; relax_masked, kernel 10)
// are Jacobi: every gather reads the INPUT distances, min is exact and the
// count is an integer sum, so neither the order of the chunks nor that of
// the CTAs changes an output, and the work may be split and reordered
// freely. What bounds them: bytes, the live chunks' layout planes read once
// (16 bytes an edge for kernel 10, 12 for kernel 11: about 17 and 13 MB at
// the scale-1e6 block, 2,116 live chunks of 8,192), while the 256 KB
// distance and frontier vectors the gathers read sit in L2. Design, for
// Hopper: one cooperative launch of a persistent grid (as many CTAs of 512
// threads as are co-resident, two an SM) in two phases.
//  - Phase A, balanced by live chunk and not by tile: the CTA's four groups
//    of 128 threads take the live chunks live_idx[j], j = group, group +
//    groups, ... (the caller's list, live_chunks(w_t[None] < inf), or the
//    entry point's pre-pass, live_flags_kernel / live_list_kernel, which
//    also writes each tile's range of the list). A thread loads four
//    consecutive edges of each plane at once (16-byte loads, through the
//    read-only cache, so a caller sweeping one layout finds it in L2), then
//    their frontier gathers, then the distance gathers of the edges in the
//    frontier, before it reduces any; the candidates are min-reduced into
//    the group's shared [vb] tile of keys (tile_reduce.cuh: min_key), which
//    it writes to the chunk's slot of a scratch of partial minima. Edges of
//    weight +inf (padding, and kernel 10's Trishla-pruned edges) issue no
//    gather. No tile waits for its heaviest CTA: a tile's live chunks (at
//    most 16 here, 4.13 on average) spread over several groups.
//  - Phase B, after the launch's one grid-wide barrier (cooperative_groups
//    grid sync): CTA b finalizes tiles b, b + grid, ..., the first of them
//    seeded with min_key(dist[tile]) before the barrier: the new tile is
//    that min the partial minima of the tile's slots (its range of the
//    list), eight slot loads in flight a thread; a tile with no live chunk
//    keeps its distances. CTA 0 writes nrel, the sum of the CTAs' counts,
//    so kernel 10's call is one launch (no memset), kernel 11's too, and
//    the caller's list route reads no dead chunk at all.
// Where the time goes, on an H100 at the scale-1e6 block: the launch, the
// barrier and phase B a fixed part of a call, phase A most of the rest
// (the plane loads, then the gathers, each thread a chain). Variants that
// removed the barrier (the last group to bring a tile's slot finalizes
// it, on counters each launch's last arrivals zero again) or staged each
// CTA's chunks by bulk copies (cp.async.bulk) ran slower in chip runs made
// to choose the design; PERF.md gives this design's times.
// The contract is the plain version's, held bit for bit: any distances and
// weights, negative ones and -inf included. A NaN candidate (-inf + inf,
// or +inf + -inf) makes its vertex NaN, as the plain version's min does: in
// phase A it reduces as the key kNanKey, below every other key. A dead
// chunk (every weight +inf) is an exact no-op only while no distance is
// -inf: -inf + inf is NaN. So phase A also flags, a CTA, whether its slice
// of dist holds -inf, and where any CTA saw one, phase B walks each tile's
// +inf-weight edges, dead chunks included, for sources at -inf (in the
// frontier, for kernel 10) and makes their targets NaN: held, not
// rejected, at the cost of that walk only when a -inf is there.
#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

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

// The live-chunk pre-pass of kernels 1, 9, 10 and 11, part 1: flags[c] = 1
// when chunk c of the dense layout (every shard's chunks, flat) holds a
// finite weight (a warp a chunk, four weights a lane at a time when vec: eb
// a multiple of 4 and w 16-byte aligned; else one).
__global__ void live_flags_kernel(const float* __restrict__ w, int* flags,
                                  int rows, int eb, int vec) {
  const long long c =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= rows) return;                   // whole warps
  const float inf = repro::inf_f();
  bool any = false;
  if (vec) {
    const float4* w4 = reinterpret_cast<const float4*>(w + c * eb);
    for (int i = lane; i < eb / 4; i += 32) {
      const float4 x = w4[i];
      any |= x.x < inf || x.y < inf || x.z < inf || x.w < inf;
    }
  } else {
    for (int i = lane; i < eb; i += 32) any |= w[c * eb + i] < inf;
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) flags[c] = any;
}

// The pre-pass, part 2 (one block a shard p): idx[p][0 .. n) = the shard's
// chunks whose flag is set, in layout order, and n_live[p] = n; blockDim.x
// flags a round, a block-wide exclusive scan of the flags placing each
// live chunk. With tile_bounds (kernels 10 and 11, one shard), also tile
// i's range of the list: tile_bounds[i] = the live chunks before chunk
// i * n_chunks.
__global__ void __launch_bounds__(1024)
live_list_kernel(const int* __restrict__ flags, int* idx, int* n_live,
                 int rows, int* tile_bounds, int n_chunks) {
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
    const int at =
        carry + (warp ? sums[warp - 1] : 0) + __popc(b & ((1u << lane) - 1u));
    if (f) idx[at] = c;
    if (tile_bounds != nullptr && c < rows && c % n_chunks == 0)
      tile_bounds[c / n_chunks] = at;
    __syncthreads();
    if (tid == 0) carry += sums[31];
    __syncthreads();
  }
  if (tid == 0) n_live[blockIdx.x] = carry;
}

// Kernels 11 (kMasked false) and 10 (kMasked true): one Jacobi sweep over
// the live chunks, phases A and B of the header. front, pruned_t and nrel
// are read / written only when kMasked. live_idx: the live chunks, in
// layout order; tile_bounds [n_vtiles + 1]: tile t's range of the list, the
// list's length the last entry. partial [list length, vb]: the chunks'
// partial minima; cta_words [2 * gridDim.x]: the CTAs' relaxations, then
// their -inf flags. vec: eb a multiple of 4 and the planes 16-byte aligned.
namespace sweep {

constexpr int kThreads = 512;              // a CTA, two an SM
constexpr int kGroup = 128;                // threads that walk one chunk
constexpr int kGroups = kThreads / kGroup;
constexpr int kRound = 4 * kGroup;         // edges a group loads at once
constexpr int kNanKey = -2147483647 - 1;   // below every key

// The group's barrier (ids 1..kGroups; __syncthreads is barrier 0).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(kGroup) : "memory");
}

// Entries [e, e + 4) of a plane: one 16-byte load when vec, else one at a
// time, `fill` past the chunk's end (`left` entries remain).
__device__ __forceinline__ void load4(const int* p, bool vec, int left,
                                      int fill, int (&v)[4]) {
  if (vec) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = u < left ? __ldg(p + u) : fill;
  }
}

// min over the slots j = lo, lo + step, ... < hi of column v of the partial
// minima, eight loads in flight at a time.
__device__ __forceinline__ int slots_min(const int* partial, int lo, int hi,
                                         int step, int vb, int v) {
  int k = repro::kInfBits;
  for (int j = lo; j < hi; j += 8 * step) {
    int a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      a[u] = j + u * step < hi
                 ? __ldcg(partial + static_cast<long long>(j + u * step) * vb +
                          v)
                 : repro::kInfBits;
#pragma unroll
    for (int u = 0; u < 8; ++u) k = min(k, a[u]);
  }
  return k;
}

}  // namespace sweep

template <bool kMasked>
__global__ void __launch_bounds__(sweep::kThreads, 2)
relax_sweep_kernel(const float* __restrict__ dist,
                   const float* __restrict__ front,
                   const int* __restrict__ src_t,
                   const float* __restrict__ w_t,
                   const int* __restrict__ dstrel_t,
                   const int* __restrict__ pruned_t,
                   const int* __restrict__ live_idx,
                   const int* __restrict__ tile_bounds,
                   float* __restrict__ out, int* nrel, int* partial,
                   int* cta_words, int n_vtiles, int n_chunks, int eb, int vb,
                   int vec) {
  namespace sw = sweep;
  extern __shared__ int tiles[];           // [kGroups][vb] keys
  __shared__ int total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = tid / sw::kGroup;
  const int gt = tid % sw::kGroup;
  const int bp = n_vtiles * vb;
  const int rows = n_vtiles * n_chunks;
  const float inf = repro::inf_f();
  if (tid == 0) total = 0;

  // ---- phase A: the live chunks, a group each, partial minima to slots
  int* tile = tiles + g * vb;
  const int stride = gridDim.x * sw::kGroups;
  int j = blockIdx.x * sw::kGroups + g;
  int c = j < rows ? live_idx[j] : 0;      // (beside the list's length)
  const int n_live = tile_bounds[n_vtiles];
  for (int r = gt; r < vb; r += sw::kGroup) tile[r] = repro::kInfBits;
  int count = 0;
  for (; j < n_live; j += stride) {
    const int c_next = j + stride < n_live ? live_idx[j + stride] : 0;
    const long long base = static_cast<long long>(c) * eb;
    for (int e0 = 0; e0 < eb; e0 += sw::kRound) {
      // the round's plane loads, then the gathers, then the reduce
      const int e = e0 + 4 * gt;
      const bool in = e < eb;
      const long long at = base + (in ? e : 0);
      const int left = in ? eb - e : 0;
      int sv[4], rel[4], wb[4], prn[4] = {0, 0, 0, 0};
      sw::load4(src_t + at, vec && in, left, 0, sv);
      sw::load4(reinterpret_cast<const int*>(w_t) + at, vec && in, left,
                repro::kInfBits, wb);
      sw::load4(dstrel_t + at, vec && in, left, 0, rel);
      if (kMasked) sw::load4(pruned_t + at, vec && in, left, 0, prn);
      float w[4], d[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = prn[u] > 0 ? inf : __int_as_float(wb[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (kMasked && w[u] < inf && !(__ldg(front + sv[u]) > 0.f))
          w[u] = inf;                      // its source is not in the frontier
#pragma unroll
      for (int u = 0; u < 4; ++u)
        d[u] = w[u] < inf ? __ldg(dist + sv[u]) : inf;
      if (e0 == 0) sw::group_sync(g);      // the tile re-initialized
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!(w[u] < inf)) continue;
        count += kMasked;
        const float cand = d[u] + w[u];
        if (cand < inf)
          atomicMin(tile + rel[u], repro::min_key(cand));
        else if (cand != cand)
          atomicMin(tile + rel[u], sw::kNanKey);
      }
    }
    sw::group_sync(g);
    int* slot = partial + static_cast<long long>(j) * vb;
    for (int r = gt; r < vb; r += sw::kGroup) {
      slot[r] = tile[r];
      tile[r] = repro::kInfBits;
    }
    c = c_next;
  }
  // the CTA's slice of dist: any -inf (a dead chunk is then no no-op)
  bool neg = false;
  for (int v = blockIdx.x * sw::kThreads + tid; v < bp;
       v += gridDim.x * sw::kThreads)
    neg |= dist[v] == -inf;
  const int any_neg = __syncthreads_or(neg);
  if (kMasked) {
    const int cnt = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0 && cnt) atomicAdd(&total, cnt);
  }
  // the CTA's tiles (blockIdx.x + k * gridDim.x), `held` at a time: the
  // first ones' distances as keys before the barrier
  const int mine = blockIdx.x < n_vtiles
                       ? (n_vtiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int held = max(1, min(min(mine, sw::kGroups), sw::kThreads / vb));
  int* acc = tiles;                        // [held][vb] keys
  for (int x = tid; x < held * vb; x += sw::kThreads) {
    const int t = blockIdx.x + (x / vb) * gridDim.x;
    if (t < n_vtiles)
      acc[x] = repro::min_key(dist[static_cast<long long>(t) * vb + x % vb]);
  }
  __syncthreads();
  if (tid == 0) {
    cta_words[blockIdx.x] = total;
    cta_words[gridDim.x + blockIdx.x] = any_neg;
  }
  __threadfence();
  cooperative_groups::this_grid().sync();

  // ---- phase B: dist min the slots of each tile, written once
  int nrel_part = 0, neg_any = 0;
  for (int b = tid; b < gridDim.x; b += sw::kThreads) {
    if (kMasked && blockIdx.x == 0) nrel_part += __ldcg(cta_words + b);
    neg_any |= __ldcg(cta_words + gridDim.x + b);
  }
  const int split = max(1, sw::kThreads / (held * vb));  // threads a vertex
  for (int t0 = blockIdx.x; t0 < n_vtiles; t0 += held * gridDim.x) {
    if (t0 != blockIdx.x) {                // later rounds: seed acc here
      for (int x = tid; x < held * vb; x += sw::kThreads) {
        const int t = t0 + (x / vb) * gridDim.x;
        if (t < n_vtiles)
          acc[x] =
              repro::min_key(dist[static_cast<long long>(t) * vb + x % vb]);
      }
      __syncthreads();
    }
    for (int x = tid; x < held * vb * split; x += sw::kThreads) {
      const int k = x / (vb * split);
      const int v = x % vb;
      const int t = t0 + k * gridDim.x;
      if (t >= n_vtiles) continue;
      const int key = sw::slots_min(partial, tile_bounds[t] + (x / vb) % split,
                                    tile_bounds[t + 1], split, vb, v);
      if (key < repro::kInfBits) atomicMin(acc + k * vb + v, key);
    }
    if (__syncthreads_or(neg_any)) {
      // every +inf-weight edge of the tiles, dead chunks included: a source
      // at -inf (in the frontier) makes its target NaN, as -inf + inf does
      for (int k = 0; k < held; ++k) {
        const int t = t0 + k * gridDim.x;
        if (t >= n_vtiles) break;
        const long long base = static_cast<long long>(t) * n_chunks * eb;
        const long long n = static_cast<long long>(n_chunks) * eb;
        for (long long e = tid; e < n; e += sw::kThreads) {
          const long long i = base + e;
          if (w_t[i] < inf && !(kMasked && pruned_t[i] > 0)) continue;
          const int sv = src_t[i];
          if (dist[sv] == -inf && (!kMasked || front[sv] > 0.f))
            atomicMin(acc + k * vb + dstrel_t[i], sw::kNanKey);
        }
      }
      __syncthreads();
    }
    for (int x = tid; x < held * vb; x += sw::kThreads) {
      const int t = t0 + (x / vb) * gridDim.x;
      if (t < n_vtiles)
        out[static_cast<long long>(t) * vb + x % vb] =
            repro::key_value(acc[x]);
    }
    __syncthreads();
  }
  if (kMasked && blockIdx.x == 0) {
    const int cnt = __reduce_add_sync(0xffffffffu, nrel_part);
    if (tid == 0) total = 0;
    __syncthreads();
    if (lane == 0 && cnt) atomicAdd(&total, cnt);
    __syncthreads();
    if (tid == 0) *nrel = total;
  }
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
                        stream>>>(w_t, flags, static_cast<int>(all), eb, 1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    live_list_kernel<<<P, 1024, 0, stream>>>(flags, list, counts, rows,
                                             nullptr, 1);
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

// Kernels 10 and 11's persistent grid: as many CTAs as are co-resident on
// the calling thread's current card (a cooperative launch needs every CTA
// resident: two an SM), no more than the work has (a group a chunk, a CTA a
// tile); 0 on an error. The occupancy is kept by (card, vb, eb), under a
// lock: host threads may launch on several cards at once.
template <bool kMasked>
int sweep_grid(int rows, int n_vtiles, int eb, int vb) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, int> resident;
  int dev = 0, ctas = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(dev, vb, eb);
    const auto it = resident.find(key);
    if (it != resident.end()) {
      ctas = it->second;
    } else {
      const size_t smem =
          static_cast<size_t>(sweep::kGroups) * vb * sizeof(int);
      int sms = 0, per_sm = 0;
      if (repro::allow_smem(relax_sweep_kernel<kMasked>, smem) !=
              cudaSuccess ||
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
              cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, relax_sweep_kernel<kMasked>, sweep::kThreads, smem) !=
              cudaSuccess)
        return 0;
      ctas = sms * per_sm;
      resident.emplace(key, ctas);
    }
  }
  const int work = std::max((rows + sweep::kGroups - 1) / sweep::kGroups,
                            n_vtiles);
  return std::max(1, std::min(ctas, work));
}

// Words of int32 scratch kernel 10 (masked) or 11 takes: a slot of partial
// minima a live chunk, the CTAs' words and, with the pre-pass (prepass),
// its flags, list and tile bounds; -1 when past int range or when no CTA
// fits.
long long sweep_scratch_words(int masked, int prepass, int n_vtiles,
                              int n_chunks, int eb, int vb) {
  const long long rows = static_cast<long long>(n_vtiles) * n_chunks;
  const int grid =
      masked ? sweep_grid<true>(static_cast<int>(rows), n_vtiles, eb, vb)
             : sweep_grid<false>(static_cast<int>(rows), n_vtiles, eb, vb);
  const long long words =
      rows * vb + 2LL * grid + (prepass ? 2 * rows + n_vtiles + 1 : 0);
  return grid < 1 || words > 0x7fffffffLL ? -1 : words;
}

// Kernels 10 and 11: the live chunks idx / tile bounds from the caller, or
// (idx null) the pre-pass's, written to the end of scratch on the same
// stream; then the cooperative launch.
template <bool kMasked>
int launch_sweep(const float* dist, const float* front, const int* src_t,
                 const float* w_t, const int* dstrel_t, const int* pruned_t,
                 const int* idx, const int* bounds, float* out, int* nrel,
                 int* scratch, int n_vtiles, int n_chunks, int eb, int vb,
                 cudaStream_t stream) {
  if (n_vtiles == 0)
    return static_cast<int>(
        kMasked ? cudaMemsetAsync(nrel, 0, sizeof(int), stream) : cudaSuccess);
  const int rows = n_vtiles * n_chunks;
  const int grid = sweep_grid<kMasked>(rows, n_vtiles, eb, vb);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const uintptr_t planes =
      reinterpret_cast<uintptr_t>(src_t) | reinterpret_cast<uintptr_t>(w_t) |
      reinterpret_cast<uintptr_t>(dstrel_t) |
      reinterpret_cast<uintptr_t>(kMasked ? pruned_t : src_t);
  int vec = eb % 4 == 0 && planes % 16 == 0;
  int* partial = scratch;
  int* cta_words = scratch + static_cast<long long>(rows) * vb;
  if (idx == nullptr) {
    int* flags = cta_words + 2 * grid;
    int* list = flags + rows;
    int* tb = list + rows;
    live_flags_kernel<<<(rows + 15) / 16, 512, 0, stream>>>(w_t, flags, rows,
                                                            eb, vec);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    live_list_kernel<<<1, 1024, 0, stream>>>(flags, list, tb + n_vtiles, rows,
                                             tb, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    idx = list;
    bounds = tb;
  }
  void* args[] = {&dist, &front, &src_t, &w_t, &dstrel_t, &pruned_t, &idx,
                  &bounds, &out, &nrel, &partial, &cta_words, &n_vtiles,
                  &n_chunks, &eb, &vb, &vec};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(relax_sweep_kernel<kMasked>), grid,
      sweep::kThreads, args,
      static_cast<size_t>(sweep::kGroups) * vb * sizeof(int), stream));
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

// Words of int32 scratch the entry points below take (sweep_scratch_words).
extern "C" int relax_sweep_scratch_words(int masked, int prepass,
                                         int n_vtiles, int n_chunks, int eb,
                                         int vb) {
  return static_cast<int>(
      sweep_scratch_words(masked, prepass, n_vtiles, n_chunks, eb, vb));
}

// Kernel 10: one masked, counted Jacobi sweep over the live chunks; dense
// layout [n_vtiles, n_chunks, eb], rows [bp], nrel [1]. chunk_idx
// [n_vtiles * n_chunks] and chunk_bounds [n_vtiles + 1]: the live chunks
// (common.py: live_chunks), or both null for the pre-pass; scratch
// [relax_sweep_scratch_words(1, null idx, ...)] int32.
extern "C" int relax_masked(const float* dist, const float* front,
                            const int* src_t, const float* w_t,
                            const int* dstrel_t, const int* pruned_t,
                            const int* chunk_idx, const int* chunk_bounds,
                            float* out, int* nrel, int* scratch, int n_vtiles,
                            int n_chunks, int eb, int vb,
                            cudaStream_t stream) {
  return launch_sweep<true>(dist, front, src_t, w_t, dstrel_t, pruned_t,
                            chunk_idx, chunk_bounds, out, nrel, scratch,
                            n_vtiles, n_chunks, eb, vb, stream);
}

// Kernel 11: one unmasked Jacobi sweep over the live chunks; operands as
// kernel 10's.
extern "C" int relax_sweep(const float* dist, const int* src_t,
                           const float* w_t, const int* dstrel_t,
                           const int* chunk_idx, const int* chunk_bounds,
                           float* out, int* scratch, int n_vtiles,
                           int n_chunks, int eb, int vb, cudaStream_t stream) {
  return launch_sweep<false>(dist, nullptr, src_t, w_t, dstrel_t, nullptr,
                             chunk_idx, chunk_bounds, out, nullptr, scratch,
                             n_vtiles, n_chunks, eb, vb, stream);
}
