// The Gauss-Seidel sweep chain of one (shard, query) row, for Hopper: the
// relax stage of kernels 2 (csrc/relax.cu, relax_ragged_fixpoint_batch) and
// 8 (csrc/round.cu, fused_round_ragged) over the ragged layout, and of
// kernels 1 (relax.cu, relax_fixpoint_batch), 9 (relax.cu, relax_fixpoint)
// and 7 (round.cu, fused_round_tiled) over the dense layout's live chunks
// (kList).
//
// What it computes: up to n_sweeps frontier-chased min-plus sweeps; a sweep
// walks the shard's chunks in layout order, chunk c landing in vertex tile
// min(ctile[c], n_vtiles - 1) (ragged) or c / n_chunks (dense); each chunk
// gathers o[src] + w for the edges whose source is in the sweep's frontier
// (pruned edges count as +inf), min-reduces them per destination in a
// shared tile of keys (tile_min_into), and only then mins the tile into
// the live row. The next sweep's frontier is the set of vertices improved
// in this one (exactly o_end < o_start, as the row never rises); a row
// whose sweep improved nothing stops. So every distance and every count,
// q_relaxations included, is the reference's.
//
// The dense layout gives every tile as many chunks as the heaviest tile
// needs and pads the rest with w = +inf; at the scale-1e6 layouts 65-74% of
// its chunks hold no finite weight. Such a chunk is an exact no-op (every
// candidate is +inf and it counts nothing), so with kList the chain walks
// only the live chunks, a list of chunk indices in layout order (so their
// tiles do not decrease, as the window needs) whose length the kernel
// reads from device memory. It is the dense order minus its dead chunks,
// as the ragged order is. kList false compiles to the ragged path.
//
// What bounds it: the order. Each chunk may read what the previous one
// wrote, so a row is a chain of up to n_sweeps * chunks steps; the design
// below takes device memory off that chain, and a step is then one SM's
// own work between two barriers of 16 warps: shared-memory reads, window
// look-ups and atomicMins, and one L1 request per early gather (random
// 4-byte reads). Bytes are not the limit (PERF.md gives a step's time).
//
// What the design does about it:
//  - The layout is streamed ahead. A producer warp keeps a ring of
//    kStages = 16 chunk stages full with bulk copies (cp.async.bulk,
//    completing on a full mbarrier per stage; the consumers release a stage
//    on its empty mbarrier once the chunk is reduced). A stage holds the
//    chunk's src, w, dstrel and pruned planes and its ctile. The ring runs
//    on across sweep boundaries (the layout is the same every sweep); when
//    the consumers stop, the producer stops at its next wait and the
//    consumers wait out the copies in flight before the block exits. One
//    consumer (the keeper) waits on a stage's mbarrier; the others read it
//    behind the next consumer barrier.
//  - The frontier and the improved set are bitmasks, bp / 8 bytes each, in
//    shared memory when they fit beside the ring (bits_in_smem), else in a
//    global scratch row: a placement, the same code through a generic
//    pointer. Shared memory always holds the ring, the staging slots, the
//    window and the tile -> slot map (a byte a vertex tile), so a row has a
//    cap: layout_fits. With the bitmasks in device memory it is 83,904
//    vertex tiles for kernel 2 and 75,200 for kernel 8 (EB 512, VB = SB =
//    128: 10,739,712 and 9,625,600 vertices a shard); past it the wrappers
//    raise (the *_ragged_scratch_bytes entry points return -1).
//  - The distance gathers of chunk c + D (D = kLookahead = 2) are issued
//    (cp.async, 4 bytes a frontier edge, into a staging slot of D + 1,
//    beside the edge's source) while chunk c is reduced, from the row in
//    device memory. The frontier is fixed for the sweep and only o
//    changes, so such a gather is stale only if its source's tile was
//    written after the issue. A run of
//    chunks of one tile (ctile does not decrease, so a tile has one run a
//    sweep) keeps the tile's live values in a shared window slot, filled D
//    chunks ahead and written back to the row once, at the run's end; the
//    window holds kSlots = 4D runs, and a tile's slot is published
//    (slotmap) when its run starts. At use time a source whose tile has a
//    slot is read there (the hazard re-read), every other source from its
//    early gather. Every tile written since a gather was issued still has
//    its slot then: the runs of chunks c - D .. c + D span at most 2D + 1
//    slots and a slot is evicted only when a run 4D later opens
//    (tests/test_torch_relax_schedule.py emulates this order and checks
//    that claim at every step).
//  - A chunk step c is then: chunk c - 1's writes, chunk c's run published
//    and chunk c + D's slot evicted; a consumer barrier; chunk c's reads
//    and atomicMins, with chunk c + D's early gathers and window fill
//    beside them in the same loop, so their loads overlap; a consumer
//    barrier. Reads before writes, as in the reference. The sweep drains
//    at its end: the next frontier needs the whole sweep.
#pragma once

#include <cstdint>

#include "tile_reduce.cuh"

namespace repro {
namespace ragged {

constexpr int kConsumers = 512;               // warps 0-15: the chain
constexpr int kThreads = kConsumers + 32;     // warp 16: the producer
constexpr int kWarps = kThreads / 32;
constexpr int kKeeper = kConsumers - 1;       // keeps the window's slot map
constexpr int kSmemLimit = 232448;            // dynamic shared memory a block

// D: the early gathers run D chunks ahead. 2, 4 and 8 were within 3% of
// each other at the scale-1e7 state on an H100 (PERF.md), 2 the fastest
// and the least shared memory.
constexpr int kLookahead = 2;
constexpr int kStages = 16;                   // ring of layout chunks
constexpr int kStaging = kLookahead + 1;      // staging slots of early gathers
constexpr int kSlots = 4 * kLookahead;        // window of tile runs

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Bytes of a row's frontier and improved bitmasks.
__host__ __device__ inline int bit_words(int bp) { return (bp + 31) / 32; }
__host__ __device__ inline int vstate_bytes(int bp) {
  return 2 * bit_words(bp) * 4;
}

// Byte offsets into the block's dynamic shared memory.
struct Layout {
  int bars, ctl, ring, stage, staging, window, tile, tags, slots, extra,
      vstate, total;
};

// `extra`: bytes the caller keeps for itself (kernel 8's per-warp tiles);
// `vstate`: the bitmasks' bytes in shared memory (0 when they live in
// device memory). The tile -> window slot map (a signed byte a tile) is
// always in shared memory.
__host__ __device__ inline Layout smem_layout(int eb, int vb, int n_vtiles,
                                              int extra, int vstate) {
  Layout L;
  int o = 0;
  L.bars = o;    o += align16(2 * kStages * 8);
  L.ctl = o;     o += 32;   // ints 0-2 the chain's, 4-7 the caller's
  L.stage = 16 * eb + 16;                     // 4 planes of eb, ctile
  L.ring = o;    o += kStages * L.stage;
  L.staging = o; o += align16(kStaging * eb * 8);   // distances, sources
  L.window = o;  o += align16(kSlots * vb * 4);
  L.tile = o;    o += align16(vb * 4);
  L.tags = o;    o += align16(kSlots * 4);
  L.slots = o;   o += align16(n_vtiles);
  L.extra = o;   o += align16(extra);
  L.vstate = o;  o += vstate;
  L.total = o;
  return L;
}

// Whether the chain fits in shared memory with the bitmasks in device
// memory (the row's cap), and whether they fit there beside everything else.
inline bool layout_fits(int n_vtiles, int eb, int vb, int extra) {
  return smem_layout(eb, vb, n_vtiles, extra, 0).total <= kSmemLimit;
}

inline bool bits_in_smem(int bp, int n_vtiles, int eb, int vb, int extra) {
  return smem_layout(eb, vb, n_vtiles, extra, vstate_bytes(bp)).total <=
         kSmemLimit;
}

// Bytes of vertex state a row needs in device memory: 0 when its bitmasks
// fit in shared memory, -1 when the row is past the cap.
inline int scratch_bytes(int bp, int n_vtiles, int eb, int vb, int extra) {
  if (!layout_fits(n_vtiles, eb, vb, extra)) return -1;
  return bits_in_smem(bp, n_vtiles, eb, vb, extra) ? 0 : vstate_bytes(bp);
}

// ---- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try(bar, parity)) {
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device to
// shared memory, completing on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Barrier 1 over the consumer warps alone (the producer never joins it),
// and its OR-reduction.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ int consumers_or(int pred) {
  int r;
  asm volatile(
      "{\n.reg .pred p, q;\n"
      "setp.ne.s32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, %2, p;\n"
      "selp.s32 %0, 1, 0, q;\n}\n"
      : "=r"(r) : "r"(pred), "n"(kConsumers) : "memory");
  return r;
}

__device__ __forceinline__ bool bit(const uint32_t* bits, int v) {
  return (bits[v >> 5] >> (v & 31)) & 1u;
}

// The key tile_min_into reduces (min_key), +inf bits for no candidate.
__device__ __forceinline__ int cand_key(float cand) {
  return cand < inf_f() ? min_key(cand) : kInfBits;
}

// Vertex v's flag of four consecutive ones packed into word v / 32 of
// `bits`: lane l of a warp holds the flags of vertices 4i .. 4i + 3 (i the
// lane's float4 index) as the nibble `nib`; the 8 lanes of a word combine
// theirs and the first writes it. Every lane of the warp calls it.
__device__ __forceinline__ void pack_nibbles(uint32_t* bits, int i,
                                             unsigned nib, bool in_range) {
  const int lane = threadIdx.x & 31;
  unsigned w = nib << (4 * (lane & 7));
  w |= __shfl_xor_sync(0xffffffffu, w, 1);
  w |= __shfl_xor_sync(0xffffffffu, w, 2);
  w |= __shfl_xor_sync(0xffffffffu, w, 4);
  if (in_range && (lane & 7) == 0) bits[i >> 3] = w;
}

__device__ __forceinline__ unsigned nibble(float4 f) {
  return (f.x > 0.f) | (f.y > 0.f) << 1 | (f.z > 0.f) << 2 | (f.w > 0.f) << 3;
}

// The residual frontier as 0/1 floats: resid[v] = bit v of `bits`, four a
// thread (bp a multiple of 32).
__device__ __forceinline__ void unpack_bits(float* resid, const uint32_t* bits,
                                            int bp, int nthreads) {
  float4* r4 = reinterpret_cast<float4*>(resid);
  for (int i = threadIdx.x; i < bp / 4; i += nthreads) {
    const unsigned n = bits[i >> 3] >> (4 * (i & 7));
    r4[i] = make_float4(n & 1u, (n >> 1) & 1u, (n >> 2) & 1u, (n >> 3) & 1u);
  }
}

// ---- the chain --------------------------------------------------------------

// One row: the live row o in device memory, the two bitmasks (bits[cur] is
// the frontier), and the shard's layout rows. Ragged: the chain walks
// chunks 0 .. rows - 1, chunk c in tile ct[c]. kList (dense): it walks the
// live chunks idx[0 .. rows - 1], chunk c in tile c / n_chunks.
struct Chain {
  float* o;
  uint32_t* bits[2];
  const int* ct;
  const int* src;
  const float* w;
  const int* rel;
  const int* prn;
  int bp, n_vtiles, rows, eb, vb, n_sweeps;
  const int* idx;
  int n_chunks;
};

// The chunk's stage in the ring: src, w, dstrel, pruned planes, then ctile.
struct StageView {
  const int* src;
  const float* w;
  const int* rel;
  const int* prn;
};

__device__ __forceinline__ StageView view(const unsigned char* st, int eb) {
  return {reinterpret_cast<const int*>(st),
          reinterpret_cast<const float*>(st + 4 * eb),
          reinterpret_cast<const int*>(st + 8 * eb),
          reinterpret_cast<const int*>(st + 12 * eb)};
}

// The stage's vertex tile, the sentinel of padding chunks clamped.
__device__ __forceinline__ int stage_tile(const unsigned char* st, int eb,
                                          int n_vtiles) {
  return min(*reinterpret_cast<const int*>(st + 16 * eb), n_vtiles - 1);
}

// Runs the chain; every thread of the block calls it (kThreads), with the
// row's initial frontier in bits[0] and bits[1] zero, both complete (a
// block barrier behind), and `active` block-uniform. Returns this thread's
// share of the relaxation count; on return (behind a block barrier) the
// row is final in device memory and the returned index `resid` names the
// bitmask of vertices improved in the last sweep run (the residual
// frontier). kHazard false is a planted fault for the checks only: every
// source is read from its early gather. kList: the chain walks the live
// chunk list ch.idx (rows > 0; the caller makes a row with no live chunk
// inactive).
template <bool kHazard, bool kList = false>
__device__ int sweeps(unsigned char* smem, const Layout& L, const Chain& ch,
                      int active, int* resid) {
  constexpr int D = kLookahead;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + kStages;
  // stop, chunks issued, the bitmask that is the frontier
  volatile int* ctl = reinterpret_cast<int*>(smem + L.ctl);
  unsigned char* ring = smem + L.ring;
  float* staging = reinterpret_cast<float*>(smem + L.staging);
  float* win = reinterpret_cast<float*>(smem + L.window);
  int* tile = reinterpret_cast<int*>(smem + L.tile);
  int* tag = reinterpret_cast<int*>(smem + L.tags);
  signed char* slotmap = reinterpret_cast<signed char*>(smem + L.slots);
  const int tid = threadIdx.x;
  const int eb = ch.eb;
  const int vb = ch.vb;
  const long long total =
      active ? static_cast<long long>(ch.n_sweeps) * ch.rows : 0;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 1);
    }
    ctl[0] = 0;
    ctl[1] = 0;
    ctl[2] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int v = tid; v < vb; v += kThreads) tile[v] = kInfBits;
  __syncthreads();

  int count = 0;
  int consumed = 0;                           // chunks through the ring
  if (tid >= kConsumers) {
    // ---- the producer warp: chunk g of the stream is chunk g % rows of
    // the layout (ragged) or of the live list (kList) ----
    const int lane = tid - kConsumers;
    long long g = 0;
    bool stopped = false;
    for (long long base = 0; base < total && !stopped; base += 32) {
      int ctv = 0, cv = 0;
      if (base + lane < total) {
        if constexpr (kList) {
          cv = ch.idx[(base + lane) % ch.rows];
          ctv = cv / ch.n_chunks;
        } else {
          ctv = ch.ct[(base + lane) % ch.rows];
        }
      }
      const int n = static_cast<int>(min(32LL, total - base));
      for (int j = 0; j < n; ++j, ++g) {
        const int ctj = __shfl_sync(0xffffffffu, ctv, j);
        int cj = 0;
        if constexpr (kList) cj = __shfl_sync(0xffffffffu, cv, j);
        if (lane == 0) {
          const int st = static_cast<int>(g % kStages);
          const uint32_t par =
              (static_cast<uint32_t>(g / kStages) & 1u) ^ 1u;
          while (!mbar_try(empty + st, par))
            if (ctl[0]) {
              stopped = true;
              break;
            }
          if (!stopped) {
            unsigned char* s = ring + st * L.stage;
            *reinterpret_cast<int*>(s + 16 * eb) = ctj;
            const long long off =
                (kList ? static_cast<long long>(cj) : g % ch.rows) *
                static_cast<long long>(eb);
            mbar_expect_tx(full + st, 16u * eb);
            bulk_load(s, ch.src + off, 4u * eb, full + st);
            bulk_load(s + 4 * eb, ch.w + off, 4u * eb, full + st);
            bulk_load(s + 8 * eb, ch.rel + off, 4u * eb, full + st);
            bulk_load(s + 12 * eb, ch.prn + off, 4u * eb, full + st);
          }
        }
        stopped = __shfl_sync(0xffffffffu, stopped, 0);
        if (stopped) break;
      }
    }
    if (lane == 0) ctl[1] = static_cast<int>(g);
  } else {
    // ---- the consumers ----
    int cur = 0;
    const int words = bit_words(ch.bp);
    const int lane = tid & 31;
    const int vshift = (vb & (vb - 1)) == 0 ? __ffs(vb) - 1 : -1;
    float* sdist = staging;                   // [kStaging][eb] early gathers
    int* ssrc =                               // [kStaging][eb] their sources
        reinterpret_cast<int*>(staging + kStaging * eb);
    for (int s = 0; s < ch.n_sweeps && active; ++s) {
      int any = 0;
      if (s > 0) {                            // the next frontier
        cur ^= 1;
        uint32_t* im = ch.bits[cur ^ 1];
        for (int x = tid; x < words; x += kConsumers) {
          any |= ch.bits[cur][x] != 0;
          im[x] = 0;
        }
      }
      for (int t = tid; t < ch.n_vtiles; t += kConsumers) slotmap[t] = -1;
      for (int k = tid; k < kSlots; k += kConsumers) tag[k] = -1;
      active = consumers_or(s == 0 || any);
      if (!active) break;
      const uint32_t* fr = ch.bits[cur];
      uint32_t* im = ch.bits[cur ^ 1];

      // wait(c): the keeper waits for chunk c's stage to land; the other
      // threads read it only behind a consumer barrier after that wait.
      // track(c): the issue pointer moves to chunk c: n_* say its tile,
      // whether it opens a run, and the run's slot
      auto wait = [&](int c) {
        const int g = consumed + c;
        if (tid == kKeeper)
          mbar_wait(full + g % kStages, (g / kStages) & 1);
      };
      int i_prev = -1, i_run = -1, n_tile = 0, n_slot = 0;
      bool n_opens = false;
      auto track = [&](int c) {
        n_tile = stage_tile(ring + (consumed + c) % kStages * L.stage, eb,
                            ch.n_vtiles);
        n_opens = n_tile != i_prev;
        if (n_opens) n_slot = ++i_run % kSlots;
        i_prev = n_tile;
      };
      // evict(): the keeper frees the slot of the run that chunk n opens
      auto evict = [&]() {
        if (tid == kKeeper && n_opens) {
          if (tag[n_slot] >= 0) slotmap[tag[n_slot]] = -1;
          tag[n_slot] = n_tile;
        }
      };
      // fill(): chunk n opens a run: fill its window slot from the row
      auto fill = [&]() {
        if (!n_opens) return;
        const float* ot = ch.o + static_cast<long long>(n_tile) * vb;
#pragma unroll 1
        for (int v = tid; v < vb; v += kConsumers)
          cp_async4(win + n_slot * vb + v, ot + v);
      };
      // edges(cu, ci): chunk cu's reads and reduce (cu >= 0), beside chunk
      // ci's early gathers (ci >= 0: the distances of its frontier edges
      // into staging slot ci % (D + 1), their sources noted, -1 for no
      // candidate). The loads of both come first, so their latencies
      // overlap.
      auto edges = [&](int cu, int ci) {
        const StageView su =
            view(ring + (consumed + max(cu, 0)) % kStages * L.stage, eb);
        const StageView si =
            view(ring + (consumed + max(ci, 0)) % kStages * L.stage, eb);
        const float* sdu = sdist + (max(cu, 0) % kStaging) * eb;
        const int* sxu = ssrc + (max(cu, 0) % kStaging) * eb;
        float* sdi = sdist + (max(ci, 0) % kStaging) * eb;
        int* sxi = ssrc + (max(ci, 0) % kStaging) * eb;
#pragma unroll 1
        for (int e = tid; e < eb; e += kConsumers) {
          int xu = -1, ru = 0, xi = -1, pi = 1;
          float du = 0.f, wu = 0.f, wi = inf_f();
          if (cu >= 0) {
            xu = sxu[e];
            du = sdu[e];
            wu = su.w[e];
            ru = su.rel[e];
          }
          if (ci >= 0) {
            wi = si.w[e];
            pi = si.prn[e];
            xi = si.src[e];
          }
          if (kHazard && xu >= 0) {
            const int t = vshift >= 0 ? xu >> vshift : xu / vb;
            const int k = slotmap[t];
            if (k >= 0) du = win[k * vb + (xu - t * vb)];
          }
          if (ci >= 0) {
            const bool need = wi < inf_f() && pi == 0 && bit(fr, xi);
            if (need) cp_async4(sdi + e, ch.o + xi);
            sxi[e] = need ? xi : -1;
          }
          if (xu >= 0) {
            ++count;
            tile_min_into(tile, ru, du + wu);
          }
        }
      };
      // write(c): min chunk c's tile into its window slot, mark the
      // improved vertices, reset the tile; at the run's end write the slot
      // back to the row (vb is a multiple of 32, so a warp's 32 vertices
      // are one word of the improved bitmask, which no other warp writes
      // this sweep)
      auto write = [&](int t, int k, bool last) {
        float* wk = win + k * vb;
#pragma unroll 1
        for (int v = tid; v < vb; v += kConsumers) {
          const float m = key_value(tile[v]);
          const float was = wk[v];
          tile[v] = kInfBits;
          const bool better = m < was;
          if (better) wk[v] = m;
          const unsigned bits = __ballot_sync(0xffffffffu, better);
          if (lane == 0 && bits) im[(t * vb + v) >> 5] |= bits;
          if (last) ch.o[static_cast<long long>(t) * vb + v] = better ? m : was;
        }
      };

      for (int c = 0; c < D; ++c) {           // the prologue
        if (c < ch.rows) {
          wait(c);
          consumers_sync();
          track(c);
          evict();
          fill();
          edges(-1, c);
        }
        cp_async_commit();
      }
      if (D < ch.rows) wait(D);
      consumers_sync();
      int u_prev = -1, u_run = -1, u_slot = 0;
#pragma unroll 1
      for (int c = 0; c < ch.rows; ++c) {
        // chunk c - 1's writes; chunk c's run published; the slot of chunk
        // c + D's run evicted; chunk c's early gathers and window landed
        const int st = (consumed + c) % kStages;
        const int tile_c = stage_tile(ring + st * L.stage, eb, ch.n_vtiles);
        const bool opens = tile_c != u_prev;
        const int slot = opens ? ++u_run % kSlots : u_slot;
        if (c > 0) write(u_prev, u_slot, opens);
        if (tid == kKeeper && opens)
          slotmap[tile_c] = static_cast<signed char>(slot);
        const bool ahead = c + D < ch.rows;
        if (ahead) {
          track(c + D);
          evict();
        }
        cp_async_wait<D - 1>();
        consumers_sync();                     // writes before reads

        // chunk c's reads and reduce, beside chunk c + D's early gathers
        if (ahead) fill();
        edges(c, ahead ? c + D : -1);
        cp_async_commit();
        if (ahead && c + D + 1 < ch.rows) wait(c + D + 1);
        consumers_sync();                     // reads before writes
        if (tid == 0) mbar_arrive(empty + st);
        u_prev = tile_c;
        u_slot = slot;
      }
      write(u_prev, u_slot, true);            // the pipeline drains
      cp_async_wait<0>();
      consumers_sync();
      consumed += ch.rows;
    }
    if (tid == 0) {
      ctl[2] = cur;
      __threadfence_block();
      ctl[0] = 1;                             // stop the producer
    }
  }
  __syncthreads();
  if (tid == 0)                               // copies still in flight
    for (int g = consumed; g < ctl[1]; ++g)
      mbar_wait(full + g % kStages, (g / kStages) & 1);
  *resid = ctl[2] ^ 1;
  __syncthreads();
  return count;
}

}  // namespace ragged
}  // namespace repro
