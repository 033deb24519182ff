// Send-phase pack: per message slot, min over cut edges of dist[src] + w,
// for all K queries, masked against last_sent; dense and ragged layouts.
//
// Replaces: kernels/send/send.py: send_pack_tiled (the Pallas kernel
// _send_pack_kernel, grid (slot tile, chunk)) and send_pack_ragged (the
// Pallas kernel _send_pack_ragged_kernel, grid (chunk,), with the
// chunk->tile map ctile scalar-prefetched and a global init and finalize).
//
// What it computes: for slot tile i of shard p, the per-slot minima of the
// tile's cut-edge candidates (Trishla-pruned edges count as +inf), then the
// tile finalizer of the reference: improved = valid & (min < last_sent);
// send value = min where improved, else +inf; new last_sent = min where
// improved, else the old value; per-query counts of improved slots. The
// dense layout gives every tile n_chunks chunks; the ragged layout gives
// tile i the chunk range [bounds[i], bounds[i+1]), which the builders make
// contiguous (ctile is non-decreasing) and which may be empty. The
// reference finalizes the ragged layout once, over the whole row, after
// its last chunk; finalizing per tile, after the tile's own chunks, gives
// the same values, because accumulation never reads the mask, and a tile
// with no chunks finalizes to +inf with no send, as there.
//
// What bounds it: bytes, once the distance gathers are cheap. Each layout
// chunk (src, w, segrel, pruned) is read once and serves all K queries;
// the rows and the [K, S] slot rows (last_sent read, val and new_last
// written) are the rest. A live edge gathers dist[p, q, src] for every
// query q, and in the [P, K, bp] rows the K values of one source lie
// bp * 4 bytes apart: K sectors of 32 bytes an edge. The kernel of one
// edge a thread, K gathers in a loop, took 0.97 ms at the scale-1e7
// layout with K = 16 (8.6M cut edges; byte bound 0.13 ms, H100).
//
// Design, for Hopper (kernels 4 and 3, one template; kRagged picks how a
// tile finds its chunks):
//  - The entry point first writes the rows query-interleaved, [P, bp, K]
//    (interleave_kernel: a tiled transpose through shared memory, on the
//    same stream; skipped at K = 1, where the two layouts are one), so the
//    K candidates of an edge are K * 4 contiguous bytes.
//  - One CTA of 256 threads per (shard, slot tile), a grid of P *
//    n_stiles; tiles have no dependency on each other. The CTA walks the
//    tile's edges in batches (1,024 edges, fewer at the largest K; see
//    below): it stages a batch's live edges (finite and unpruned) in
//    shared memory, compacted (a ballot a warp; the order is free, as a
//    min is), each thread issuing all its loads of the batch before it
//    compacts any. Then its threads take the staged
//    edges as flat (edge, query) pairs, query fastest: K neighbouring lanes
//    read one staged edge (a shared-memory broadcast) and gather its K
//    candidates in one coalesced request. Each thread reads kUnroll pairs,
//    then issues their kUnroll gathers, then reduces: many gathers in
//    flight a thread and no wait on device memory between an edge and its
//    gathers, as round.cu's reduce_by_warp. Padding and pruned edges cost
//    no pair.
//  - The tile of minima is slot-major, [sb][kp] keys (min_key) with kp = K
//    rounded up to odd: the K atomicMins of one edge land in K banks, the
//    same-address atomics of a hub slot spread over its queries, and the
//    finalizer's reads (query-major, slot fastest, so its stores to the
//    [K, S] rows are coalesced) stride kp words, conflict-free.
//  - The finalizer runs in the same CTA once all chunks are in; per-query
//    counts are summed a warp at a time into shared memory and added to the
//    [P, K] output with one atomicAdd per (CTA, query). Data read or
//    written once (layout, slot rows) is streamed (evict first), so L2
//    keeps the interleaved rows that the gathers revisit.
//  - Query groups: a CTA holds the tile of minima of Kg queries, the
//    queries [q0, q0 + Kg) of group blockIdx.y (a grid of P * n_stiles by
//    G groups), and gathers their Kg contiguous candidates from offset q0
//    of the one interleaved row buffer. Kg = K, one group, whenever the
//    tile of all K queries leaves room for a full staged batch (1,024
//    edges; K up to 418 at slot tiles of 128, 1,636 at 32). Past that, G
//    is the fewest groups whose CTAs, each beside a full batch, fit
//    kShare = 6 to an SM, and Kg = ceil(K / G) spreads the queries evenly
//    (K = 450 at sb = 128: eleven groups of 41; 1,000: twenty-four of 42),
//    so the batch never shrinks below 1,024 edges. The pairs' gathers are
//    latency-bound, so the CTAs an SM holds set the speed: the fewest
//    groups that fit a block (one CTA an SM) ran several times slower at
//    K = 450 and 1,000 on an H100 than kShare 4 or 6, 6 the fastest tried
//    (chip_smoke.py times K = 450, 512 and 1,000). Each group re-reads the
//    layout, G times its bytes. Every output is per query, so the split is
//    exact. Only a
//    slot tile too wide for one query's tile beside one staged edge has no
//    shape (send_smem_bytes returns -1; the wrapper raises before any
//    launch). The odd row stride drops to Kg where its padding does not
//    fit.
#include <algorithm>

#include "tile_reduce.cuh"

namespace {

constexpr int kPackThreads = 256;     // threads a pack CTA
constexpr int kStage = 4;             // edges a thread stages a batch
constexpr int kBatch = kStage * kPackThreads;   // most edges a batch stages
constexpr int kUnroll = 4;            // pairs whose gathers a thread issues
constexpr int kSmemLimit = 232448;    // dynamic shared memory a block
constexpr int kShare = 6;             // past one group: CTAs an SM holds
constexpr int kIlvThreads = 256;      // threads an interleave block
constexpr int kIlvV = 128;            // vertices of an interleave tile
constexpr int kIlvQ = 32;             // queries of an interleave tile

// Data read or written once: streamed past the caches (evict first), so
// that L2 keeps the interleaved rows that the gathers revisit.
template <typename T>
__device__ __forceinline__ T once(const T* p) {
  return __ldcs(p);
}
__device__ __forceinline__ void put_once(float* p, float v) { __stcs(p, v); }

// The pack CTA's shared memory: the staged batch of nb edges (16 bytes an
// edge), the tile of minima [sb][kp] of its kg queries, the counts and the
// staged count.
inline long long smem_bytes(int kg, int kp, int sb, int nb) {
  return 16LL * nb + (static_cast<long long>(sb) * kp + kg + 1) * 4;
}

// The pack CTA's shape: its queries kg, the groups of the launch, the
// tile's row stride kp (kg rounded up to odd, or kg where that padding does
// not fit), the staged batch nb (kBatch edges, or as many as the shared
// memory the tile leaves free holds) and the bytes.
struct PackShape {
  int kg, groups, kp, nb;
  long long smem;
};

// kg queries a CTA with a staged batch of at least min_nb edges, in at most
// `limit` bytes.
inline bool fit(int kg, int sb, int min_nb, long long limit, PackShape* s) {
  for (const int kp : {kg | 1, kg}) {
    const long long left = limit - smem_bytes(kg, kp, sb, 0);
    if (left >= 16LL * min_nb) {
      s->kg = kg;
      s->kp = kp;
      s->nb = static_cast<int>(std::min<long long>(kBatch, left / 16));
      s->smem = smem_bytes(kg, kp, sb, s->nb);
      return true;
    }
  }
  return false;
}

// The most queries (at most K - 1) a CTA holds beside a full staged batch
// in `limit` bytes, 0 when not one.
inline int most_queries(int K, int sb, long long limit) {
  PackShape s;
  int lo = 0, hi = K - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (fit(mid, sb, kBatch, limit, &s)) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// K queries and slot tiles of sb: one group when all K fit beside a full
// staged batch; else the fewest groups whose CTAs, each beside a full
// batch, fit kShare to an SM (else one to an SM), the queries spread
// evenly; else one query a group beside the batch that fits; false when
// not even one query and one staged edge fit.
inline bool pack_shape(int K, int sb, PackShape* s) {
  if (K < 1) return false;
  if (fit(K, sb, kBatch, kSmemLimit, s)) {
    s->groups = 1;
    return true;
  }
  int most = most_queries(K, sb, kSmemLimit / kShare);
  if (most == 0) most = most_queries(K, sb, kSmemLimit);
  int kg = 1, min_nb = 1;
  if (most >= 1) {
    const int groups = (K + most - 1) / most;
    kg = (K + groups - 1) / groups;
    min_nb = kBatch;
  }
  if (!fit(kg, sb, min_nb, kSmemLimit, s)) return false;
  s->groups = (K + kg - 1) / kg;
  return true;
}

// rows [P, K, bp] -> out [P, bp, K]: block (vertex tile, query tile, p)
// stages a [32 queries][128 vertices] tile in shared memory (rows read
// along vertices), then writes the tile's vertices one after another, its
// queries contiguous (at K <= 32 the tile's output is one contiguous run).
__global__ void __launch_bounds__(kIlvThreads)
interleave_kernel(const float* __restrict__ rows, float* __restrict__ out,
                  int K, int bp) {
  __shared__ float t[kIlvQ][kIlvV + 1];
  const int p = blockIdx.z;
  const int v0 = blockIdx.x * kIlvV;
  const int q0 = blockIdx.y * kIlvQ;
  const int nv = min(kIlvV, bp - v0);
  const int nq = min(kIlvQ, K - q0);
  const float* in = rows + static_cast<long long>(p) * K * bp;
  for (int i = threadIdx.x; i < kIlvQ * kIlvV; i += kIlvThreads) {
    const int ql = i / kIlvV, vl = i % kIlvV;
    if (ql < nq && vl < nv)
      t[ql][vl] = once(in + static_cast<long long>(q0 + ql) * bp + v0 + vl);
  }
  __syncthreads();
  float* o = out + static_cast<long long>(p) * bp * K;
  // element i of the output tile is (vertex i / nq, query i % nq), stepped
  int vl = threadIdx.x / nq, ql = threadIdx.x % nq;
  const int dv = kIlvThreads / nq, dql = kIlvThreads % nq;
  for (int i = threadIdx.x; i < nv * nq; i += kIlvThreads) {
    o[static_cast<long long>(v0 + vl) * K + q0 + ql] = t[ql][vl];
    vl += dv;
    ql += dql;
    if (ql >= nq) {
      ql -= nq;
      ++vl;
    }
  }
}

// The (edge, query) pairs of the n staged edges and the group's K queries,
// min-reduced into the tile: pair f = threadIdx.x + j * kPackThreads is
// edge f / K, query f % K, stepped without a division (kFixed: K divides
// the CTA, so a thread's query never changes). kUnroll staged reads (a
// broadcast to the K lanes of an edge), then kUnroll gathers in flight,
// then the reduce.
template <bool kFixed>
__device__ __forceinline__ void reduce_pairs(const int4* staged, int n,
                                             int K,
                                             const float* __restrict__ drow,
                                             int* tile) {
  const int de = kPackThreads / K, dqs = kPackThreads % K;
  int e = threadIdx.x / K, q = threadIdx.x % K;
  while (e < n) {
    int off[kUnroll], at[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int4 st = e < n ? staged[e] : make_int4(0, 0, repro::kInfBits, 0);
      off[u] = st.x + q;
      at[u] = st.y + q;
      w[u] = __int_as_float(st.z);
      e += de;
      if (!kFixed) {
        q += dqs;
        if (q >= K) {
          q -= K;
          ++e;
        }
      }
    }
    float d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      d[u] = w[u] < repro::inf_f() ? drow[off[u]] : repro::inf_f();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      repro::tile_min_into(tile, at[u], d[u] + w[u]);
  }
}

// dq: the interleaved rows [P, bp, K] (the rows themselves at K = 1). The
// CTA (shard p, slot tile i, group blockIdx.y) packs queries [q0, q0 + nq),
// nq = min(kg, K - q0). Its pair loop runs kg queries wide whatever nq
// (kernel parameters, so the loop holds no more registers than with one
// group); a last group's queries past K gather from the scratch's K words
// of padding into tile columns the finalizer never reads.
template <bool kRagged>
__global__ void __launch_bounds__(kPackThreads)
send_pack_kernel(const float* __restrict__ dq,
                 const float* __restrict__ last,
                 const int* __restrict__ valid,
                 const int* __restrict__ bounds,
                 const int* __restrict__ src_t,
                 const float* __restrict__ w_t,
                 const int* __restrict__ segrel_t,
                 const int* __restrict__ pruned_t, float* val, float* new_last,
                 int* sends, int K, int bp, int sp, int n_stiles, int n_rows,
                 int n_chunks, int eb, int sb, int kg, int kp, int nb) {
  extern __shared__ int4 smem4[];
  int4* staged = smem4;                    // [nb] src * K, segrel * kp, w
  int* tile = reinterpret_cast<int*>(smem4 + nb);       // [sb, kp] keys
  int* cnt = tile + sb * kp;               // [kg] improved slots
  int* n_staged = cnt + kg;                // live edges staged
  const int p = blockIdx.x / n_stiles;
  const int i = blockIdx.x % n_stiles;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int x = tid; x < sb * kp; x += kPackThreads) tile[x] = repro::kInfBits;
  for (int q = tid; q < kg; q += kPackThreads) cnt[q] = 0;

  // the tile's chunks [c0, c1) among the shard's n_rows chunks, as one
  // flat run of edges [e_begin, e_end)
  int c0 = i * n_chunks;
  int c1 = c0 + n_chunks;
  if (kRagged) {
    const int* b = bounds + static_cast<long long>(p) * (n_stiles + 1);
    c0 = b[i];
    c1 = b[i + 1];
  }
  const long long e_begin = (static_cast<long long>(p) * n_rows + c0) * eb;
  const long long e_end = e_begin + static_cast<long long>(c1 - c0) * eb;
  // the group's candidates: K * src + q0 + q of the shard's rows
  const float* drow =
      dq + static_cast<long long>(p) * bp * K + blockIdx.y * kg;
  for (long long b0 = e_begin; b0 < e_end; b0 += nb) {
    const int n = static_cast<int>(min(static_cast<long long>(nb),
                                       e_end - b0));
    if (tid == 0) *n_staged = 0;
    __syncthreads();
    // stage the batch's live edges (finite, unpruned), compacted: every
    // load first, then a ballot a warp and one shared atomicAdd for the
    // warp's place, so each warp's edges stay in layout order (sorted by
    // slot) and the warps' blocks land in any order (a min is order-free)
    int sv[kStage], r[kStage];
    float w[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int j = tid + u * kPackThreads;
      w[u] = repro::inf_f();
      sv[u] = 0;
      r[u] = 0;
      if (j < n) {
        const long long x = b0 + j;
        if (once(pruned_t + x) <= 0) w[u] = once(w_t + x);
        sv[u] = once(src_t + x);
        r[u] = once(segrel_t + x);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const bool ok = w[u] < repro::inf_f();
      const unsigned m = __ballot_sync(0xffffffffu, ok);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(n_staged, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (ok)
        staged[base + __popc(m & ((1u << lane) - 1u))] =
            make_int4(sv[u] * K, r[u] * kp, __float_as_int(w[u]), 0);
    }
    __syncthreads();
    if (kPackThreads % kg == 0)
      reduce_pairs<true>(staged, *n_staged, kg, drow, tile);
    else
      reduce_pairs<false>(staged, *n_staged, kg, drow, tile);
    __syncthreads();
  }
  __syncthreads();

  // finalize the group's nq queries: x = q * sb + slot, slot fastest,
  // (q, slot) stepped without a division (x - lane keeps the loop
  // warp-uniform for the count's ballot)
  const int q0 = blockIdx.y * kg;
  const int nq = min(kg, K - q0);
  const long long row0 = static_cast<long long>(p) * K + q0;   // (p, q0)
  int qf = tid / sb, sf = tid % sb;
  const int dqf = kPackThreads / sb, dsf = kPackThreads % sb;
  for (int x = tid; x - lane < nq * sb; x += kPackThreads) {
    const bool in = x < nq * sb;
    const int qx = in ? qf : 0;
    const int s = sf;
    sf += dsf;
    qf += dqf;
    if (sf >= sb) {
      sf -= sb;
      ++qf;
    }
    bool improved = false;
    if (in) {
      const int slot = i * sb + s;
      const long long o = (row0 + qx) * sp + slot;
      const float m = repro::key_value(tile[s * kp + qx]);
      const float before = once(last + o);
      improved =
          once(valid + static_cast<long long>(p) * sp + slot) > 0 && m < before;
      put_once(val + o, improved ? m : repro::inf_f());
      put_once(new_last + o, improved ? m : before);
    }
    // the lanes of one query add their improved slots once
    const unsigned same = __match_any_sync(0xffffffffu, qx);
    const unsigned imp = __ballot_sync(0xffffffffu, improved) & same;
    if (improved && lane == __ffs(imp) - 1) atomicAdd(cnt + qx, __popc(imp));
  }
  __syncthreads();
  for (int qc = tid; qc < nq; qc += kPackThreads)
    if (cnt[qc]) atomicAdd(sends + row0 + qc, cnt[qc]);
}

template <bool kRagged>
int launch(const float* dist, float* dist_qi, const float* last,
           const int* valid, const int* bounds, const int* src_t,
           const float* w_t, const int* segrel_t, const int* pruned_t,
           float* val, float* new_last, int* sends, int P, int K, int bp,
           int sp, int n_stiles, int n_rows, int n_chunks, int eb, int sb,
           cudaStream_t stream) {
  if (P * K * n_stiles == 0) return 0;
  PackShape sh;
  if (!pack_shape(K, sb, &sh) || (K > 1 && dist_qi == nullptr) ||
      static_cast<long long>(bp) * K > 0x7fffffffLL || sh.groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = repro::allow_smem(send_pack_kernel<kRagged>,
                                      static_cast<size_t>(sh.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* dq = dist;
  if (K > 1) {
    const dim3 grid((bp + kIlvV - 1) / kIlvV, (K + kIlvQ - 1) / kIlvQ, P);
    interleave_kernel<<<grid, kIlvThreads, 0, stream>>>(dist, dist_qi, K, bp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dq = dist_qi;
  }
  const dim3 grid(P * n_stiles, sh.groups);
  send_pack_kernel<kRagged><<<grid, kPackThreads,
                              static_cast<size_t>(sh.smem), stream>>>(
      dq, last, valid, bounds, src_t, w_t, segrel_t, pruned_t, val, new_last,
      sends, K, bp, sp, n_stiles, n_rows, n_chunks, eb, sb, sh.kg, sh.kp,
      sh.nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a pack CTA takes for K queries (its group's) and
// slot tiles of sb, or -1 when not even one query's tile of minima and one
// staged edge fit in the card's shared memory a block.
extern "C" int send_smem_bytes(int K, int sb) {
  PackShape sh;
  return pack_shape(K, sb, &sh) ? static_cast<int>(sh.smem) : -1;
}

// Dense layout [P, n_stiles, n_chunks, eb]. dist_qi: [P * bp * K + K]
// scratch for the interleaved rows and the padding a last query group's
// pair loop may read (null at K = 1).
extern "C" int send_pack_tiled(const float* dist, float* dist_qi,
                               const float* last, const int* valid,
                               const int* src_t, const float* w_t,
                               const int* segrel_t, const int* pruned_t,
                               float* val, float* new_last, int* sends, int P,
                               int K, int bp, int sp, int n_stiles,
                               int n_chunks, int eb, int sb,
                               cudaStream_t stream) {
  return launch<false>(dist, dist_qi, last, valid, nullptr, src_t, w_t,
                       segrel_t, pruned_t, val, new_last, sends, P, K, bp, sp,
                       n_stiles, n_stiles * n_chunks, n_chunks, eb, sb,
                       stream);
}

// Ragged layout [P, total_chunks, eb]; bounds [P, n_stiles + 1] are the
// tile -> chunk ranges of the chunk->tile map; dist_qi as above.
extern "C" int send_pack_ragged(const float* dist, float* dist_qi,
                                const float* last, const int* valid,
                                const int* bounds, const int* src_r,
                                const float* w_r, const int* segrel_r,
                                const int* pruned_r, float* val,
                                float* new_last, int* sends, int P, int K,
                                int bp, int sp, int n_stiles,
                                int total_chunks, int eb, int sb,
                                cudaStream_t stream) {
  return launch<true>(dist, dist_qi, last, valid, bounds, src_r, w_r,
                      segrel_r, pruned_r, val, new_last, sends, P, K, bp, sp,
                      n_stiles, total_chunks, 0, eb, sb, stream);
}
