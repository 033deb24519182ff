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
// Design: one CTA of 128 threads per (shard, vertex tile), a grid of
// P*n_vtiles, with no dependency between tiles. The CTA seeds a [K, VB]
// shared-memory tile with the current distances and min-reduces each finite
// message into it (tile_min_into). A launch lasts about as long as one CTA,
// so a CTA is built for memory-level parallelism: its threads take the
// tile's chunks as one flat run of message quads (at EB 512 a chunk is one
// quad a thread), each thread reads its quad's (valid, pos, dstrel) 16 bytes
// a plane (pos and dstrel only when a message of the quad is valid) and
// issues the gathers of its 4 messages for 8 queries, 32 loads, before it
// reduces any (K is taken 8 queries at a time). 128 threads a CTA and 8
// queries at a time: 256 threads and 16 queries ran the ragged merge slower
// than the kernel of one gather at a time before it (PERF.md).
// Finite-message counts stay in registers until the quads are done, are
// summed once a warp (one shared atomicAdd per warp and query), and reach
// the [P, K] output with one atomicAdd per (CTA, query); recvs is zeroed by
// a memset on the launch's stream. The finalizer (new row, frontier plane)
// runs in the same CTA. One template serves both layouts; kRagged picks how
// a tile finds its chunks. A min is order-free and the counts are exact, so
// out, front and recvs do not depend on the order.
//
// Query groups: the [Kg, VB] tile takes Kg * (VB + 1) * 4 bytes of shared
// memory. All K queries form one group while their tile lets an SM hold
// kShare = 8 CTAs (K up to 56 at VB 128, 28 at VB 256: K = 16 is one
// group); past that, the launch is a grid of P * n_vtiles by G groups, G
// the fewest whose tiles do and Kg = ceil(K / G), each CTA merging the
// queries [q0, q0 + Kg) of group blockIdx.y, so recvs[p, q] is added to
// only by its own group's CTAs. A CTA is latency-bound (its gathers in
// flight), so the CTAs an SM holds, not the fewest groups, set its speed:
// the fewest groups that fit a block (one CTA an SM) ran several times
// slower at K = 450 and 1,000 on an H100 than kShare 6 or 8
// (chip_smoke.py times K = 450, 512 and 1,000). Each group re-reads the
// layout; every output is per query, so the split is exact. Only a tile too wide
// for one query (VB past 58,110) has no shape (merge_smem_bytes returns
// -1; the wrapper raises before any launch).
#include <stdint.h>

#include <algorithm>

#include "tile_reduce.cuh"

namespace {

constexpr int kMergeThreads = 128;
constexpr int kG = 8;    // queries whose gathers a thread issues together
constexpr long long kSmemLimit = 232448;   // dynamic shared memory a block
constexpr int kShare = 8;                  // CTAs a group's tile lets an SM hold

// Queries a CTA merges for K queries and tiles of vb: all K while their
// tile fits kShare to an SM, else the even share of the fewest groups whose
// tiles do (one query a group at the least); 0 when not one query's tile
// fits a block.
inline int group_queries(int K, int vb) {
  const long long row = (vb + 1LL) * sizeof(int);
  if (K < 1 || kSmemLimit < row) return 0;
  const long long fit = std::max(1LL, kSmemLimit / kShare / row);
  const long long groups = (K + fit - 1) / fit;
  return static_cast<int>((K + groups - 1) / groups);
}

template <bool kRagged>
__global__ void __launch_bounds__(kMergeThreads)
merge_scatter_kernel(const float* __restrict__ dist,
                     const float* __restrict__ incoming,
                     const int* __restrict__ bounds,
                     const int* __restrict__ pos_t,
                     const int* __restrict__ dstrel_t,
                     const int* __restrict__ valid_t, float* out, float* front,
                     int* recvs, int K, int bp, int m, int n_vtiles, int n_rows,
                     int n_chunks, int eb, int vb, int kg, int vec) {
  extern __shared__ int smem[];
  int* tile = smem;                        // [nq, vb] minima as keys (min_key)
  int* cnt = smem + kg * vb;               // [nq] finite messages seen
  const int p = blockIdx.x / n_vtiles;
  const int i = blockIdx.x % n_vtiles;
  const int qb = blockIdx.y * kg;          // the group's queries [qb, qb + nq)
  const int nq = min(kg, K - qb);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long row0 = static_cast<long long>(p) * K + qb;
  for (int x = tid; x < nq * vb; x += nt) {
    const int q = x / vb;
    tile[x] = repro::min_key(dist[(row0 + q) * bp + i * vb + x % vb]);
  }
  for (int q = tid; q < nq; q += nt) cnt[q] = 0;
  __syncthreads();

  // the tile's chunks [c0, c1) among the shard's n_rows chunks
  int c0 = i * n_chunks;
  int c1 = c0 + n_chunks;
  if (kRagged) {
    const int* b = bounds + static_cast<long long>(p) * (n_vtiles + 1);
    c0 = b[i];
    c1 = b[i + 1];
  }
  const float* in = incoming + row0 * m;
  const long long lay = static_cast<long long>(p) * n_rows * eb;
  const int quads = (eb + 3) / 4;          // message quads a chunk
  const int n_quads = (c1 - c0) * quads;
  for (int q0 = 0; q0 < nq; q0 += kG) {
    int seen[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) seen[g] = 0;
    for (int x = tid; x < n_quads; x += nt) {
      const int e = 4 * (x % quads);
      const long long at =
          lay + static_cast<long long>(c0 + x / quads) * eb + e;
      int ok[4], ps[4] = {0, 0, 0, 0}, r[4] = {0, 0, 0, 0};
      if (vec) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(valid_t + at));
        ok[0] = a.x; ok[1] = a.y; ok[2] = a.z; ok[3] = a.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ok[u] = e + u < eb ? __ldg(valid_t + at + u) : 0;
      }
      if (!(ok[0] > 0 || ok[1] > 0 || ok[2] > 0 || ok[3] > 0)) continue;
      if (vec) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(pos_t + at));
        const int4 d = __ldg(reinterpret_cast<const int4*>(dstrel_t + at));
        ps[0] = a.x; ps[1] = a.y; ps[2] = a.z; ps[3] = a.w;
        r[0] = d.x; r[1] = d.y; r[2] = d.z; r[3] = d.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (ok[u] > 0) {
            ps[u] = __ldg(pos_t + at + u);
            r[u] = __ldg(dstrel_t + at + u);
          }
      }
      // every gather of the quad, then every reduce
      float v[4][kG];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          v[u][g] = ok[u] > 0 && q0 + g < nq
                        ? __ldg(in + static_cast<long long>(q0 + g) * m + ps[u])
                        : repro::inf_f();
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (v[u][g] < repro::inf_f()) {
            ++seen[g];
            atomicMin(tile + (q0 + g) * vb + r[u], repro::min_key(v[u][g]));
          }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const int s = __reduce_add_sync(0xffffffffu, seen[g]);
      if ((tid & 31) == 0 && s) atomicAdd(cnt + q0 + g, s);
    }
  }
  __syncthreads();

  for (int x = tid; x < nq * vb; x += nt) {
    const int q = x / vb;
    const long long o = (row0 + q) * bp + i * vb + x % vb;
    const float nv = repro::key_value(tile[x]);
    out[o] = nv;
    front[o] = nv < dist[o] ? 1.f : 0.f;
  }
  for (int q = tid; q < nq; q += nt)
    if (cnt[q]) atomicAdd(recvs + row0 + q, cnt[q]);
}

template <bool kRagged>
int launch(const float* dist, const float* incoming, const int* bounds,
           const int* pos_t, const int* dstrel_t, const int* valid_t,
           float* out, float* front, int* recvs, int P, int K, int bp, int m,
           int n_vtiles, int n_rows, int n_chunks, int eb, int vb,
           cudaStream_t stream) {
  if (P * K == 0) return 0;
  cudaError_t err = cudaMemsetAsync(recvs, 0, sizeof(int) * P * K, stream);
  if (err != cudaSuccess || n_vtiles == 0) return static_cast<int>(err);
  const int kg = group_queries(K, vb);
  if (kg == 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(P * n_vtiles, (K + kg - 1) / kg);
  const size_t smem = static_cast<size_t>(kg) * (vb + 1) * sizeof(int);
  err = repro::allow_smem(merge_scatter_kernel<kRagged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // quads read 16 bytes a plane when every quad is 16-byte aligned
  const uintptr_t planes = reinterpret_cast<uintptr_t>(pos_t) |
                           reinterpret_cast<uintptr_t>(dstrel_t) |
                           reinterpret_cast<uintptr_t>(valid_t);
  const int vec = eb % 4 == 0 && planes % 16 == 0;
  merge_scatter_kernel<kRagged><<<grid, kMergeThreads, smem, stream>>>(
      dist, incoming, bounds, pos_t, dstrel_t, valid_t, out, front, recvs, K,
      bp, m, n_vtiles, n_rows, n_chunks, eb, vb, kg, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of shared memory a merge CTA takes for K queries (its group's) and
// tiles of vb, or -1 when not even one query's tile fits a block.
extern "C" int merge_smem_bytes(int K, int vb) {
  const int kg = group_queries(K, vb);
  return kg ? static_cast<int>(kg * (vb + 1LL) * sizeof(int)) : -1;
}

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
