// Flash attention forward in f32 on Hopper's tensor cores, in 3xTF32:
// kernel 12's f32 route. bf16 inputs take csrc/flash_attention_tc.cu; the
// Hopper primitives both share are in csrc/hopper.cuh.
//
// Replaces: kernels/flash_attention/flash_attention.py: flash_attention_p
// (the Pallas kernel _flash_kernel, grid (B, Hq, q tile, kv tile) with the kv
// axis innermost and the f32 accumulator, row max and row sum in VMEM
// scratch across kv steps; GQA through the k/v index maps, h // group).
//
// What it computes: q [B, Hq, Sq, D], k and v [B, Hkv, >= kv_len, D], out
// [B, Hq, Sq, D], all f32. Query row r of head h reads kv head h / group;
// key column kj is valid when kj < kv_len and, when causal,
// r + q_offset >= kj. The running max m, the running sum l and the
// accumulator are f32; each kv tile does the Pallas kernel's update with its
// guards: m' = max(m, rowmax(s)), p = exp(s - (m' finite ? m' : 0)) on valid
// columns else 0, alpha = m finite ? exp(m - m') : 0, l = l * alpha +
// rowsum(p), acc = acc * alpha + p v; out = acc / l where l > 0, else acc /
// 1, so a row with no valid key gives 0. Departures in rounding, not in the
// function: the scale times log2(e) is folded into the scores and the
// exponentials are exp2f, the kernel tiles kv by its own 32 columns, and the
// two products run in 3xTF32 (below).
//
// Precision: one TF32 product keeps 10 mantissa bits of each operand and
// misses the reference's 2e-5 by about two orders of magnitude. So every operand x is split into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest (cvt.rna, so
// nothing rests on how wgmma reads the low 13 bits of an f32), and a product
// a b is hi_a hi_b + hi_a lo_b + lo_a hi_b, summed by the tensor cores in
// f32; lo_a lo_b (2^-22 relative) is dropped. S = Q K^T and O += P V both
// run so; l is the f32 sum of the unsplit p. A CPU emulation of these
// products (tests/test_torch_flash_attention.py) stays within 2e-5 of the
// plain version at D 128 and 256 and one TF32 product does not; split = 0
// drops the lo products (1xTF32), a planted fault for the checks.
//
// What bounds it: operations. At gemma-7b's prefill shape in f32 (B 4,
// H 16, S 2048, D 256, causal) the function is 137.5 GFLOP: 2.05 ms on the
// f32 CUDA cores (67 TFLOP/s), 0.83 ms for the three TF32 products at the
// card's 495 TFLOP/s. The bytes (268 MB of q, k, v, out) take 0.16 ms.
//
// Design: the bf16 kernel's skeleton (TMA tensor maps over the caller's
// strides, a K/V ring on full and empty mbarriers, a producer warpgroup and
// consumer warpgroups of 64 query rows, q tiles launched last-first), with
// what tf32 wgmma asks for:
// - tf32 wgmma reads B from shared memory only K-major (the transpose bit is
//   for 16-bit types). K lands K-major from TMA and is split in place: K_hi
//   over the raw tile, K_lo in a plane beside it (elementwise, so the
//   swizzled layout carries over). V lands [keys][D] and is written by the
//   consumers into K-major V^T_hi and V^T_lo planes [D][32 keys], one
//   128-byte swizzled row per d; a warp's lanes are the 32 keys, so its
//   reads and writes meet no bank conflict.
// - A comes from registers. Q's fragments are read from its swizzled tile
//   (D <= 128: once, kept in registers; D = 256: at each k8 step) and split
//   there, so Q needs no lo plane. P's fragments are split straight from S's
//   accumulator. There a thread holds keys 2t and 2t + 1 of each group of 8,
//   where tf32's A fragment wants keys t and t + 4; so V^T stores each
//   group's keys in the order 0 2 4 6 1 3 5 7 and P's fragment takes the
//   accumulator as it is (the sum over keys does not care about order, as
//   long as P and V agree).
// - Per kv tile of 32: every consumer waits for the tile, the consumers
//   split K and V together (named barrier before and after; V's raw slot is
//   released at once, so its next tile loads under this one's products),
//   S = Q K^T by wgmma m64n32k8 (three per k8 step; four k8 steps a commit
//   group, one fence each, one group left in flight, so ptxas keeps the
//   products async without holding every step's fragments), K's slot
//   released, the online softmax in the accumulator layout (a row's max and
//   sum reduce over a quad of lanes), then O += P V by wgmma m64nNk8,
//   N = min(D, 64) columns at a time.
// - Tiles wholly above the causal diagonal or past kv_len are never loaded;
//   a consumer whose 64 rows see nothing of a tile splits but skips the
//   math. The k and v maps end at kv_len, so TMA zero-fills the padding
//   rows; the q map ends at Sq and rows past it are not written.
// Shared memory (Q + rings + K_lo + V^T hi, lo; K or V tile = 32 D floats):
//   D = 256: one consumer (64 rows), one stage: 64 + 32 + 32 + 32 + 64
//            = 224 KB, one CTA an SM;
//   D = 128: two consumers (128 rows), two stages: 64 + 64 + 64 + 16 + 32
//            = 176 KB (D = 64: 88 KB, 32: 44 KB, 16: 22 KB).
// The producer's barrier waits trap after about ten seconds; the consumers
// spin.
//
// What limits it (PERF.md): latency, not the tensor cores. At D = 256 one
// consumer warpgroup an SM runs the split, the fragment reads and splits of
// S, the softmax and the products one after the other, and the small
// products of S (N = 32) wait on their fragments; development builds with
// S's or P V's products removed ran no faster. Shared memory leaves no room
// for a second q tile or a second stage at D = 256; a development build in
// which two consumers shared the 64 rows and split the head dim (half of
// S's k8 steps and of O's columns each, the halves of S added through
// shared memory) spilled registers and ran slower.
#include "hopper.cuh"
#include "tile_reduce.cuh"

namespace {

using namespace repro;

constexpr int kWG = 128;          // threads per warpgroup
constexpr int kBK = 32;           // kv rows per tile: one 128-byte V^T row
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int NC = D == 256 ? 1 : 2;       // consumer warpgroups
  static constexpr int STAGES = D == 256 ? 1 : 2;   // the K and V rings
  static constexpr int THREADS = kWG * (NC + 1);
  static constexpr int BQ = 64 * NC;                // query rows per CTA
  static constexpr int W = D < 32 ? D : 32;         // floats per slab row
  static constexpr int ROW = 4 * W;                 // bytes per slab row
  static constexpr int SWZ = swizzle_code(ROW);
  static constexpr int STEPS = W / 8;               // k8 steps per slab
  static constexpr int PV_N = D < 64 ? D : 64;      // N of one P V product
  static constexpr bool Q_IN_REGS = D <= 128;
  static constexpr int SGROUP = 4;                  // k8 steps a commit group
  static constexpr int Q_WG = 64 * D * 4;           // one consumer's q rows
  static constexpr int KV = kBK * D * 4;            // a K or V tile, a plane
  static constexpr int OFF_K = NC * Q_WG;
  static constexpr int OFF_V = OFF_K + STAGES * KV;
  static constexpr int OFF_KLO = OFF_V + STAGES * KV;
  static constexpr int OFF_VHI = OFF_KLO + KV;
  static constexpr int OFF_VLO = OFF_VHI + KV;
  static constexpr int OFF_BAR = OFF_VLO + KV;
  static constexpr int SMEM = OFF_BAR + 128 + 1024;   // barriers, alignment
};

// The byte offset ``off`` (from a 1024-byte aligned base) as TMA's and
// wgmma's swizzle of rows of ROWB bytes places it.
template <int ROWB>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (ROWB / 16 - 1)) << 4);
}

// x = hi + lo: hi = tf32(x), lo = tf32(x - hi), both rounded to nearest.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The consumers' named barrier (the producer does not take part).
__device__ __forceinline__ void consumers_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n) : "memory");
}

// D (+)= A B, wgmma m64nNk8 in tf32 with an f32 accumulator of N / 2 floats
// a thread: A [64 x 8] from registers (4 a thread), B [8 x N] K-major from
// shared memory.
__device__ __forceinline__ void mma_n16(float* d, const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_n32(float* d, const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mma_n64(float* d, const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma(float* d, const uint32_t (&a)[4],
                                    uint64_t b) {
  if constexpr (N == 16) mma_n16(d, a, b);
  else if constexpr (N == 32) mma_n32(d, a, b);
  else mma_n64(d, a, b);
}

// The raw f32 A fragment of k8 step ks from a consumer's swizzled q tile:
// rows 16 warp + grp (+ 8), columns 8 ks + quad (+ 4), in the order a0 (row,
// col), a1 (row + 8, col), a2 (row, col + 4), a3 (row + 8, col + 4).
template <int D>
__device__ __forceinline__ void q_frag(const uint8_t* q, int ks, int warp,
                                       int grp, int quad, float (&f)[4]) {
  using T = Tile<D>;
  const int c = 8 * ks + quad;
  const uint32_t slab = (c / T::W) * (64 * T::ROW);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t off = slab + (16 * warp + grp + 8 * h) * T::ROW +
                           ((c + 4 * u) % T::W) * 4;
      f[h + 2 * u] = *reinterpret_cast<const float*>(q + swz<T::ROW>(off));
    }
}

// The consumers' split of one landed kv tile: K in place into K_hi, K_lo
// beside it; V [keys][D] into V^T_hi and V^T_lo [D][32 keys] with each group
// of 8 keys in the order 0 2 4 6 1 3 5 7. ct: this thread among the
// consumers' NC * 128.
template <int D>
__device__ __forceinline__ void split_tile(uint8_t* k, uint8_t* klo,
                                           const uint8_t* v, uint8_t* vhi,
                                           uint8_t* vlo, int ct) {
  using T = Tile<D>;
  constexpr int N = T::NC * kWG;
  float4* k4 = reinterpret_cast<float4*>(k);
  float4* l4 = reinterpret_cast<float4*>(klo);
  for (int i = ct; i < T::KV / 16; i += N) {
    const float4 x = k4[i];
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    k4[i] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                        __uint_as_float(h[2]), __uint_as_float(h[3]));
    l4[i] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                        __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
  // V: a warp's lanes are the 32 keys, a warp takes 4 columns d at a time
  const int key = ct % 32, warp = ct / 32;
  const int x7 = key & 7;
  const int p = (key & ~7) | (x7 >> 1) | ((x7 & 1) << 2);   // its V^T column
  for (int d = 4 * warp; d < D; d += 4 * (N / 32)) {
    const uint32_t off =
        (d / T::W) * (kBK * T::ROW) + key * T::ROW + (d % T::W) * 4;
    const float4 y = *reinterpret_cast<const float4*>(v + swz<T::ROW>(off));
    const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t hi, lo;
      split(ys[e], hi, lo);
      const uint32_t o = swz<128>((d + e) * 128 + 4 * p);
      *reinterpret_cast<uint32_t*>(vhi + o) = hi;
      *reinterpret_cast<uint32_t*>(vlo + o) = lo;
    }
  }
}

// NC = 1: launched as if two blocks shared an SM (128 registers a thread),
// so the producer's 24 and the consumer's 232 after setmaxnreg fit the
// block's registers; NC = 2: 168 at launch, 24 and 240 after.
template <int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, Tile<D>::NC == 1 ? 2 : 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  float* __restrict__ o, int group, int Sq, int causal,
                  int q_offset, int kv_len, float scale, long long o_sb,
                  long long o_sh, long long o_ss, int split_on) {
  using T = Tile<D>;
  constexpr int NC = T::NC, STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);     // the same, as a pointer
  const uint32_t sq = base, sk = base + T::OFF_K, sv = base + T::OFF_V;
  const uint32_t klo = base + T::OFF_KLO, vhi = base + T::OFF_VHI,
                 vlo = base + T::OFF_VLO;
  const uint32_t full_k = base + T::OFF_BAR;     // [STAGES] K landed
  const uint32_t full_v = full_k + 8 * STAGES;   // [STAGES] V landed
  const uint32_t empty_k = full_v + 8 * STAGES;  // [STAGES] S read K
  const uint32_t empty_v = empty_k + 8 * STAGES; // [STAGES] V split
  const uint32_t qbar = empty_v + 8 * STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  // the columns any row of this CTA may see, in tiles of kBK
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + T::BQ, Sq) + q_offset);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, NC * kWG);
      mbar_init(empty_v + 8 * s, NC * kWG);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {   // ---- the producer -------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      int n_live = 0;   // consumers with real rows
      while (n_live < NC && q0 + 64 * n_live < Sq) ++n_live;
      mbar_expect_tx(qbar, n_live * T::Q_WG);
      for (int g = 0; g < n_live; ++g)
        for (int s = 0; s < D / T::W; ++s)
          tma_load(sq + g * T::Q_WG + s * 64 * T::ROW, &tq, s * T::W,
                   q0 + 64 * g, h, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        const uint32_t par = ((j / STAGES) & 1) ^ 1;
        // V first: its slot frees as soon as the consumers have split it
        mbar_wait_or_trap(empty_v + 8 * st, par);
        mbar_expect_tx(full_v + 8 * st, T::KV);
        for (int s = 0; s < D / T::W; ++s)
          tma_load(sv + st * T::KV + s * kBK * T::ROW, &tv, s * T::W,
                   j * kBK, hk, b, full_v + 8 * st);
        mbar_wait_or_trap(empty_k + 8 * st, par);
        mbar_expect_tx(full_k + 8 * st, T::KV);
        for (int s = 0; s < D / T::W; ++s)
          tma_load(sk + st * T::KV + s * kBK * T::ROW, &tk, s * T::W,
                   j * kBK, hk, b, full_k + 8 * st);
      }
      // until the consumers release the last tiles: a consumer stuck on a
      // load that never lands makes this wait trap
      for (int j = max(n_tiles - STAGES, 0); j < n_tiles; ++j) {
        mbar_wait_or_trap(empty_v + 8 * (j % STAGES), (j / STAGES) & 1);
        mbar_wait_or_trap(empty_k + 8 * (j % STAGES), (j / STAGES) & 1);
      }
    }
    return;
  }

  // ---- a consumer: 64 query rows ------------------------------------------
  if constexpr (NC == 1) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  }
  const int g = wg - 1, t = threadIdx.x - wg * kWG, ct = threadIdx.x - kWG;
  const int warp = t / 32, lane = t % 32, quad = lane % 4, grp = lane / 4;
  const int first = q0 + 64 * g;
  const bool live = first < Sq;
  int end = kv_len;   // the columns this consumer's rows may see
  if (causal) end = min(end, min(first + 64, Sq) + q_offset);
  const int r0 = first + 16 * warp + grp;   // its rows: r0 and r0 + 8
  const float sc = scale * kLog2e;
  const uint8_t* qg = gbase + g * T::Q_WG;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float qr[T::Q_IN_REGS ? D / 8 : 1][4];
  if (live && n_tiles > 0) {
    mbar_wait(qbar, 0);
    if constexpr (T::Q_IN_REGS) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
        q_frag<D>(qg, ks, warp, grp, quad, qr[ks]);
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, j0 = j * kBK;
    const uint32_t par = (j / STAGES) & 1;
    const uint32_t kt = sk + st * T::KV;
    consumers_sync(NC * kWG);   // every consumer is done with the planes
    mbar_wait(full_k + 8 * st, par);
    mbar_wait(full_v + 8 * st, par);
    split_tile<D>(gbase + (kt - base), gbase + T::OFF_KLO,
                  gbase + T::OFF_V + st * T::KV, gbase + T::OFF_VHI,
                  gbase + T::OFF_VLO, ct);
    fence_proxy_async();
    mbar_arrive(empty_v + 8 * st);
    consumers_sync(NC * kWG);   // the split planes are complete
    const bool work = live && j0 < end;

    float s[kBK / 2];
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
    if (work) {
      // S = Q K^T, k8 steps in groups of kSteps: each group's fragments
      // are read and split, one fence, its products, one commit; at most
      // one older group stays in flight, so its fragments are free again
      // and ptxas need not serialize the products. A k8 step is 32 bytes
      // further in a slab, then the next slab; hi hi + hi lo + lo hi
      constexpr int kSteps = D / 8 < T::SGROUP ? D / 8 : T::SGROUP;
      pin(s);
#pragma unroll
      for (int k0 = 0; k0 < D / 8; k0 += kSteps) {
        uint32_t qh[kSteps][4], ql[kSteps][4];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          float f[4];
          if constexpr (T::Q_IN_REGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = qr[k0 + u][e];
          } else {
            q_frag<D>(qg, k0 + u, warp, grp, quad, f);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) split(f[e], qh[u][e], ql[u][e]);
        }
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int ks = k0 + u;
          const uint32_t koff =
              (ks / T::STEPS) * (kBK * T::ROW) + 32 * (ks % T::STEPS);
          const uint64_t kh = desc(kt + koff, 16, 8 * T::ROW, T::SWZ);
          mma_n32(s, qh[u], kh);
          if (split_on) {
            mma_n32(s, qh[u], desc(klo + koff, 16, 8 * T::ROW, T::SWZ));
            mma_n32(s, ql[u], kh);
          }
        }
        wgmma_commit();
        wgmma_wait_upto<1>();
      }
      wgmma_wait();
      pin(s);
    }
    mbar_arrive(empty_k + 8 * st);
    if (!work) continue;

    // the online softmax in the accumulator layout: s[i] is row
    // r0 + 8 * ((i >> 1) & 1), column j0 + 8 * (i >> 2) + 2 * quad + (i & 1)
    const bool mask = j0 + kBK > kv_len ||
                      (causal && j0 + kBK - 1 > first + q_offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      float x = s[i] * sc;
      if (mask) {
        const int kj = j0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        if (kj >= kv_len || (causal && r0 + 8 * r + q_offset < kj))
          x = -INFINITY;
      }
      s[i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
    float alpha[2], sub[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      sub[r] = finite(m_new) ? m_new : 0.f;
      alpha[r] = finite(m[r]) ? exp2f(m[r] - m_new) : 0.f;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = exp2f(s[i] - sub[r]);   // a masked column: exp2(-inf) = 0
      rs[r] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
    // P's A fragments of k8 step kk: a0, a1 = keys 8 kk + 2 quad of rows r0,
    // r0 + 8 (V^T column 8 kk + quad), a2, a3 = keys 8 kk + 2 quad + 1
    // (column 8 kk + quad + 4)
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      split(s[4 * kk], ph[kk][0], pl[kk][0]);
      split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
      split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
      split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V: N columns of O at a time; k8 step kk is 32 bytes into each
    // V^T row, N rows of V^T are N * 128 bytes
    pin(acc);
    pin(ph);
    pin(pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk)
#pragma unroll
      for (int c = 0; c < D / T::PV_N; ++c) {
        const uint32_t voff = c * T::PV_N * 128 + 32 * kk;
        float* a = acc + c * T::PV_N / 2;
        const uint64_t vh = desc(vhi + voff, 16, 1024, 1);
        mma<T::PV_N>(a, ph[kk], vh);
        if (split_on) {
          mma<T::PV_N>(a, ph[kk], desc(vlo + voff, 16, 1024, 1));
          mma<T::PV_N>(a, pl[kk], vh);
        }
      }
    wgmma_commit();
    wgmma_wait();
    pin(acc);
    pin(ph);
    pin(pl);
  }

  if (!live) return;
  float* ob = o + b * o_sb + h * o_sh + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float den = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<float2*>(ob + row * o_ss + 8 * jn) =
          make_float2(acc[4 * jn + 2 * r] / den, acc[4 * jn + 2 * r + 1] / den);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Hq, int Hkv, int Sq, int causal, int q_offset, int kv_len,
           float scale, const long long* st, int split_on,
           cudaStream_t stream) {
  using T = Tile<D>;
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap mq, mk, mv;
  const int kv_rows = kv_len > 0 ? kv_len : 1;   // never read when 0
  constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!encode(&mq, q, kF32, 4, D, Sq, Hq, B, st[2], st[1], st[0], T::W, 64) ||
      !encode(&mk, k, kF32, 4, D, kv_rows, Hkv, B, st[5], st[4], st[3], T::W,
              kBK) ||
      !encode(&mv, v, kF32, 4, D, kv_rows, Hkv, B, st[8], st[7], st[6], T::W,
              kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = repro::allow_smem(flash_tf32_kernel<D>, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + T::BQ - 1) / T::BQ, Hq, B);
  flash_tf32_kernel<D><<<grid, T::THREADS, T::SMEM, stream>>>(
      mq, mk, mv, o, Hq / Hkv, Sq, causal, q_offset, kv_len, scale, st[9],
      st[10], st[11], split_on);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, >= kv_len, D], out like q, all f32,
// each given by its batch, head and sequence strides in elements (the last
// axis contiguous; pointers and strides of 16 bytes, as TMA needs);
// D in {16, 32, 64, 128, 256}. split = 0 drops the lo products (1xTF32): a
// planted fault for the checks, never set by the wrapper.
extern "C" int flash_attention(
    const float* q, const float* k, const float* v, float* o, int B, int Hq,
    int Hkv, int Sq, int D, int causal, int q_offset, int kv_len,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, int split, cudaStream_t stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  switch (D) {
#define REPRO_FA_CASE(DD)                                                   \
  case DD:                                                                  \
    return launch<DD>(q, k, v, o, B, Hq, Hkv, Sq, causal, q_offset, kv_len, \
                      scale, st, split, stream);
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
#undef REPRO_FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
