// Flash attention forward for bf16 on Hopper's tensor cores: kernel 12's
// bf16 route.
//
// Replaces: kernels/flash_attention/flash_attention.py: flash_attention_p
// (the Pallas kernel _flash_kernel, grid (B, Hq, q tile, kv tile) with the kv
// axis innermost and the f32 accumulator, row max and row sum in VMEM
// scratch across kv steps; GQA through the k/v index maps, h // group).
// csrc/flash_attention.cu is the f32 route (3xTF32 on wgmma); the Hopper
// primitives both share are in csrc/hopper.cuh.
//
// What it computes: q [B, Hq, Sq, D], k and v [B, Hkv, >= kv_len, D], bf16,
// out [B, Hq, Sq, D] bf16. Query row r of head h reads kv head h / group;
// key column kj is valid when kj < kv_len and, when causal,
// r + q_offset >= kj. Scores, the running max m, the running sum l and the
// accumulator are f32; each kv tile does the Pallas kernel's update with its
// guards: m' = max(m, rowmax(s)), p = exp(s - (m' finite ? m' : 0)) on valid
// columns else 0, alpha = m finite ? exp(m - m') : 0,
// l = l * alpha + rowsum(p), acc = acc * alpha + p v; out = acc / l where
// l > 0, else acc / 1, so a row with no valid key gives 0. Two departures
// in rounding, not in the function: the scale times log2(e) is folded into
// the scores and the exponentials are exp2f (p moves by about 1e-6
// relative), and the kernel tiles kv by its own BK columns, so its f32 sums
// run in another order than the plain version's.
//
// What bounds it: operations. At gemma-7b's prefill (B 4, H 16, S 2048,
// D 256, causal) the function is 137.5 GFLOP against 268 MB of q, k, v and
// out: 0.139 ms at the card's bf16 tensor rate, 0.080 ms for the bytes.
//
// Precision, and why P goes through the tensor cores twice: q k^T takes
// bf16 operands, whose products are exact in f32, so bf16 wgmma with an f32
// accumulator differs from the f32 function only in the order of its sums.
// p is an f32 value in (0, 1]; rounded to bf16 alone before p v (what
// FlashAttention and SDPA do) it moves the output by hundreds of bf16 ulps
// (174 in a CPU emulation at gemma-smoke's heads, 323 on an H100 at gemma's
// shape), far outside the 2 ulps the port holds kernel 12 to. So p is split
// into P_hi = bf16(p) and P_lo = bf16(p - P_hi), and O += P_hi v + P_lo v,
// two bf16 products summed in f32 (one ulp from the f32 function in the
// emulation). That is 1.5x the products of plain bf16 FlashAttention; the
// bound above stays the function's. l is the f32 sum of the unrounded p.
//
// Design (FlashAttention-3's shape, without its intra-warpgroup ping-pong):
// one CTA of three warpgroups per (128 query rows, head, batch), q tiles
// launched last-first so the long causal rows start early.
// - Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24) and
//   one elected thread issues TMA loads: the CTA's q tile once, then K and V
//   tiles of BK rows (64 at D = 256, 128 below) into a ring of two stages,
//   each with a full mbarrier (TMA bytes landed) and an empty one (both
//   consumers are done with it).
// - Warpgroups 1 and 2 are consumers of 64 query rows each (setmaxnreg
//   240). Per kv tile: S = Q K^T by wgmma m64nBKk16 from shared memory; the
//   online softmax in registers in wgmma's accumulator layout (a row lives
//   in one quad of lanes: its max and sum reduce with two shuffles); P_hi and
//   P_lo packed straight from the accumulator layout into wgmma's register-A
//   fragments; O += P_hi V + P_lo V by wgmma m64nDk16 with V read from
//   shared memory in MN-major form (the transpose bit). O stays in
//   registers (D / 2 floats a thread) until the epilogue divides by l and
//   stores bf16 pairs through the caller's output strides; rows past Sq are
//   not written.
// - Tiles wholly above the causal diagonal or past kv_len are never loaded;
//   a consumer whose 64 rows see nothing of a loaded tile skips its math.
//   Only the tile on the diagonal and the one that straddles kv_len are
//   masked.
// - TMA: one 4-D tensor map (D, S, H, B) each for q, k and v over the
//   caller's strides, encoded on the host for every call (the driver's
//   cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
//   library needs no -lcuda) and passed as __grid_constant__ parameters. The
//   k and v maps end at kv_len, so TMA zero-fills the padding rows. Shared
//   tiles use the 128-byte swizzle (D >= 64; 64- and 32-byte at D = 32 and
//   16), whose rows are at most 64 bf16 wide: a D = 256 tile is four slabs
//   of 64 columns. The wgmma descriptors step 32 bytes per k16 slice inside
//   a slab and jump a slab at its end (Q K^T); for V, the leading offset is
//   the slab stride and each k16 slice is 16 rows down.
// Shared memory at D = 256: 64 KB of q + 2 stages x (32 + 32) KB of K and V
// = 192 KB (160 KB at D = 128). The producer's barrier waits trap after
// about ten seconds, and it waits for the consumers to release the last
// tiles, so a load or barrier that never completes traps instead of hanging
// the card; the consumers spin without a trap, which would cost them
// registers.
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "tile_reduce.cuh"

namespace {

using namespace repro;

constexpr int kWG = 128;            // threads per warpgroup
constexpr int kThreads = 3 * kWG;   // the producer and two consumers
constexpr int kBQ = 128;            // query rows per CTA, 64 per consumer
constexpr int kStages = 2;          // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int BK = D == 256 ? 64 : 128;     // kv rows per tile
  static constexpr int W = D < 64 ? D : 64;          // columns per slab
  static constexpr int ROW = 2 * W;                  // bytes per slab row
  static constexpr int SLABS = D / W;
  // wgmma's swizzle code for the slab rows: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int SWZ = swizzle_code(ROW);
  static constexpr int Q_WG = 64 * D * 2;            // one consumer's q rows
  static constexpr int KV = BK * D * 2;              // K or V, one stage
  static constexpr int OFF_K = 2 * Q_WG;
  static constexpr int OFF_V = OFF_K + kStages * KV;
  static constexpr int OFF_BAR = OFF_V + kStages * KV;
  static constexpr int SMEM = OFF_BAR + 64 + 1024;   // barriers, alignment
};

// S (+)= A B with A [64 x 16] and B [16 x N] both from shared memory, K-major
// (wgmma m64nNk16, f32 += bf16 x bf16); N = 64 or 128.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// O (+)= A B with A [64 x 16] bf16 from registers (wgmma's A-fragment
// layout) and B [16 x N] from shared memory in MN-major form (the transpose
// bit); N = D.
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// p (two f32 values of a row, in column order) split into bf16 pairs
// P_hi = bf16(p) and P_lo = bf16(p - P_hi), each packed as wgmma wants an
// A-fragment register: the lower column in the low half.
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = reinterpret_cast<const uint32_t&>(h);
  lo = reinterpret_cast<const uint32_t&>(r);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int group, int Sq, int causal,
                int q_offset, int kv_len, float scale, long long o_sb,
                long long o_sh, long long o_ss, int split_p) {
  using T = Tile<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sq = base, sk = base + T::OFF_K, sv = base + T::OFF_V;
  const uint32_t full = base + T::OFF_BAR;      // [kStages] TMA bytes landed
  const uint32_t empty = full + 8 * kStages;    // [kStages] consumers done
  const uint32_t qbar = empty + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  // the columns any row of this CTA may see, in tiles of BK
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + kBQ, Sq) + q_offset);
  const int n_tiles = kv_end > 0 ? (kv_end + BK - 1) / BK : 0;
  const int wg = threadIdx.x / kWG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * kWG);
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {   // ---- the producer -------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0 && n_tiles > 0) {
      const int n_live = q0 + 64 < Sq ? 2 : 1;   // consumers with real rows
      mbar_expect_tx(qbar, n_live * T::Q_WG);
      for (int g = 0; g < n_live; ++g)
        for (int s = 0; s < T::SLABS; ++s)
          tma_load(sq + g * T::Q_WG + s * 64 * T::ROW, &tq, s * T::W,
                   q0 + 64 * g, h, b, qbar);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait_or_trap(empty + 8 * st, ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * T::KV);
        for (int s = 0; s < T::SLABS; ++s) {
          const uint32_t off = st * T::KV + s * BK * T::ROW;
          tma_load(sk + off, &tk, s * T::W, j * BK, hk, b, full + 8 * st);
          tma_load(sv + off, &tv, s * T::W, j * BK, hk, b, full + 8 * st);
        }
      }
      // until the consumers release the last tiles: a consumer stuck on a
      // load that never lands makes this wait trap
      for (int j = max(n_tiles - kStages, 0); j < n_tiles; ++j)
        mbar_wait_or_trap(empty + 8 * (j % kStages), (j / kStages) & 1);
    }
    return;
  }

  // ---- a consumer: 64 query rows ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int g = wg - 1, t = threadIdx.x - wg * kWG;
  const int warp = t / 32, lane = t % 32, quad = lane % 4;
  const int first = q0 + 64 * g;
  const bool live = first < Sq;
  int end = kv_len;   // the columns this consumer's rows may see
  if (causal) end = min(end, min(first + 64, Sq) + q_offset);
  const int r0 = first + 16 * warp + lane / 4;   // its rows: r0 and r0 + 8
  const float sc = scale * kLog2e;
  const uint32_t qg = sq + g * T::Q_WG;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (live && n_tiles > 0) mbar_wait(qbar, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages, j0 = j * BK;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    if (live && j0 < end) {
      const uint32_t kt = sk + st * T::KV, vt = sv + st * T::KV;
      // S = Q K^T, one k16 slice at a time: 32 bytes further in a slab,
      // then the next slab
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      pin(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int slab = ks * 16 / T::W, col = ks * 16 % T::W;
        wgmma_ss(s,
                 desc(qg + slab * 64 * T::ROW + 2 * col, 16, 8 * T::ROW,
                      T::SWZ),
                 desc(kt + slab * BK * T::ROW + 2 * col, 16, 8 * T::ROW,
                      T::SWZ),
                 1);
      }
      wgmma_commit();
      wgmma_wait();
      pin(s);

      // the online softmax in the accumulator layout: s[i] is row
      // r0 + 8 * ((i >> 1) & 1), column j0 + 8 * (i >> 2) + 2 * quad + (i & 1)
      const bool mask = j0 + BK > kv_len ||
                        (causal && j0 + BK - 1 > first + q_offset);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
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
      for (int i = 0; i < BK / 2; ++i) {
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
      // P_hi and P_lo as A fragments: k16 slice kk holds the columns
      // 16 kk .. 16 kk + 15, that is s[8 kk .. 8 kk + 7]
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split_pair(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1], ph[kk][q],
                     pl[kk][q]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V; k16 slice kk of V is its rows 16 kk .. 16 kk +
      // 15, the slabs BK rows apart
      pin(acc);
      pin(ph);
      pin(pl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, ph[kk],
                 desc(vt + 16 * kk * T::ROW, BK * T::ROW, 8 * T::ROW, T::SWZ));
      if (split_p) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs(acc, pl[kk], desc(vt + 16 * kk * T::ROW, BK * T::ROW,
                                     8 * T::ROW, T::SWZ));
      }
      wgmma_commit();
      wgmma_wait();
      pin(acc);
      pin(ph);
      pin(pl);
    }
    mbar_arrive(empty + 8 * st);
  }

  if (!live) return;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh + 2 * quad;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    const float den = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<__nv_bfloat162*>(ob + row * o_ss + 8 * jn) =
          __floats2bfloat162_rn(acc[4 * jn + 2 * r] / den,
                                acc[4 * jn + 2 * r + 1] / den);
  }
}

// ---- host ------------------------------------------------------------------

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int causal, int q_offset, int kv_len,
           float scale, const long long* st, int split_p,
           cudaStream_t stream) {
  using T = Tile<D>;
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap mq, mk, mv;
  const int kv_rows = kv_len > 0 ? kv_len : 1;   // never read when 0
  constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode(&mq, q, kBf16, 2, D, Sq, Hq, B, st[2], st[1], st[0], T::W, 64) ||
      !encode(&mk, k, kBf16, 2, D, kv_rows, Hkv, B, st[5], st[4], st[3], T::W,
              T::BK) ||
      !encode(&mv, v, kBf16, 2, D, kv_rows, Hkv, B, st[8], st[7], st[6], T::W,
              T::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = repro::allow_smem(flash_tc_kernel<D>, T::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_tc_kernel<D><<<grid, kThreads, T::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Hq / Hkv, Sq, causal,
      q_offset, kv_len, scale, st[9], st[10], st[11], split_p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, >= kv_len, D], out like q, all bf16,
// each given by its batch, head and sequence strides in elements (the last
// axis contiguous; pointers and strides of 16 bytes, as TMA needs);
// D in {16, 32, 64, 128, 256}. split_p = 0 drops the P_lo products: a
// planted fault for the checks, never set by the wrapper.
extern "C" int flash_attention_tc(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int D, int causal, int q_offset, int kv_len,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, int split_p, cudaStream_t stream) {
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  switch (D) {
#define REPRO_FA_CASE(DD)                                                   \
  case DD:                                                                  \
    return launch<DD>(q, k, v, o, B, Hq, Hkv, Sq, causal, q_offset, kv_len, \
                      scale, st, split_p, stream);
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
