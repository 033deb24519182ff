// Flash attention forward in f32 on the CUDA cores: kernel 12's f32 route.
// bf16 inputs take csrc/flash_attention_tc.cu, on the tensor cores.
//
// Replaces: kernels/flash_attention/flash_attention.py: flash_attention_p
// (the Pallas kernel _flash_kernel, grid (B, Hq, q tile, kv tile) with the kv
// axis innermost and the f32 accumulator, row max and row sum in VMEM
// scratch across kv steps; GQA through the k/v index maps, h // group).
//
// What it computes: q [B, Hq, Sq, D], k and v [B, Hkv, >= kv_len, D], out
// [B, Hq, Sq, D], all f32. Query row r of head h reads kv head h / group;
// key column kj is valid when kj < kv_len and, when causal,
// r + q_offset >= kj. Scores, the running max m, the running sum l and the
// accumulator are f32; each kv tile does the Pallas kernel's update with its
// guards: m' = max(m, rowmax(s)), p = exp(s - (m' finite ? m' : 0)) on valid
// columns else 0, alpha = m finite ? exp(m - m') : 0, l = l * alpha +
// rowsum(p), acc = acc * alpha + p v. The output is acc / l where l > 0,
// else acc / 1, so a row with no valid key gives 0. The kernel tiles kv by
// its own 64 columns, not by the caller's block_k: the function is the same,
// and the sums are taken in another order (results agree to about 1e-6).
//
// What bounds it: operations, on the f32 CUDA cores (67 TFLOP/s at most).
// f32 stays off the tensor cores: TF32 keeps 10 mantissa bits and would miss
// the reference's f32 tolerance of 2e-5 by an order of magnitude. At
// gemma-7b's prefill shape in f32 (B 4, H 16, S 2048, D 256, causal) the
// function is 137.5 GFLOP, 2.05 ms at that rate.
//
// Design: one CTA of 256 threads per (q tile of 64 rows, head, batch); q
// tiles are launched last-first, so the long causal rows start early. The
// CTA keeps its q tile in shared memory and walks the kv tiles of 64
// columns in order, up to the last column any of its rows may see (tiles
// wholly above the causal diagonal or past kv_len are skipped: there they
// add exactly nothing). Per tile it stages K transposed ([D][64]) and V
// ([64][D]) in shared memory; thread (ty, tx) of the 16 x 16 grid owns the
// scores of rows ty + 16a (a < 4) and columns tx + 16c (c < 4), and the
// outputs of the same rows and columns tx + 16c (c < D / 16). A row's max
// and sum are reduced over the 16 lanes of a half warp with shuffles; the
// probabilities pass to the p v product through shared memory. Rows are
// padded by one float where a warp would read down a column. Shared memory:
// 29 KB at D = 16 to 214.5 KB at D = 256 (dynamic, above 48 KB by
// cudaFuncSetAttribute). The strides of q, k, v and out are the caller's
// (the last axis contiguous), so a [B, S, H, D] tensor seen as
// [B, H, S, D] is read in place.
#include <math.h>

#include "tile_reduce.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of threads
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // kv columns per tile
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;

// isfinite for the running max, which is -inf or finite
__device__ __forceinline__ bool finite(float x) { return fabsf(x) < INFINITY; }

struct Strides {   // element strides of the batch, head and sequence axes
  long long b, h, s;
};

template <int D>
constexpr size_t smem_floats() {
  return kBQ * (D + 1) + D * (kBK + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int group,
                 int Sq, int causal, int q_offset, int kv_len, float scale,
                 Strides sq, Strides sk, Strides sv, Strides so) {
  constexpr int kDC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // [kBQ][D + 1]
  float* Kt = Qs + kBQ * (D + 1);         // [D][kBK + 1]
  float* Vs = Kt + D * (kBK + 1);         // [kBK][D]
  float* Ps = Vs + kBK * D;               // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * (D + 1) + d] =
        q0 + r < Sq ? qb[(q0 + r) * sq.s + d] : 0.f;
  }
  // the columns any row of this tile may see
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(q0 + kBQ, Sq) + q_offset);

  float acc[kRows][kDC], m[kRows], l[kRows];
#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[a][c] = 0.f;
  }

  for (int j0 = 0; j0 < kv_end; j0 += kBK) {
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = j0 + r < kv_len;
      Kt[d * (kBK + 1) + r] = in ? kb[(j0 + r) * sk.s + d] : 0.f;
      Vs[r * D + d] = in ? vb[(j0 + r) * sv.s + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int a = 0; a < kRows; ++a) qv[a] = Qs[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Kt[d * (kBK + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kRows; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    float alpha[kRows];
#pragma unroll
    for (int a = 0; a < kRows; ++a) {
      const int qi = q0 + ty + 16 * a + q_offset;
      bool valid[kCols];
      float mt = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kj = j0 + tx + 16 * c;
        valid[c] = kj < kv_len && (!causal || qi >= kj);
        s[a][c] = valid[c] ? s[a][c] * scale : -INFINITY;
        mt = fmaxf(mt, s[a][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[a], mt);
      const float sub = finite(m_new) ? m_new : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = valid[c] ? expf(s[a][c] - sub) : 0.f;
        Ps[(ty + 16 * a) * (kBK + 1) + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      alpha[a] = finite(m[a]) ? expf(m[a] - m_new) : 0.f;
      l[a] = l[a] * alpha[a] + rs;
      m[a] = m_new;
    }
    __syncwarp();   // a row's probabilities come from its own half warp

#pragma unroll
    for (int a = 0; a < kRows; ++a)
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[a][c] *= alpha[a];
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int a = 0; a < kRows; ++a) pv[a] = Ps[(ty + 16 * a) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < kRows; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kRows; ++a) {
    const int r = q0 + ty + 16 * a;
    if (r >= Sq) continue;
    const float den = l[a] > 0.f ? l[a] : 1.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
      ob[r * so.s + tx + 16 * c] = acc[a][c] / den;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Hq, int Hkv, int Sq, int causal, int q_offset, int kv_len,
           float scale, Strides sq, Strides sk, Strides sv, Strides so,
           cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Hkv <= 0 || Hq % Hkv || Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_floats<D>() * sizeof(float);
  const cudaError_t e = repro::allow_smem(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, Hq / Hkv, Sq, causal, q_offset, kv_len, scale, sq, sk, sv,
      so);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Hq, Sq, D], k and v [B, Hkv, >= kv_len, D], out like q, all f32,
// each given by its batch, head and sequence strides in elements (the last
// axis contiguous); D in {16, 32, 64, 128, 256}.
extern "C" int flash_attention(
    const float* q, const float* k, const float* v, float* o, int B, int Hq,
    int Hkv, int Sq, int D, int causal, int q_offset, int kv_len,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, cudaStream_t stream) {
  const Strides sq{q_sb, q_sh, q_ss}, sk{k_sb, k_sh, k_ss},
      sv{v_sb, v_sh, v_ss}, so{o_sb, o_sh, o_ss};
  switch (D) {
#define REPRO_FA_CASE(DD)                                                  \
  case DD:                                                                 \
    return launch<DD>(q, k, v, o, B, Hq, Hkv, Sq, causal, q_offset,        \
                      kv_len, scale, sq, sk, sv, so, stream);
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
