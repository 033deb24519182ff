// Fixed-length embedding bag: sum or mean of the table rows that each bag
// names.
//
// Replaces: kernels/embedding_bag/embedding_bag.py: embedding_bag_p (the
// Pallas kernel _embag_kernel, grid (B / bb,), the table in HBM and one row
// DMA per index).
//
// What it computes: out[b] = sum over l = 0..L-1 of table[idx[b, l]] for
// the valid indices (-V <= idx < V, an index below 0 wrapping to row
// V + idx as in the reference; V, the padding sentinel, and any other index
// outside [-V, V) is skipped and not counted), added in l order in float32,
// the mean dividing by max(count, 1); cast once to the table's type (f32 or
// bf16, round to nearest even). The same adds in the same order as the
// Pallas kernel's unrolled loop, so the result is bit-equal to the plain
// version, which keeps that order.
//
// What bounds it: bytes. Each valid index gathers one row (64 B at D = 16
// in f32), a random read from a table far larger than L2; the indices and
// the output are streamed once. There is one add per row element.
//
// Design: a group of G threads per bag, each lane owning 16-byte vectors of
// the row (4 f32 or 8 bf16) where the row width and the pointers allow it,
// else single elements; G is the row's vector count rounded up to a power
// of two, at most 32, so narrow rows pack several bags into a warp (D = 16
// f32: 4 lanes, 8 bags a warp). Every lane walks its bag's L indices in
// order (the group reads each index at one address), accumulates in
// registers and writes its vectors once. No shared memory, no atomics.
#include <cuda_bf16.h>

#include "tile_reduce.cuh"

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__global__ void __launch_bounds__(kBlock)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     T* __restrict__ out, int B, int L, int V, int D,
                     int group, int mean) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long bag = g / group;
  const int lane = static_cast<int>(g % group);
  if (bag >= B) return;
  const int* ix = idx + bag * L;
  const int nv = D / kVec;
  for (int v = lane; v < nv; v += group) {
    float acc[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc[k] = 0.f;
    float cnt = 0.f;
    for (int l = 0; l < L; ++l) {
      const int i = ix[l];
      const bool valid = i >= -V && i < V;
      Pack<T, kVec> p = {};
      if (valid)
        p = *reinterpret_cast<const Pack<T, kVec>*>(
            table + static_cast<long long>(i < 0 ? i + V : i) * D + v * kVec);
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        acc[k] = acc[k] + (valid ? to_f32(p.v[k]) : 0.f);
      cnt = cnt + (valid ? 1.f : 0.f);
    }
    const float c = fmaxf(cnt, 1.f);
    Pack<T, kVec> o;
#pragma unroll
    for (int k = 0; k < kVec; ++k) o.v[k] = from_f32<T>(mean ? acc[k] / c : acc[k]);
    *reinterpret_cast<Pack<T, kVec>*>(out + bag * D + v * kVec) = o;
  }
}

template <typename T>
int launch(const void* table, const int* idx, void* out, int B, int L, int V,
           int D, int vec, int mean, cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  if (vec != 1 && vec != kWide) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || D == 0) return 0;
  const int nv = D / vec;
  int group = 1;
  while (group < nv && group < 32) group *= 2;
  const long long n_blocks = (static_cast<long long>(B) * group + kBlock - 1) / kBlock;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 blocks(static_cast<unsigned>(n_blocks));
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (vec == kWide)
    embedding_bag_kernel<T, kWide><<<blocks, kBlock, 0, stream>>>(
        t, idx, o, B, L, V, D, group, mean);
  else
    embedding_bag_kernel<T, 1><<<blocks, kBlock, 0, stream>>>(
        t, idx, o, B, L, V, D, group, mean);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table [V, D] (f32, or bf16 when bf16 != 0), idx [B, L] int32, out [B, D]
// in the table's type; vec = elements per lane load: 1, or 16 bytes' worth
// when D * itemsize and both pointers are 16-byte aligned.
extern "C" int embedding_bag(const void* table, const int* idx, void* out,
                             int B, int L, int V, int D, int bf16, int vec,
                             int mean, cudaStream_t stream) {
  if (bf16)
    return launch<__nv_bfloat16>(table, idx, out, B, L, V, D, vec, mean, stream);
  return launch<float>(table, idx, out, B, L, V, D, vec, mean, stream);
}
