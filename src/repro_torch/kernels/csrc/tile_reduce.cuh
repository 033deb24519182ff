// Shared device primitive of the relax, send and merge kernels.
//
// Replaces the reference's one-hot min-reduce (kernels/tile_reduce.py:
// tile_min / tile_min_batch), which turns a chunk of [EB] candidates, each
// tagged with a tile-relative target, into per-target minima. On Hopper the
// same move is an atomicMin into a tile held in shared memory, with the
// float reinterpreted as an int. That reinterpretation preserves order
// only because every value reduced here is >= 0 or +inf: build_shards
// rejects negative and NaN weights, distances start at 0 or +inf, and all
// padding is +inf. (For such floats the IEEE bit pattern, read as a signed
// int, is monotone in the value.)
//
// Each kernel source is built into its own shared library with a plain C
// interface (loaded with ctypes), so the one host helper defined here is
// compiled once per library.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr int kInfBits = 0x7f800000;   // +inf as an int
constexpr int kThreads = 512;          // threads per block in every kernel

__device__ __forceinline__ float inf_f() { return __int_as_float(kInfBits); }

// tile[rel] = min(tile[rel], cand) on an int-reinterpreted shared-memory
// tile. +inf candidates are skipped: min with +inf is the identity.
__device__ __forceinline__ void tile_min_into(int* tile, int rel, float cand) {
  if (cand < inf_f()) atomicMin(tile + rel, __float_as_int(cand));
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
