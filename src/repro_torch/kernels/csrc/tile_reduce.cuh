// Shared device primitive of the relax, send, merge and round kernels.
//
// Replaces the reference's one-hot min-reduce (kernels/tile_reduce.py:
// tile_min / tile_min_batch), which turns a chunk of [EB] candidates, each
// tagged with a tile-relative target, into per-target minima. On Hopper the
// same move is an atomicMin into a tile of ints held in shared memory, each
// int the order-preserving key of a float (min_key): flipping the 31 low
// bits of a negative float's pattern makes signed-int order equal float
// order for every non-NaN float, and leaves values >= 0 (all the solver
// path ever reduces: build_shards rejects negative and NaN weights) as
// their plain bit patterns. key_value inverts it. So the standalone relax
// kernels take the caller's floats, negative ones included; a NaN candidate
// is skipped, like +inf (the plain versions would return NaN: no NaN is
// part of any kernel's contract). -0.0 orders below +0.0.
//
// Each kernel source is built into its own shared library with a plain C
// interface (loaded with ctypes), so the one host helper defined here is
// compiled once per library.
#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

namespace repro {

constexpr int kInfBits = 0x7f800000;   // +inf as an int (and as a key)

__device__ __forceinline__ float inf_f() { return __int_as_float(kInfBits); }

// The order-preserving int key of a non-NaN float, and its inverse (the
// same involution).
__device__ __forceinline__ int min_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// tile[rel] = min(tile[rel], cand) on a shared-memory tile of keys. +inf
// candidates are skipped: min with +inf is the identity.
__device__ __forceinline__ void tile_min_into(int* tile, int rel, float cand) {
  if (cand < inf_f()) atomicMin(tile + rel, min_key(cand));
}

// Allow more than 48 KB of dynamic shared memory where a launch needs it,
// on the calling thread's current card (the launch's: the Python layer sets
// it to the operands' card). The attribute is per card and per kernel; each
// (card, kernel) keeps the largest size set so far, under a lock, so that a
// launch never lowers what another launch on that card, perhaps from
// another host thread, still needs, and cudaFuncSetAttribute runs only when
// the size grows.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> allowed;
  const std::lock_guard<std::mutex> lock(mu);
  size_t& have = allowed[{dev, reinterpret_cast<const void*>(kernel)}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return err;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
