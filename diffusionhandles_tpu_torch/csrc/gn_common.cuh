// Shared pieces of the GroupNorm kernels (gn.cu) and the fused
// GroupNorm+SiLU+conv3x3 kernels (gn_conv.cu): the activation helpers,
// the warp sum and the vector loads and stores of 8 values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace gn {

constexpr int VEC = 8;         // values per vector load (16 bytes of bf16)

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

__device__ __forceinline__ float silu(float v) { return v * sigmoid(v); }

// d silu(z) / dz
__device__ __forceinline__ float silu_grad(float v) {
  const float s = sigmoid(v);
  return s * (1.f + v * (1.f - s));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 8 values of T at p (aligned to their size) as floats
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&f)[VEC]) {
  elem::load<T, VEC>(p, f);
}

// 8 floats rounded to T into p (aligned to their size)
template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&f)[VEC]) {
  elem::store<T, VEC>(p, f);
}

}  // namespace gn
