// Shared pieces of the GroupNorm kernels (gn.cu) and the fused
// GroupNorm+SiLU+conv3x3 kernels (gn_conv.cu): SiLU and its derivative,
// the warp sum and the vector width.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "elem.cuh"

namespace gn {

constexpr int VEC = 8;         // values per vector load (16 bytes of bf16)

// through the fast exp and division, for K8 and K9 alike: a few fp32
// ulps from 1 / (1 + expf(-v)), and 0 where exp(-v) overflows, as there
__device__ __forceinline__ float sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
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

}  // namespace gn
