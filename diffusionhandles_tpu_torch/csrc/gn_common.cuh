// Shared pieces of the GroupNorm kernels (gn.cu) and the fused
// GroupNorm+SiLU+conv3x3 kernels (gn_conv.cu): the activation helpers and
// the statistics pass both use.
//
// Layout: NCHW, bf16. A (batch, channel) pair is one contiguous run of
// hw = H*W values, and the channels of group g of image b are the runs
// (b*G + g)*cg .. (b*G + g)*cg + cg - 1 (cg = C / G), one contiguous block.
//
// The statistics are two passes, both deterministic (no atomics):
//   channel_sums_kernel  one warp per (b, c) run: s1 = sum x, s2 = sum x^2
//   group_stats_kernel   one thread per (b, g): mean, rsig from the cg
//                        channel sums of the group, in channel order.
// The TPU kernels reduce a whole image in VMEM; no CTA holds an image
// here, so the per-channel partials take the place of the VMEM scratch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {

constexpr int STAT_WARPS = 8;  // (b, c) runs per block of channel_sums
constexpr int VEC = 8;         // bf16 values per 16-byte load

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

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

// 8 bf16 at p (16-byte aligned) as floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[VEC]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = __bfloat162float(h[j]);
}

// 8 floats rounded to bf16 into p (16-byte aligned)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&f)[VEC]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) h[j] = __float2bfloat16_rn(f[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Both statistics passes over x [b, c, hw] (gn.cu): mean and rsig [b*groups]
// fp32; sums is fp32 scratch of 2*b*c. `gn_recipe` selects the GroupNorm
// kernel's recipe (squares rounded to bf16, variance clamped at 0) over the
// fused conv kernel's (fp32 squares, no clamp).
cudaError_t launch_group_stats(const __nv_bfloat16* x, float* sums,
                               float* mean, float* rsig, int b, int c, int hw,
                               int groups, float eps, bool gn_recipe,
                               cudaStream_t stream);

}  // namespace gn
