// What the flash-attention forward (flash_fwd.cu) and backward
// (flash_bwd.cu) share: the head dim, the layout of their [B, S, H, 64]
// operands as tensor maps, the fast exp2 and the swizzled epilogue store.
//
// Every operand tile is a box of one 4-D tensor map over (D, H, S, B), the
// dims of a [B, S, H, D] tensor innermost first, with D unit-stride: a box
// of (64, 1, rows, 1) is `rows` rows of one head, 128 bytes each, which TMA
// writes to shared memory in the 128-byte swizzle that wgmma reads. Rows
// past S are TMA's zero fill on loads and clipped on stores. So q, k, v, o
// and dO are read where they lie (views of the U-Net's projections, or
// slices of one [B, S, 3, H, D] tensor), with no head-major copy.
#pragma once

#include <math.h>

#include <cstdint>

#include "hopper.cuh"

namespace flash {

using namespace hopper;

constexpr int D = 64;      // head dim (the U-Net's, at every level)
constexpr int ROW = D * 2;  // bytes of one row: the 128B swizzle's span
// 1/sqrt(64), exact in binary: T(q / 8) . k and (q . k) / 8 are the same
// fp32 number away from underflow, so the kernels apply it to the fp32
// logits instead of to a pre-scaled copy of q (the JAX wrappers' prescale).
constexpr float SCALE = 0.125f;
constexpr float LOG2E = 1.4426950408889634f;

// Errors the entries report besides cudaError_t values.
constexpr int ERR_NO_ENCODE = 1001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 1002;     // a tensor map was refused
constexpr int ERR_PLAN = 1003;       // a tile this file has no kernel for

// A [B, S, H, 64] operand of a 16-bit type (bf16 or fp16): its base and its
// strides in elements (D's is 1). The wrapper makes the base and strides
// multiples of 16 bytes.
struct Bshd {
  const void* ptr;
  long long sb, ss, sh;
};

// The tensor map of `t` (b x s x h rows of 64 T) with boxes of `rows` rows
// of one head, 128-byte swizzled.
template <typename T>
bool encode_bshd(CUtensorMap* map, const Bshd& t, int b, int s, int h,
                        int rows) {
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(h), cuuint64_t(s),
                              cuuint64_t(b)};
  const cuuint64_t strides[3] = {cuuint64_t(t.sh) * 2, cuuint64_t(t.ss) * 2,
                                 cuuint64_t(t.sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(D), 1, cuuint32_t(rows), 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode_fn()(map, tma_type<T>(), 4,
                     const_cast<void*>(t.ptr), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Write a warpgroup's m64n64 fp32 accumulator, times `scale0` (its rows
// l / 4) and `scale1` (rows l / 4 + 8), as T into the 64-row tile at
// `tile` (1024-byte aligned) in the 128B swizzle of the store's tensor map:
// 16-byte chunk c of row r sits at chunk c ^ (r % 8).
template <typename T>
__device__ __forceinline__ void stage_rows(uint8_t* tile, const float (&d)[32],
                                           float scale0, float scale1) {
  const int t = threadIdx.x % 128;
  const int r0 = t / 32 * 16 + t % 32 / 4;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = r0 + 8 * (i % 4 / 2);
    const int c = 8 * (i / 4) + 2 * (t % 4);
    const float s = i % 4 < 2 ? scale0 : scale1;
    *reinterpret_cast<uint32_t*>(tile + r * ROW + ((c / 8) ^ (r % 8)) * 16 +
                                 (c % 8) * 2) =
        pack<T>(d[i] * s, d[i + 1] * s);
  }
}

// Hand a warpgroup's staged tile to TMA: make the generic-proxy writes
// visible to the async proxy, gather the warpgroup (named barrier `bar`),
// and let its first thread store it at row `row0` of head h, batch b.
__device__ __forceinline__ void store_tile(const CUtensorMap* map,
                                           const uint8_t* tile, int bar,
                                           int h, int row0, int b) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(bar, 128);
  if (threadIdx.x % 128 == 0) tma_store_4d(map, tile, 0, h, row0, b);
}

}  // namespace flash
