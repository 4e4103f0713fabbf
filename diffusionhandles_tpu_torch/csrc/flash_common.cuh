// Shared pieces of the flash-attention kernels: tile sizes, the bf16
// mma.sync wrapper and fragment packing.
//
// Fragment layout of mma.sync.m16n8k16 (bf16 in, fp32 accumulate), with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = (g, 2t..2t+1)    a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..2t+9)  a3 = (g+8, 2t+8..2t+9)
//   B (16x8, k x n):      b0 = (k 2t..2t+1, n g) b1 = (k 2t+8..2t+9, n g)
//   C (16x8, fp32):       c0,c1 = (g, 2t..2t+1)  c2,c3 = (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
// The accumulator of one product therefore has the register layout of the
// A operand of the next one (FlashAttention-2's P reuse).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int D = 64;          // head dim (the U-Net's, at every level)
constexpr int BM = 64;         // rows of the tile a CTA owns (4 warps x 16)
constexpr int BN = 64;         // rows of the tile streamed per iteration
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = D + 8;     // smem row stride in bf16 (144 B, breaks bank
                               // aliasing of the 128 B rows)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 values into one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// a register holding the two adjacent bf16 at smem[row][col], col even
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* s, int row,
                                            int col) {
  return *reinterpret_cast<const uint32_t*>(s + row * LDS + col);
}

// a register holding smem[row][col] and smem[row + 1][col] (a B operand
// whose k runs down the rows)
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* s,
                                                int row, int col) {
  return pack_bf16(s[row * LDS + col], s[(row + 1) * LDS + col]);
}

// Copy rows [row0, row0 + BN) of a [seq, D] bf16 matrix into smem, 16
// bytes per thread per step; rows at or past `seq` are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, int row0,
                                          int seq) {
  constexpr int CHUNKS = BN * D / 8;  // 16-byte chunks in the tile
  for (int c = threadIdx.x; c < CHUNKS; c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < seq)
      val = *reinterpret_cast<const uint4*>(g + (size_t)(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(s + r * LDS + col) = val;
  }
}

// The A fragments of a warp's 16 rows x D of a smem tile: 4 k-steps.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16* s, int row,
                                             int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld_pair(s, row + g, kk * 16 + 2 * t);
    a[kk][1] = ld_pair(s, row + g + 8, kk * 16 + 2 * t);
    a[kk][2] = ld_pair(s, row + g, kk * 16 + 2 * t + 8);
    a[kk][3] = ld_pair(s, row + g + 8, kk * 16 + 2 * t + 8);
  }
}

// acc[16 x BN] += A[16 x D] . S[BN x D]^T  (S is a smem tile, rows = n)
__device__ __forceinline__ void mma_abt(float (&acc)[BN / 8][4],
                                        const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* s, int g,
                                        int t) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_bf16(acc[nt], a[kk], ld_pair(s, nt * 8 + g, kk * 16 + 2 * t),
               ld_pair(s, nt * 8 + g, kk * 16 + 2 * t + 8));
    }
  }
}

// acc[16 x D] += P[16 x BN] . S[BN x D]  (P in accumulator layout, rounded
// to bf16 here; S is a smem tile, rows = k)
__device__ __forceinline__ void mma_pv(float (&acc)[D / 8][4],
                                       const float (&p)[BN / 8][4],
                                       const __nv_bfloat16* s, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_f32(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_f32(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      mma_bf16(acc[nt], a, ld_col_pair(s, kk * 16 + 2 * t, nt * 8 + g),
               ld_col_pair(s, kk * 16 + 2 * t + 8, nt * 8 + g));
    }
  }
}

// Store a warp's 16 x D fp32 accumulator, times `scale`, as bf16 rows of
// a [seq, D] matrix (rows at or past `seq` are dropped).
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[D / 8][4],
                                           int row, int seq, float scale0,
                                           float scale1, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (row + g < seq)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row + g) * D + col) =
          pack_f32(acc[nt][0] * scale0, acc[nt][1] * scale0);
    if (row + g + 8 < seq)
      *reinterpret_cast<uint32_t*>(out + (size_t)(row + g + 8) * D + col) =
          pack_f32(acc[nt][2] * scale1, acc[nt][3] * scale1);
  }
}

}  // namespace flash
