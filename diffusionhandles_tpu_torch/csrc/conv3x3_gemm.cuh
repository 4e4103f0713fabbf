// The implicit-GEMM mainloop of a 3x3 SAME stride-1 conv over NCHW bf16
// activations and PyTorch's [Co, Ci, 3, 3] bf16 weight, used by the fused
// GroupNorm+SiLU+conv kernels (gn_conv.cu) alone. The plain conv (conv.cu)
// no longer includes it: that kernel is a TMA-fed wgmma GEMM over
// channels-last activations, the design this mainloop is to move onto.
//   M = H*W output pixels, N = output channels, K = 9 * channels along K,
//   ordered (channel, tap) with the tap fastest: PyTorch's own weight order,
//   so the forward reads w as the [Co, 9*Ci] matrix it already is, and the
//   input gradient reads the flipped, transposed kernel straight from w
//   (B[(co, tap)][ci] = w[co][ci][8 - tap]).
// A CTA owns a 64-pixel x 64-channel output tile; its 4 warps each hold a
// 32 x 32 quarter in mma.sync m16n8k16 accumulators (bf16 in, fp32 sum).
// The caller supplies the A value of (channel, tap) at the thread's pixel
// (the conv's raw input, or a normalized one), the loader rounds it to bf16
// into shared memory with the zero halo applied by the caller's value.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace conv3 {

// c += a . b, mma.sync m16n8k16 (bf16 in, fp32 sum), with g = lane / 4 and
// t = lane % 4:
//   a (16x16, row-major): a0 = (g, 2t..2t+1)    a1 = (g+8, 2t..2t+1)
//                         a2 = (g, 2t+8..2t+9)  a3 = (g+8, 2t+8..2t+9)
//   b (16x8, k x n):      b0 = (k 2t..2t+1, n g) b1 = (k 2t+8..2t+9, n g)
//   c (16x8, fp32):       c0,c1 = (g, 2t..2t+1)  c2,c3 = (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

constexpr int BM = 64;          // output pixels of a CTA
constexpr int BN = 64;          // output channels of a CTA
constexpr int KC = 16;          // channels along K per step
constexpr int BK = KC * 9;      // K per step: (channel, tap), tap fastest
constexpr int LDK = BK + 8;     // smem row stride in bf16 (304 B: the 8 rows
                                // of a fragment read start on distinct banks)
constexpr int NTHREADS = 128;

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* s, int row,
                                            int col) {
  return *reinterpret_cast<const uint32_t*>(s + row * LDK + col);
}

// The A loader's fixed part: each thread fills one pixel row of the tile
// (128 threads over 64 pixels, two threads a row), so its pixel and the
// taps that stay inside the image are fixed for the whole K loop.
struct APixel {
  int am;      // row of the tile this thread fills
  int tap_ok;  // bit tap set when the tap's shifted pixel is in the image
  long long base;  // offset of this pixel in one channel plane

  __device__ __forceinline__ APixel(int m0, int h, int wd) {
    am = threadIdx.x % BM;
    const int pix = m0 + am;
    base = pix;
    tap_ok = 0;
    if (pix < h * wd) {
      const int oh = pix / wd, ow = pix % wd;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int ih = oh + tap / 3 - 1, iw = ow + tap % 3 - 1;
        if (ih >= 0 && ih < h && iw >= 0 && iw < wd) tap_ok |= 1 << tap;
      }
    }
  }
  __device__ __forceinline__ bool in(int tap) const {
    return (tap_ok >> tap) & 1;
  }
  // offset of the tap's shifted pixel in plane c of a [C, h*wd] source
  __device__ __forceinline__ long long at(int c, int tap, int hw,
                                          int wd) const {
    return (long long)c * hw + base + (tap / 3 - 1) * wd + (tap % 3 - 1);
  }
};

// acc += A . B over all kch channels along K, for the CTA's tile at output
// channel n0. a_val(c, tap) is A at the thread's pixel for channel c (0 in
// the halo). FLIP = false: B[n][(c, tap)] = w[n0 + n][c][tap], N bound nch
// (the forward: nch = Co, kch = Ci). FLIP = true: B[n][(c, tap)] =
// w[c][n0 + n][8 - tap] (the input gradient: nch = Ci, kch = Co). w is
// [*, ci, 3, 3] with ci its second dim in both.
template <bool FLIP, typename AVal>
__device__ __forceinline__ void mainloop(float (&acc)[2][4][4],
                                         __nv_bfloat16* as, __nv_bfloat16* bs,
                                         const APixel& px,
                                         const __nv_bfloat16* __restrict__ w,
                                         int kch, int nch, int ci, int n0,
                                         AVal a_val) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int kc0 = 0; kc0 < kch; kc0 += KC) {
    __syncthreads();  // the previous tiles are consumed
    // this thread's pairs (k, k+1) of its pixel row: k = 2*(tid / 64) + 4j
    int k = 2 * (threadIdx.x / BM);
    int kcl = 0, tp = k;
    for (int j = 0; j < BK / 4; ++j) {
      const float v0 = a_val(kc0 + kcl, tp);
      const float v1 =
          tp == 8 ? a_val(kc0 + kcl + 1, 0) : a_val(kc0 + kcl, tp + 1);
      *reinterpret_cast<uint32_t*>(as + px.am * LDK + k) =
          pack_f32(v0, v1);
      k += 4;
      tp += 4;
      if (tp >= 9) {
        tp -= 9;
        ++kcl;
      }
    }
    if (!FLIP) {
      // B[n][k] = w[n0 + n][kc0 .. kc0 + KC)[taps]: one contiguous run of
      // BK values per output channel, 16 bytes per load
      for (int e = threadIdx.x; e < BN * (BK / 8); e += NTHREADS) {
        const int n = e / (BK / 8), chunk = e % (BK / 8);
        uint4 val = make_uint4(0, 0, 0, 0);
        if (n0 + n < nch)
          val = *reinterpret_cast<const uint4*>(
              w + ((size_t)(n0 + n) * ci + kc0) * 9 + chunk * 8);
        *reinterpret_cast<uint4*>(bs + n * LDK + chunk * 8) = val;
      }
    } else {
      // B[n][(col, tap)] = w[kc0 + col][n0 + n][8 - tap]: for each channel
      // col along K, the 9-value kernels of channels n0.. are one
      // contiguous run, read in order
      for (int e = threadIdx.x; e < KC * BN * 9; e += NTHREADS) {
        const int col = e / (BN * 9), j = e % (BN * 9);
        const int n = j / 9, tr = j % 9;
        __nv_bfloat16 val = __float2bfloat16_rn(0.f);
        if (n0 + n < nch) val = w[((size_t)(kc0 + col) * ci + n0 + n) * 9 + tr];
        bs[n * LDK + col * 9 + (8 - tr)] = val;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16;
        a[mt][0] = ld_pair(as, r + g, kk * 16 + 2 * t);
        a[mt][1] = ld_pair(as, r + g + 8, kk * 16 + 2 * t);
        a[mt][2] = ld_pair(as, r + g, kk * 16 + 2 * t + 8);
        a[mt][3] = ld_pair(as, r + g + 8, kk * 16 + 2 * t + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8 + g;
        const uint32_t b0 = ld_pair(bs, n, kk * 16 + 2 * t);
        const uint32_t b1 = ld_pair(bs, n, kk * 16 + 2 * t + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }
}

// Store the CTA's tile rounded to bf16 into out [B, nch, hw] (image b):
// accumulator element (mt, nt, 2*half + e) is pixel
// m0 + wm*32 + mt*16 + g + 8*half, channel n0 + wn*32 + nt*8 + 2t + e.
__device__ __forceinline__ void store_bf16(const float (&acc)[2][4][4],
                                           __nv_bfloat16* __restrict__ out,
                                           int b, int nch, int hw, int m0,
                                           int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * (c >> 1);
        const int n = n0 + wn * 32 + nt * 8 + 2 * t + (c & 1);
        if (m < hw && n < nch)
          out[((size_t)b * nch + n) * hw + m] =
              __float2bfloat16_rn(acc[mt][nt][c]);
      }
}

}  // namespace conv3
