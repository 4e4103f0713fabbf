// 3x3 SAME stride-1 conv forward and input gradient for Hopper (sm_90a):
// NCHW bf16 activations, PyTorch's [Co, Ci, 3, 3] bf16 weight, fp32
// accumulation, bf16 output. No bias: the caller adds it outside.
//
// Replaces the JAX package's ops/conv.py:_conv3_kernel (launched by
// _conv3x3_pallas, for the forward of conv3x3 and, with the flipped,
// in/out-transposed kernel, for its input gradient). That kernel pads the
// image, flattens its rows and holds the whole padded [(H+3)*(W+2), Ci]
// activation in VMEM, so each of the nine taps is one contiguous shifted
// slice fed to an MXU matmul, and it computes and drops two wrap-around
// columns a row. No CTA holds an image (227 KB of shared memory), so here
// the conv is the implicit GEMM of conv3x3_gemm.cuh, the mainloop of the
// fused GroupNorm conv (gn_conv.cu) with a loader that returns the raw bf16
// value at the tap's shifted pixel (0 in the halo, so no padded copy and
// no wrap-around columns exist):
//   forward: y = bf16(sum over (ci, tap) of x * w), M = H*W, N = Co,
//            K = 9*Ci;
//   dx:      dx = bf16(sum over (co, tap) of dy * w[co][ci][8 - tap]), the
//            same GEMM of dy against the flipped, transposed kernel read
//            straight from w, N = Ci, K = 9*Co.
//
// Bound: 2*H*W*9*Ci*Co operations against (H*W*(Ci + Co) + 9*Ci*Co) * 2
// bytes: at 64x64, 320 -> 320, 7.5 GFLOP over 7 MB, above the card's
// flop:byte balance, so the kernel should be bound by its matrix
// throughput. This first version is far from it: 64x64 tiles from a scalar
// A loader, mma.sync with no copy/compute overlap, and the 8x8 and 16x16
// levels fill only 20-80 CTAs of 132 SMs. wgmma, TMA, a channels-last
// layout and split-K at the small levels are the known next steps.
//
// Grid: (ceil(H*W / 64) pixel tiles, ceil(N / 64) channel tiles, B).
// Block: 4 warps, 2 x 2 over the 64 x 64 output tile.
#include "conv3x3_gemm.cuh"

namespace conv {

// FLIP = false: src = x [B, Ci, hw], out = y [B, Co, hw].
// FLIP = true:  src = dy [B, Co, hw], out = dx [B, Ci, hw].
template <bool FLIP>
__global__ void __launch_bounds__(conv3::NTHREADS)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ src,
                   const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int ci, int co, int h,
                   int wd) {
  __shared__ __align__(16) __nv_bfloat16 as[conv3::BM * conv3::LDK];
  __shared__ __align__(16) __nv_bfloat16 bs[conv3::BN * conv3::LDK];

  const int hw = h * wd;
  const int kch = FLIP ? co : ci;  // channels along K
  const int nch = FLIP ? ci : co;  // channels along N
  const int m0 = blockIdx.x * conv3::BM, n0 = blockIdx.y * conv3::BN;
  const int b = blockIdx.z;

  const conv3::APixel px(m0, h, wd);
  const __nv_bfloat16* asrc = src + (size_t)b * kch * hw;
  auto a_val = [&](int c, int tp) -> float {
    return px.in(tp) ? __bfloat162float(asrc[px.at(c, tp, hw, wd)]) : 0.f;
  };
  float acc[2][4][4];
  conv3::mainloop<FLIP>(acc, as, bs, px, w, kch, nch, ci, n0, a_val);
  conv3::store_bf16(acc, out, b, nch, hw, m0, n0);
}

template <bool FLIP>
int launch(const void* src, const void* w, void* out, int b, int ci, int co,
           int h, int wd, void* stream) {
  const dim3 grid((h * wd + conv3::BM - 1) / conv3::BM,
                  ((FLIP ? ci : co) + conv3::BN - 1) / conv3::BN, b);
  conv3x3_kernel<FLIP><<<grid, conv3::NTHREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(src),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out),
      ci, co, h, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv

// x: [b, ci, h, wd] bf16, w: [co, ci, 3, 3] bf16, both contiguous, w 16-byte
// aligned; ci and co multiples of 16; y: [b, co, h, wd] bf16 out. Returns the
// launch's cudaError_t.
extern "C" int conv3x3_fwd_bf16(const void* x, const void* w, void* y, int b,
                                int ci, int co, int h, int wd, void* stream) {
  return conv::launch<false>(x, w, y, b, ci, co, h, wd, stream);
}

// dy: [b, co, h, wd] bf16, w as conv3x3_fwd_bf16; dx: [b, ci, h, wd] bf16
// out. Returns the launch's cudaError_t.
extern "C" int conv3x3_dx_bf16(const void* dy, const void* w, void* dx, int b,
                               int ci, int co, int h, int wd, void* stream) {
  return conv::launch<true>(dy, w, dx, b, ci, co, h, wd, stream);
}
