// Fused GroupNorm + SiLU + 3x3 conv (SAME, stride 1) forward and input
// gradient for Hopper (sm_90a): NCHW bf16 activations, PyTorch's
// [Co, Ci, 3, 3] bf16 weight, fp32 statistics and accumulation.
//
// Replaces the JAX package's ops/gn_conv.py:_gn_conv_fwd_kernel and
// _gn_conv_bwd_kernel (launched by _fwd_impl / _bwd_dx_impl). Each TPU
// kernel holds one whole padded image (up to 72 MB of VMEM) in one grid
// cell: it reduces the GroupNorm statistics in place, then runs the nine
// shifted tap matmuls over it. No CTA can hold an image (227 KB of shared
// memory), so the statistics become passes of their own (gn_common.cuh),
// and the conv is an implicit GEMM over tiles:
//   M = H*W output pixels, N = output channels, K = 9 * input channels,
//   ordered (channel, tap) with the tap fastest: PyTorch's own weight
//   order, so the forward reads w as the [Co, 9*Ci] matrix it already is.
// The A-tile loader normalizes each value it loads, (x - mean)*rsig*gamma
// + beta in fp32, applies SiLU and the zero halo (SAME padding), and rounds
// to bf16 into shared memory: the normalized activation never goes to
// device memory. mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//   forward: y = bf16(sum of the nine taps); the bias is added outside.
//   dx:      the same GEMM of dy against the flipped, transposed kernel
//            (B[(co, tap)][ci] = w[co][ci][8 - tap]). The epilogue forms
//            dxh = dz * silu'(xh*gamma + beta) * gamma, writes it in fp32
//            and, per CTA, the per-channel sums of dxh and dxh*xh over its
//            64 pixels (fixed order, no atomics). dx_groups reduces those
//            to the group means t1, t2; dx_apply writes
//            dx = rsig * (dxh - t1 - xh*t2).
//
// Bound: 2*H*W*9*Ci*Co operations against (H*W*(Ci + Co) + 9*Ci*Co) * 2
// bytes: at 64x64x320 -> 320, 7.5 GFLOP over 7 MB, above the card's
// flop:byte balance, so the kernel should be bound by its matrix
// throughput. This first version is far from it: the loader recomputes the
// normalization once per tap (9x), tiles are 64x64 with no copy/compute
// overlap, and the 8x8 and 16x16 levels fill only 20-40 CTAs. wgmma, TMA,
// a channels-last layout and a normalized-activation stage are the known
// next steps.
//
// Grid: (ceil(H*W / 64) pixel tiles, ceil(N / 64) channel tiles, B).
// Block: 4 warps, 2 x 2 over the 64 x 64 tile, 32 x 32 each; the GEMM
// mainloop is conv3x3_gemm.cuh's (used by this file alone).
#include "conv3x3_gemm.cuh"
#include "gn_common.cuh"

namespace gnconv {

using conv3::BM;
using conv3::BN;
using conv3::NTHREADS;

// DX = false: src = x [B, Ci, hw], y = conv(silu(gn(x))) [B, Co, hw].
// DX = true:  src = dy [B, Co, hw], x is read in the epilogue, dxh
//             [B, Ci, hw] and part1/part2 [B, pixel tiles, Ci] are written.
template <bool DX>
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_kernel(const __nv_bfloat16* __restrict__ src,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta,
                   const float* __restrict__ mean,
                   const float* __restrict__ rsig,
                   const __nv_bfloat16* __restrict__ x,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ dxh,
                   float* __restrict__ part1, float* __restrict__ part2,
                   int ci, int co, int h, int wd, int cg, int groups) {
  __shared__ __align__(16) __nv_bfloat16 as[BM * conv3::LDK];
  __shared__ __align__(16) __nv_bfloat16 bs[BN * conv3::LDK];
  __shared__ float red[2][2][BN];  // dx: [sum][warp row][channel]

  const int hw = h * wd;
  const int kch = DX ? co : ci;  // channels along K
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 2, wn = warp % 2;

  const conv3::APixel px(m0, h, wd);
  const __nv_bfloat16* asrc = src + (size_t)b * kch * hw;
  // A[m][(c, tap)]: the (normalized, SiLU'd) source value at the tap's
  // shifted pixel, 0 in the halo
  auto a_val = [&](int c, int tp) -> float {
    if (!px.in(tp)) return 0.f;
    const float raw = __bfloat162float(asrc[px.at(c, tp, hw, wd)]);
    if (DX) return raw;
    const int bg = b * groups + c / cg;
    return gn::silu((raw - mean[bg]) * rsig[bg] * gamma[c] + beta[c]);
  };
  float acc[2][4][4];
  conv3::mainloop<DX>(acc, as, bs, px, w, kch, DX ? ci : co, ci, n0, a_val);

  if (!DX) {
    conv3::store_bf16(acc, y, b, co, hw, m0, n0);
    return;
  }

  float s1[4][2], s2[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) s1[nt][0] = s1[nt][1] = s2[nt][0] = s2[nt][1] = 0.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * (c >> 1);
        const int n = n0 + wn * 32 + nt * 8 + 2 * t + (c & 1);
        if (m < hw && n < ci) {
          const size_t idx = ((size_t)b * ci + n) * hw + m;
          const int bg = b * groups + n / cg;
          const float xh = (__bfloat162float(x[idx]) - mean[bg]) * rsig[bg];
          const float ga = gamma[n];
          const float d = acc[mt][nt][c] * gn::silu_grad(xh * ga + beta[n]) * ga;
          dxh[idx] = d;
          s1[nt][c & 1] += d;
          s2[nt][c & 1] += d * xh;
        }
      }
  // sum over the 8 pixel rows g of the warp (lane bits 2..4)
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], off);
        s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], off);
      }
  if (g == 0) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        red[0][wm][wn * 32 + nt * 8 + 2 * t + e] = s1[nt][e];
        red[1][wm][wn * 32 + nt * 8 + 2 * t + e] = s2[nt][e];
      }
  }
  __syncthreads();
  const int n = threadIdx.x;
  if (n < BN && n0 + n < ci) {
    const size_t o = ((size_t)b * gridDim.x + blockIdx.x) * ci + n0 + n;
    part1[o] = red[0][0][n] + red[0][1][n];
    part2[o] = red[1][0][n] + red[1][1][n];
  }
}

// t1[bg] = mean over group bg of dxh, t2[bg] = of dxh*xh: the per-CTA
// channel sums, in (pixel tile, channel) order, over n = cg*hw
__global__ void dx_groups_kernel(const float* __restrict__ part1,
                                 const float* __restrict__ part2,
                                 float* __restrict__ t1,
                                 float* __restrict__ t2, int groups_total,
                                 int groups, int ci, int cg, int mtiles,
                                 float n) {
  const int bg = blockIdx.x * blockDim.x + threadIdx.x;
  if (bg >= groups_total) return;
  const int b = bg / groups, gi = bg % groups;
  float a = 0.f, q = 0.f;
  for (int mt = 0; mt < mtiles; ++mt)
    for (int c = 0; c < cg; ++c) {
      const size_t idx = ((size_t)b * mtiles + mt) * ci + gi * cg + c;
      a += part1[idx];
      q += part2[idx];
    }
  t1[bg] = a / n;
  t2[bg] = q / n;
}

constexpr int APPLY_THREADS = 256;

// dx = rsig * (dxh - t1 - xh*t2), 8 values per thread
__global__ void __launch_bounds__(APPLY_THREADS)
    dx_apply_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dxh,
                    const float* __restrict__ mean,
                    const float* __restrict__ rsig,
                    const float* __restrict__ t1,
                    const float* __restrict__ t2,
                    __nv_bfloat16* __restrict__ dx, int hw, int cg,
                    long long vecs) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= vecs) return;
  const long long e = i * gn::VEC;
  const int bg = (int)(e / hw) / cg;
  const float m = mean[bg], rs = rsig[bg], a1 = t1[bg], a2 = t2[bg];
  float xf[gn::VEC];
  gn::load8(x + e, xf);
  const float4 d0 = reinterpret_cast<const float4*>(dxh + e)[0];
  const float4 d1 = reinterpret_cast<const float4*>(dxh + e)[1];
  const float d[gn::VEC] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
#pragma unroll
  for (int j = 0; j < gn::VEC; ++j) {
    const float xh = (xf[j] - m) * rs;
    xf[j] = rs * (d[j] - a1 - xh * a2);
  }
  gn::store8(dx + e, xf);
}

}  // namespace gnconv

// x: [b, ci, h, wd] bf16, w: [co, ci, 3, 3] bf16, both contiguous and
// 16-byte aligned, ci and co multiples of 16, h*wd of 8; gamma, beta: [ci]
// fp32; y: [b, co, h, wd] bf16 out; mean, rsig: [b*groups] fp32 out; sums:
// fp32 scratch of 2*b*ci. Returns the launches' cudaError_t.
extern "C" int gn_conv_fwd_bf16(const void* x, const void* gamma,
                                const void* beta, const void* w, void* y,
                                void* mean, void* rsig, void* sums, int b,
                                int ci, int co, int h, int wd, int groups,
                                float eps, void* stream) {
  using namespace gnconv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rsig);
  cudaError_t err = gn::launch_group_stats(xb, static_cast<float*>(sums), m,
                                           rs, b, ci, h * wd, groups, eps,
                                           false, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h * wd + BM - 1) / BM, (co + BN - 1) / BN, b);
  conv3x3_kernel<false><<<grid, NTHREADS, 0, st>>>(
      xb, static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), m,
      rs, nullptr, static_cast<__nv_bfloat16*>(y), nullptr, nullptr, nullptr,
      ci, co, h, wd, ci / groups, groups);
  return static_cast<int>(cudaGetLastError());
}

// x, w, gamma, beta as gn_conv_fwd_bf16; mean, rsig: its statistics; dy:
// [b, co, h, wd] bf16; dx: [b, ci, h, wd] bf16 out; dxh: fp32 scratch like
// x; part: fp32 scratch of 2*b*ceil(h*wd/64)*ci; t12: of 2*b*groups.
// Returns the launches' cudaError_t.
extern "C" int gn_conv_dx_bf16(const void* x, const void* gamma,
                               const void* beta, const void* w,
                               const void* mean, const void* rsig,
                               const void* dy, void* dx, void* dxh,
                               void* part, void* t12, int b, int ci, int co,
                               int h, int wd, int groups, void* stream) {
  using namespace gnconv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hw = h * wd, mtiles = (hw + BM - 1) / BM, cg = ci / groups;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* m = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rsig);
  float* dxhf = static_cast<float*>(dxh);
  float* part1 = static_cast<float*>(part);
  float* part2 = part1 + (size_t)b * mtiles * ci;
  float* t1 = static_cast<float*>(t12);
  float* t2 = t1 + b * groups;
  const dim3 grid(mtiles, (ci + BN - 1) / BN, b);
  conv3x3_kernel<true><<<grid, NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), m, rs, xb, nullptr, dxhf, part1,
      part2, ci, co, h, wd, cg, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bg = b * groups;
  dx_groups_kernel<<<(bg + 127) / 128, 128, 0, st>>>(
      part1, part2, t1, t2, bg, groups, ci, cg, mtiles,
      (float)cg * (float)hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = (long long)b * ci * hw / gn::VEC;
  dx_apply_kernel<<<(unsigned)((vecs + APPLY_THREADS - 1) / APPLY_THREADS),
                    APPLY_THREADS, 0, st>>>(
      xb, dxhf, m, rs, t1, t2, static_cast<__nv_bfloat16*>(dx), hw, cg, vecs);
  return static_cast<int>(cudaGetLastError());
}
