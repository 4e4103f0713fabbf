// Fused GroupNorm + SiLU + 3x3 conv (SAME, stride 1) forward and input
// gradient for Hopper (sm_90a): channels-last (NHWC) bf16 activations, the
// weight held channels-last ([Co][3][3][Ci], as K7 reads it), fp32
// statistics and accumulation.
//
// Replaces the JAX package's ops/gn_conv.py:_gn_conv_fwd_kernel and
// _gn_conv_bwd_kernel (launched by _fwd_impl / _bwd_dx_impl). Each TPU
// kernel holds one whole padded image in VMEM: it reduces the GroupNorm
// statistics in place, normalizes, and runs the nine shifted tap matmuls
// over the normalized image. No CTA holds an image here (227 KB of shared
// memory), so the work is cut at the two points where it needs all of an
// image, and the GEMM is K7's (conv.cu, through conv.cuh's run()):
//   forward: slot_sums -> group_sums (mean, rsig per (b, g)) -> prologue
//            (z = bf16(silu((x - mean) * rsig * gamma + beta)), once per
//            element, written channels-last) -> K7's forward GEMM on z;
//   dx:      K7's dx GEMM of dy (fp32 output, every split's partials kept)
//            -> slot_sums<DX> (the epilogue: dz = the fixed-order sum of
//            the splits, dxh = dz * silu'(xh * gamma + beta) * gamma written
//            in fp32, per-slot channel sums of dxh and dxh * xh)
//            -> group_sums (t1, t2 per (b, g)) -> dx_apply
//            (dx = rsig * (dxh - t1 - xh * t2)).
// A slot is SLOT consecutive pixels of one image; every cross-block sum
// goes through per-slot partials summed in a fixed order (no atomics), so
// both directions are bitwise repeatable.
//
// The passes are templates over the activations' type (elem.cuh). The
// bf16 and fp16 instances (channels multiples of 8, 8 channels a thread)
// run K7's TMA + wgmma GEMM; the general instances (gn_conv_*_general:
// fp32, or bf16/fp16 with other channel counts, one channel a thread) run
// K7's general GEMM (conv_general.cu: tf32 on the tensor cores, fp32 as
// three passes), split over K where its planner says.
//
// Bound on this card: the conv's 2*B*H*W*9*Ci*Co operations against the
// weight's 18*Ci*Co bytes plus the activations' (at 64x64 320 -> 320: 7.5
// GFLOP, 7.6 us at 989 TFLOP/s), the same as K7's. What K9 adds is memory
// traffic, a few bytes an element per pass: the forward reads x twice and
// writes z once (2.6 MB each at 64x64x320); dx writes and reads dz and dxh
// in fp32 (5.2 MB each) and reads x twice. Normalizing in the GEMM's A
// loader instead (once per tap and N tile) moves that work onto the
// special-function units, which then bound the mainloop.
#include "conv.cuh"
#include "gn_common.cuh"

namespace gnconv {

constexpr int SLOT = 8;           // pixels of one partial-sum slot
constexpr int PAIRS = 32;         // channel pairs of one slot_sums block
constexpr int GROUP_THREADS = 512;
constexpr int APPLY_THREADS = 256;

// Per slot (SLOT pixels of image b) and channel c, into s1/s2 [b][slot][c]:
//   DX = false: s1 = sum x, s2 = sum x*x (fp32, not rounded);
//   DX = true:  dz = sum over the splits of part[s] (s in order);
//               dxh = dz * silu'(xh*gamma + beta) * gamma is written to
//               dxh, s1 = sum dxh, s2 = sum dxh * xh, xh = (x - mean)*rsig.
// Grid (b * slots, ceil(c / (CP * PAIRS))), block (PAIRS, SLOT): thread
// (t, y) takes channels CP t .. CP t + CP - 1 of its block's range at the
// slot's pixel y (c is a multiple of CP); the slot's SLOT values of a
// channel are then summed in pixel order through shared memory. x is of
// type T.
template <typename T, bool DX, int CP>
__global__ void __launch_bounds__(PAIRS * SLOT)
    slot_sums_kernel(const T* __restrict__ x,
                     const float* __restrict__ part, int splits,
                     long long elems, const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ mean,
                     const float* __restrict__ rsig,
                     float* __restrict__ dxh, float* __restrict__ s1,
                     float* __restrict__ s2, int hw, int c, int cg,
                     int groups, int slots) {
  __shared__ float red[2][SLOT][PAIRS][CP];
  const int b = blockIdx.x / slots, slot = blockIdx.x % slots;
  const int ch = CP * (blockIdx.y * PAIRS + threadIdx.x);
  const int p = slot * SLOT + threadIdx.y;
  float a[CP] = {}, q[CP] = {};
  if (ch < c && p < hw) {
    const long long e = (static_cast<long long>(b) * hw + p) * c + ch;
    float xv[CP];
    elem::load<T, CP>(x + e, xv);
    if (!DX) {
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        a[j] = xv[j];
        q[j] = xv[j] * xv[j];
      }
    } else {
      float dz[CP] = {};
#pragma unroll 4
      for (int s = 0; s < splits; ++s) {
        float v[CP];
        elem::load<float, CP>(part + s * elems + e, v);
#pragma unroll
        for (int j = 0; j < CP; ++j) dz[j] += v[j];
      }
#pragma unroll
      for (int j = 0; j < CP; ++j) {
        const int bg = b * groups + (ch + j) / cg;
        const float xh = (xv[j] - mean[bg]) * rsig[bg];
        const float g = gamma[ch + j];
        a[j] = dz[j] * gn::silu_grad(xh * g + beta[ch + j]) * g;
        q[j] = a[j] * xh;
      }
      elem::store<float, CP>(dxh + e, a);
    }
  }
#pragma unroll
  for (int j = 0; j < CP; ++j) {
    red[0][threadIdx.y][threadIdx.x][j] = a[j];
    red[1][threadIdx.y][threadIdx.x][j] = q[j];
  }
  __syncthreads();
  if (threadIdx.y != 0 || ch >= c) return;
#pragma unroll
  for (int j = 0; j < CP; ++j) a[j] = q[j] = 0.f;
#pragma unroll
  for (int y = 0; y < SLOT; ++y) {
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      a[j] += red[0][y][threadIdx.x][j];
      q[j] += red[1][y][threadIdx.x][j];
    }
  }
  const long long o = (static_cast<long long>(b) * slots + slot) * c + ch;
  elem::store<float, CP>(s1 + o, a);
  elem::store<float, CP>(s2 + o, q);
}

// One block per (b, g): the sums of s1 and s2 over the group's cg channels
// and the image's slots, in a fixed order (each thread a fixed stride of
// the items, then warp and block trees). stats: out1 = mean, out2 = rsig =
// 1/sqrt(E[x^2] - mean^2 + eps), not clamped; else out1 = sum s1 / n,
// out2 = sum s2 / n.
__global__ void __launch_bounds__(GROUP_THREADS)
    group_sums_kernel(const float* __restrict__ s1,
                      const float* __restrict__ s2, float* __restrict__ out1,
                      float* __restrict__ out2, int groups, int c, int cg,
                      int slots, float n, float eps, int stats) {
  __shared__ float red[2][GROUP_THREADS / 32];
  const int bg = blockIdx.x;
  const int b = bg / groups, g = bg % groups;
  const int items = slots * cg;
  float a = 0.f, q = 0.f;
  for (int i = threadIdx.x; i < items; i += GROUP_THREADS) {
    const long long idx =
        (static_cast<long long>(b) * slots + i / cg) * c + g * cg + i % cg;
    a += s1[idx];
    q += s2[idx];
  }
  a = gn::warp_sum(a);
  q = gn::warp_sum(q);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = q;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  a = q = 0.f;
#pragma unroll
  for (int w = 0; w < GROUP_THREADS / 32; ++w) {
    a += red[0][w];
    q += red[1][w];
  }
  if (stats) {
    const float mu = a / n;
    out1[bg] = mu;
    out2[bg] = 1.f / sqrtf(q / n - mu * mu + eps);
  } else {
    out1[bg] = a / n;
    out2[bg] = q / n;
  }
}

// z = T(silu((x - mean) * rsig * gamma + beta)), V channels of one pixel
// per thread (c is a multiple of V); the products and the sum rounded one
// at a time (no fused multiply-add), as the plain version computes them.
// Grid (vectors of one image / APPLY_THREADS, b): offsets within an image
// in 32 bits.
template <typename T, int V>
__global__ void __launch_bounds__(APPLY_THREADS)
    prologue_kernel(const T* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ mean,
                    const float* __restrict__ rsig,
                    T* __restrict__ z, int c, int cg, int groups,
                    int hwc) {
  const int i = (blockIdx.x * APPLY_THREADS + threadIdx.x) * V;
  if (i >= hwc) return;
  const int b = blockIdx.y;
  const long long e = static_cast<long long>(b) * hwc + i;
  const int ch0 = i % c;
  float f[V];
  elem::load<T, V>(x + e, f);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int bg = b * groups + (ch0 + j) / cg;
    const float xh = __fmul_rn(f[j] - mean[bg], rsig[bg]);
    f[j] = gn::silu(__fadd_rn(__fmul_rn(xh, gamma[ch0 + j]), beta[ch0 + j]));
  }
  elem::store<T, V>(z + e, f);
}

// dx = rsig * (dxh - t1 - xh * t2), V channels of one pixel per thread;
// the grid as prologue_kernel's
template <typename T, int V>
__global__ void __launch_bounds__(APPLY_THREADS)
    dx_apply_kernel(const T* __restrict__ x,
                    const float* __restrict__ dxh,
                    const float* __restrict__ mean,
                    const float* __restrict__ rsig,
                    const float* __restrict__ t1,
                    const float* __restrict__ t2,
                    T* __restrict__ dx, int c, int cg, int groups,
                    int hwc) {
  const int i = (blockIdx.x * APPLY_THREADS + threadIdx.x) * V;
  if (i >= hwc) return;
  const int b = blockIdx.y;
  const long long e = static_cast<long long>(b) * hwc + i;
  const int ch0 = i % c;
  float xf[V], d[V];
  elem::load<T, V>(x + e, xf);
  elem::load<float, V>(dxh + e, d);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int bg = b * groups + (ch0 + j) / cg;
    const float rs = rsig[bg];
    const float xh = (xf[j] - mean[bg]) * rs;
    xf[j] = rs * (d[j] - t1[bg] - xh * t2[bg]);
  }
  elem::store<T, V>(dx + e, xf);
}

int slots_of(int hw) { return (hw + SLOT - 1) / SLOT; }

// The grid of slot_sums_kernel with CP channels a thread
dim3 slot_grid(int b, int hw, int c, int cp) {
  return dim3(b * slots_of(hw), (c + cp * PAIRS - 1) / (cp * PAIRS));
}

// The grid of prologue_kernel and dx_apply_kernel: V channels a thread
dim3 apply_grid(int b, int hwc, int v) {
  return dim3((hwc / v + APPLY_THREADS - 1) / APPLY_THREADS, b);
}

// The conv GEMM of one direction: K7's (conv.cu) for the bf16 and fp16
// instances, or with GENERAL the general one (conv_general.cu) in T; plan:
// (nwg, bn, bw, bh, bb, splits) for either.
template <typename T, bool GENERAL>
int gemm(bool dx, const void* src, const void* w, void* out, float* part,
         bool f32_out, int b, int h, int wd, int ci, int co, const int* plan,
         cudaStream_t st) {
  if constexpr (GENERAL) {
    return conv::run_general(elem::code_of<T>(), dx, src, w, out, part,
                             f32_out, b, h, wd, ci, co, plan[0], plan[1],
                             plan[2], plan[3], plan[4], plan[5], st);
  } else {
    return conv::run<T>(dx, src, w, out, part, f32_out, b, h, wd, ci, co,
                        plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
                        st);
  }
}

// The forward: V channels a thread in the elementwise passes, CP in the
// sums (V = 8, CP = 2 for the bf16 instance on K7's GEMM, 1 and 1 for the
// general one); plan = K7's (nwg, bn, bw, bh, bb, splits), or with GENERAL
// the general GEMM's.
template <typename T, int V, int CP, bool GENERAL>
int fwd(const void* x, const void* gamma, const void* beta, const void* w,
        void* y, void* z, void* mean, void* rsig, void* sums, void* part,
        int b, int h, int wd, int ci, int co, int groups, float eps,
        const int* plan, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rsig);
  const int hw = h * wd, cg = ci / groups, slots = slots_of(hw);
  float* s1 = static_cast<float*>(sums);
  float* s2 = s1 + static_cast<long long>(b) * slots * ci;
  slot_sums_kernel<T, false, CP>
      <<<slot_grid(b, hw, ci, CP), dim3(PAIRS, SLOT), 0, st>>>(
          xt, nullptr, 0, 0, nullptr, nullptr, nullptr, nullptr, nullptr, s1,
          s2, hw, ci, cg, groups, slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_sums_kernel<<<b * groups, GROUP_THREADS, 0, st>>>(
      s1, s2, m, rs, groups, ci, cg, slots,
      static_cast<float>(cg) * static_cast<float>(hw), eps, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  prologue_kernel<T, V><<<apply_grid(b, hw * ci, V), APPLY_THREADS, 0, st>>>(
      xt, g, bt, m, rs, static_cast<T*>(z), ci, cg, groups, hw * ci);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return gemm<T, GENERAL>(false, z, w, y, static_cast<float*>(part), false, b,
                          h, wd, ci, co, plan, st);
}

// dx, with V, CP, GENERAL and plan as fwd's (plan: the dx plan, fp32 out)
template <typename T, int V, int CP, bool GENERAL>
int dx(const void* x, const void* gamma, const void* beta, const void* w,
       const void* mean, const void* rsig, const void* dy, void* dxo,
       void* part, void* dxh, void* sums, void* t12, int b, int h, int wd,
       int ci, int co, int groups, const int* plan, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const float* m = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rsig);
  float* pf = static_cast<float*>(part);
  float* dxhf = static_cast<float*>(dxh);
  const int hw = h * wd, cg = ci / groups, slots = slots_of(hw);
  float* s1 = static_cast<float*>(sums);
  float* s2 = s1 + static_cast<long long>(b) * slots * ci;
  float* t1 = static_cast<float*>(t12);
  float* t2 = t1 + b * groups;
  const int rc = gemm<T, GENERAL>(true, dy, w, nullptr, pf, true, b, h, wd,
                                  ci, co, plan, st);
  if (rc != 0) return rc;
  const int splits = plan[5];
  const long long elems = static_cast<long long>(b) * hw * ci;
  slot_sums_kernel<T, true, CP>
      <<<slot_grid(b, hw, ci, CP), dim3(PAIRS, SLOT), 0, st>>>(
          xt, pf, splits, elems, static_cast<const float*>(gamma),
          static_cast<const float*>(beta), m, rs, dxhf, s1, s2, hw, ci, cg,
          groups, slots);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  group_sums_kernel<<<b * groups, GROUP_THREADS, 0, st>>>(
      s1, s2, t1, t2, groups, ci, cg, slots,
      static_cast<float>(cg) * static_cast<float>(hw), 0.f, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dx_apply_kernel<T, V><<<apply_grid(b, hw * ci, V), APPLY_THREADS, 0, st>>>(
      xt, dxhf, m, rs, t1, t2, static_cast<T*>(dxo), ci, cg, groups, hw * ci);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gnconv

// x: [b, h, wd, ci] bf16 (NHWC), w: [co, 3, 3, ci] bf16 (PyTorch's
// channels-last [co, ci, 3, 3]), all dense and 16-byte aligned, ci and co
// multiples of 8, groups dividing ci; gamma, beta: [ci] fp32. Out: y
// [b, h, wd, co] bf16, z [b, h, wd, ci] bf16 (the normalized activation),
// mean and rsig [b*groups] fp32. sums: fp32 scratch of 2*b*ceil(h*wd/8)*ci;
// part: as conv.cuh's run() takes it. The plan (nwg .. splits) is K7's.
// Returns the launches' cudaError_t, or one of conv.cuh's errors.
extern "C" int gn_conv_fwd_bf16(const void* x, const void* gamma,
                                const void* beta, const void* w, void* y,
                                void* z, void* mean, void* rsig, void* sums,
                                void* part, int b, int h, int wd, int ci,
                                int co, int groups, float eps, int nwg,
                                int bn, int bw, int bh, int bb, int splits,
                                void* stream) {
  const int plan[6] = {nwg, bn, bw, bh, bb, splits};
  return gnconv::fwd<__nv_bfloat16, gn::VEC, 2, false>(
      x, gamma, beta, w, y, z, mean, rsig, sums, part, b, h, wd, ci, co,
      groups, eps, plan, static_cast<cudaStream_t>(stream));
}

// x, w, gamma, beta as gn_conv_fwd_bf16; mean, rsig: its statistics; dy:
// [b, h, wd, co] bf16 (NHWC); dx: [b, h, wd, ci] bf16 out. Scratch: part,
// splits*b*h*wd*ci fp32 (the GEMM's output); dxh, b*h*wd*ci fp32; sums,
// 2*b*ceil(h*wd/8)*ci fp32; t12, 2*b*groups fp32. The plan is K7's dx
// plan. Returns the launches' cudaError_t, or one of conv.cuh's errors.
extern "C" int gn_conv_dx_bf16(const void* x, const void* gamma,
                               const void* beta, const void* w,
                               const void* mean, const void* rsig,
                               const void* dy, void* dx, void* part,
                               void* dxh, void* sums, void* t12, int b, int h,
                               int wd, int ci, int co, int groups, int nwg,
                               int bn, int bw, int bh, int bb, int splits,
                               void* stream) {
  const int plan[6] = {nwg, bn, bw, bh, bb, splits};
  return gnconv::dx<__nv_bfloat16, gn::VEC, 2, false>(
      x, gamma, beta, w, mean, rsig, dy, dx, part, dxh, sums, t12, b, h, wd,
      ci, co, groups, plan, static_cast<cudaStream_t>(stream));
}

// The fp16 instances of gn_conv_fwd_bf16 and gn_conv_dx_bf16: x, w, y, z,
// dy and dx in fp16, K7's fp16 GEMM.
extern "C" int gn_conv_fwd_f16(const void* x, const void* gamma,
                               const void* beta, const void* w, void* y,
                               void* z, void* mean, void* rsig, void* sums,
                               void* part, int b, int h, int wd, int ci,
                               int co, int groups, float eps, int nwg, int bn,
                               int bw, int bh, int bb, int splits,
                               void* stream) {
  const int plan[6] = {nwg, bn, bw, bh, bb, splits};
  return gnconv::fwd<__half, gn::VEC, 2, false>(
      x, gamma, beta, w, y, z, mean, rsig, sums, part, b, h, wd, ci, co,
      groups, eps, plan, static_cast<cudaStream_t>(stream));
}

extern "C" int gn_conv_dx_f16(const void* x, const void* gamma,
                              const void* beta, const void* w,
                              const void* mean, const void* rsig,
                              const void* dy, void* dx, void* part, void* dxh,
                              void* sums, void* t12, int b, int h, int wd,
                              int ci, int co, int groups, int nwg, int bn,
                              int bw, int bh, int bb, int splits,
                              void* stream) {
  const int plan[6] = {nwg, bn, bw, bh, bb, splits};
  return gnconv::dx<__half, gn::VEC, 2, false>(
      x, gamma, beta, w, mean, rsig, dy, dx, part, dxh, sums, t12, b, h, wd,
      ci, co, groups, plan, static_cast<cudaStream_t>(stream));
}

// The general instances (any ci and co, groups dividing ci): x, w, y, z,
// dy and dx of dtype code dt (elem.cuh), dense channels-last; the same
// passes one channel a thread around the general GEMM (conv_general.cu)
// with its plan (ops/conv.py:plan_conv3x3_general): nwg consumer
// warpgroups, N tile bn, pixel box bw x bh x bb, splits K ranges. part:
// fp32 scratch of splits*b*h*wd*co values when splits > 1 (forward),
// splits*b*h*wd*ci (dx).
extern "C" int gn_conv_fwd_general(int dt, const void* x, const void* gamma,
                                   const void* beta, const void* w, void* y,
                                   void* z, void* mean, void* rsig,
                                   void* sums, void* part, int b, int h,
                                   int wd, int ci, int co, int groups,
                                   float eps, int nwg, int bn, int bw, int bh,
                                   int bb, int splits, void* stream) {
  const int plan[6] = {nwg, bn, bw, bh, bb, splits};
  return elem::dispatch(dt, [&](auto t) {
    return gnconv::fwd<decltype(t), 1, 1, true>(
        x, gamma, beta, w, y, z, mean, rsig, sums, part, b, h, wd, ci, co,
        groups, eps, plan, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int gn_conv_dx_general(int dt, const void* x, const void* gamma,
                                  const void* beta, const void* w,
                                  const void* mean, const void* rsig,
                                  const void* dy, void* dx, void* part,
                                  void* dxh, void* sums, void* t12, int b,
                                  int h, int wd, int ci, int co, int groups,
                                  int nwg, int bn, int bw, int bh, int bb,
                                  int splits, void* stream) {
  const int plan[6] = {nwg, bn, bw, bh, bb, splits};
  return elem::dispatch(dt, [&](auto t) {
    return gnconv::dx<decltype(t), 1, 1, true>(
        x, gamma, beta, w, mean, rsig, dy, dx, part, dxh, sums, t12, b, h, wd,
        ci, co, groups, plan, static_cast<cudaStream_t>(stream));
  });
}
