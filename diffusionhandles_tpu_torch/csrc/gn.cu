// GroupNorm(+SiLU) forward and backward for Hopper (sm_90a): NCHW bf16
// activations, fp32 statistics and parameters, bf16 output.
//
// Replaces the JAX package's ops/groupnorm.py:_gn_fwd_kernel and
// _gn_bwd_kernel (launched by _fwd_impl / _bwd_impl). Each TPU kernel makes
// two passes over a (B, 2, S/bs) grid that runs in order on one core, and
// carries the channel sums from the first pass to the second in VMEM
// scratch. Blocks here run in parallel and in no order, so each pass is a
// kernel of its own, and the cross-block sums go through small fp32 arrays
// in a fixed order (deterministic, no atomics):
//   forward:  channel_sums (one warp per (b, c) run) -> group_stats (one
//             thread per (b, g)) -> apply (y = x*A + B, SiLU, 16-byte
//             vectors);
//   backward: bwd_sums (u = sum bf16(dz), v = sum bf16(dz*xh) per (b, c))
//             -> bwd_groups (t1, t2 per (b, g)) -> bwd_apply (dx).
// Rounding points are the TPU kernel's: x*x and the gradient products are
// rounded to x's type before the fp32 sums, the variance is clamped at 0.
// The kernels are templates over the types of x and y (elem.cuh): the
// bf16 instance is the pipeline's, gn_fwd_general / gn_bwd_general take
// fp32 and fp16 (and bf16 x with another y) with the same kernels.
//
// Bound: a few operations per element against 2 bytes read and 2 written
// (forward; backward reads x and dy), far below the card's flop:byte
// balance, so the kernels are bound by memory: 3 passes over x forward
// (two reads, one write), 4 backward. This first version reads x again in
// the apply pass rather than keeping a group in shared memory.
//
// Layout: NCHW. A (batch, channel) pair is one contiguous run of
// hw = H*W values, and the channels of group g of image b are the runs
// (b*G + g)*cg .. (b*G + g)*cg + cg - 1 (cg = C / G), one contiguous block.
#include "gn_common.cuh"

namespace gn {

constexpr int STAT_WARPS = 8;  // (b, c) runs per block of the sums passes

// s1[r] = sum of run r of x, s2[r] = sum of its squares each rounded to
// x's type first, r < runs.
template <typename T>
__global__ void __launch_bounds__(STAT_WARPS * 32)
    channel_sums_kernel(const T* __restrict__ x,
                        float* __restrict__ s1, float* __restrict__ s2,
                        int runs, int hw) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * STAT_WARPS + warp;
  if (r >= runs) return;
  const T* row = x + (size_t)r * hw;
  float a = 0.f, q = 0.f;
  for (int i = lane * VEC; i < hw; i += 32 * VEC) {
    float f[VEC];
    load8(row + i, f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      a += f[j];
      q += elem::round_t<T>(f[j] * f[j]);
    }
  }
  a = warp_sum(a);
  q = warp_sum(q);
  if (lane == 0) {
    s1[r] = a;
    s2[r] = q;
  }
}

// mean[bg], rsig[bg] of the groups bg < groups_total from the channel sums;
// var = s2/n - mean^2, clamped at 0.
__global__ void group_stats_kernel(const float* __restrict__ s1,
                                   const float* __restrict__ s2,
                                   float* __restrict__ mean,
                                   float* __restrict__ rsig, int groups_total,
                                   int cg, float n, float eps) {
  const int bg = blockIdx.x * blockDim.x + threadIdx.x;
  if (bg >= groups_total) return;
  float a = 0.f, q = 0.f;
  for (int c = 0; c < cg; ++c) {
    a += s1[bg * cg + c];
    q += s2[bg * cg + c];
  }
  const float m = a / n;
  const float var = fmaxf(q / n - m * m, 0.f);
  mean[bg] = m;
  rsig[bg] = 1.f / sqrtf(var + eps);
}

// Both statistics passes over x [b, c, hw]: mean and rsig [b*groups] fp32;
// sums is fp32 scratch of 2*b*c.
template <typename T>
cudaError_t launch_group_stats(const T* x, float* sums,
                               float* mean, float* rsig, int b, int c, int hw,
                               int groups, float eps, cudaStream_t stream) {
  const int runs = b * c, cg = c / groups, bg = b * groups;
  channel_sums_kernel<<<(runs + STAT_WARPS - 1) / STAT_WARPS,
                        STAT_WARPS * 32, 0, stream>>>(x, sums, sums + runs,
                                                      runs, hw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  group_stats_kernel<<<(bg + 127) / 128, 128, 0, stream>>>(
      sums, sums + runs, mean, rsig, bg, cg, (float)cg * (float)hw, eps);
  return cudaGetLastError();
}

constexpr int APPLY_THREADS = 256;

// y = x*A + B (A = rsig*gamma, B = beta - mean*A), SiLU when act, x of
// type T and y of type U; one vector of 8 per thread (hw % 8 == 0, so a
// vector lies in one run).
template <typename T, typename U>
__global__ void __launch_bounds__(APPLY_THREADS)
    gn_apply_kernel(const T* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ mean,
                    const float* __restrict__ rsig,
                    U* __restrict__ y, int c, int hw, int cg,
                    int act, long long vecs) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= vecs) return;
  const long long e = i * VEC;
  const int run = (int)(e / hw);
  const int ch = run % c, bg = run / cg;
  const float a = rsig[bg] * gamma[ch];
  const float shift = beta[ch] - mean[bg] * a;
  float f[VEC];
  load8(x + e, f);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float z = f[j] * a + shift;
    f[j] = act ? silu(z) : z;
  }
  store8(y + e, f);
}

// u[r] = sum T(dz), v[r] = sum T(dz * xh) over run r (one warp each), the
// terms rounded to x's type T; dz = dy * silu'(xh*gamma + beta) when act,
// else dy.
template <typename T>
__global__ void __launch_bounds__(STAT_WARPS * 32)
    gn_bwd_sums_kernel(const T* __restrict__ x,
                       const T* __restrict__ dy,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const float* __restrict__ mean,
                       const float* __restrict__ rsig, float* __restrict__ u,
                       float* __restrict__ v, int runs, int c, int hw, int cg,
                       int act) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = blockIdx.x * STAT_WARPS + warp;
  if (r >= runs) return;
  const int ch = r % c, bg = r / cg;
  const float m = mean[bg], rs = rsig[bg], g = gamma[ch], bt = beta[ch];
  const size_t base = (size_t)r * hw;
  float su = 0.f, sv = 0.f;
  for (int i = lane * VEC; i < hw; i += 32 * VEC) {
    float xf[VEC], d[VEC];
    load8(x + base + i, xf);
    load8(dy + base + i, d);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xh = (xf[j] - m) * rs;
      const float dz = act ? d[j] * silu_grad(xh * g + bt) : d[j];
      su += elem::round_t<T>(dz);
      sv += elem::round_t<T>(dz * xh);
    }
  }
  su = warp_sum(su);
  sv = warp_sum(sv);
  if (lane == 0) {
    u[r] = su;
    v[r] = sv;
  }
}

// t1[bg] = sum_c u*gamma / n, t2[bg] = sum_c v*gamma / n over the group's
// channels, in channel order
__global__ void gn_bwd_groups_kernel(const float* __restrict__ u,
                                     const float* __restrict__ v,
                                     const float* __restrict__ gamma,
                                     float* __restrict__ t1,
                                     float* __restrict__ t2, int groups_total,
                                     int c, int cg, float n) {
  const int bg = blockIdx.x * blockDim.x + threadIdx.x;
  if (bg >= groups_total) return;
  float a = 0.f, q = 0.f;
  for (int j = 0; j < cg; ++j) {
    const int r = bg * cg + j;
    a += u[r] * gamma[r % c];
    q += v[r] * gamma[r % c];
  }
  t1[bg] = a / n;
  t2[bg] = q / n;
}

// dx = rsig * (gamma*dz - t1 - xh*t2), one vector of 8 per thread
template <typename T>
__global__ void __launch_bounds__(APPLY_THREADS)
    gn_bwd_apply_kernel(const T* __restrict__ x,
                        const T* __restrict__ dy,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ mean,
                        const float* __restrict__ rsig,
                        const float* __restrict__ t1,
                        const float* __restrict__ t2,
                        T* __restrict__ dx, int c, int hw, int cg,
                        int act, long long vecs) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= vecs) return;
  const long long e = i * VEC;
  const int run = (int)(e / hw);
  const int ch = run % c, bg = run / cg;
  const float m = mean[bg], rs = rsig[bg], g = gamma[ch], bt = beta[ch];
  const float a1 = t1[bg], a2 = t2[bg];
  float xf[VEC], d[VEC];
  load8(x + e, xf);
  load8(dy + e, d);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float xh = (xf[j] - m) * rs;
    const float dz = act ? d[j] * silu_grad(xh * g + bt) : d[j];
    xf[j] = rs * (g * dz - a1 - xh * a2);
  }
  store8(dx + e, xf);
}

template <typename T, typename U>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        void* mean, void* rsig, void* sums, int b, int c, int hw, int groups,
        float eps, int act, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  cudaError_t err = launch_group_stats(
      xt, static_cast<float*>(sums), static_cast<float*>(mean),
      static_cast<float*>(rsig), b, c, hw, groups, eps, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = (long long)b * c * hw / VEC;
  gn_apply_kernel<T, U><<<(unsigned)((vecs + APPLY_THREADS - 1) /
                                     APPLY_THREADS),
                          APPLY_THREADS, 0, st>>>(
      xt, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const float*>(mean), static_cast<const float*>(rsig),
      static_cast<U*>(y), c, hw, c / groups, act, vecs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* dy, const void* gamma, const void* beta,
        const void* mean, const void* rsig, void* dx, void* u, void* v,
        void* t1, void* t2, int b, int c, int hw, int groups, int act,
        cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* m = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rsig);
  float* uf = static_cast<float*>(u);
  float* vf = static_cast<float*>(v);
  float* t1f = static_cast<float*>(t1);
  float* t2f = static_cast<float*>(t2);
  const int runs = b * c, cg = c / groups, bg = b * groups;
  gn_bwd_sums_kernel<T><<<(runs + STAT_WARPS - 1) / STAT_WARPS,
                          STAT_WARPS * 32, 0, st>>>(
      xt, dyt, g, bt, m, rs, uf, vf, runs, c, hw, cg, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_bwd_groups_kernel<<<(bg + 127) / 128, 128, 0, st>>>(
      uf, vf, g, t1f, t2f, bg, c, cg, (float)cg * (float)hw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long vecs = (long long)runs * hw / VEC;
  gn_bwd_apply_kernel<T><<<(unsigned)((vecs + APPLY_THREADS - 1) /
                                      APPLY_THREADS),
                           APPLY_THREADS, 0, st>>>(
      xt, dyt, g, bt, m, rs, t1f, t2f, static_cast<T*>(dx), c, hw, cg, act,
      vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gn

// x, y: [b, c, hw] bf16 contiguous and 16-byte aligned, hw % 8 == 0,
// c % groups == 0; gamma, beta: [c] fp32; mean, rsig: [b*groups] fp32 out;
// sums: fp32 scratch of 2*b*c. Returns the launches' cudaError_t.
extern "C" int gn_fwd_bf16(const void* x, const void* gamma, const void* beta,
                           void* y, void* mean, void* rsig, void* sums, int b,
                           int c, int hw, int groups, float eps, int act,
                           void* stream) {
  return gn::fwd<__nv_bfloat16, __nv_bfloat16>(
      x, gamma, beta, y, mean, rsig, sums, b, c, hw, groups, eps, act,
      static_cast<cudaStream_t>(stream));
}

// x, dy, dx: [b, c, hw] bf16; mean, rsig from gn_fwd_bf16; u, v: [b*c]
// fp32 out (dbeta and dgamma are their sums over b); t1, t2: fp32 scratch
// of b*groups each. Returns the launches' cudaError_t.
extern "C" int gn_bwd_bf16(const void* x, const void* dy, const void* gamma,
                           const void* beta, const void* mean,
                           const void* rsig, void* dx, void* u, void* v,
                           void* t1, void* t2, int b, int c, int hw,
                           int groups, int act, void* stream) {
  return gn::bwd<__nv_bfloat16>(x, dy, gamma, beta, mean, rsig, dx, u, v, t1,
                                t2, b, c, hw, groups, act,
                                static_cast<cudaStream_t>(stream));
}

// gn_fwd_bf16's instances for the other types: x of dtype code xdt, y of
// ydt (elem.cuh's ELEM_*); the same kernels and rounding points, rounded
// to x's type where the bf16 instance rounds to bf16.
extern "C" int gn_fwd_general(int xdt, int ydt, const void* x,
                              const void* gamma, const void* beta, void* y,
                              void* mean, void* rsig, void* sums, int b,
                              int c, int hw, int groups, float eps, int act,
                              void* stream) {
  return elem::dispatch(xdt, [&](auto xt) {
    return elem::dispatch(ydt, [&](auto yt) {
      return gn::fwd<decltype(xt), decltype(yt)>(
          x, gamma, beta, y, mean, rsig, sums, b, c, hw, groups, eps, act,
          static_cast<cudaStream_t>(stream));
    });
  });
}

// gn_bwd_bf16's instances for the other types: x, dy and dx of dtype code
// dt.
extern "C" int gn_bwd_general(int dt, const void* x, const void* dy,
                              const void* gamma, const void* beta,
                              const void* mean, const void* rsig, void* dx,
                              void* u, void* v, void* t1, void* t2, int b,
                              int c, int hw, int groups, int act,
                              void* stream) {
  return elem::dispatch(dt, [&](auto t) {
    return gn::bwd<decltype(t)>(x, dy, gamma, beta, mean, rsig, dx, u, v, t1,
                                t2, b, c, hw, groups, act,
                                static_cast<cudaStream_t>(stream));
  });
}
