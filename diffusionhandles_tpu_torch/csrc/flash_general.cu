// The general flash-attention kernels, forward and backward: the flash
// kernels' functions (flash_fwd.cu, flash_bwd.cu) for what their TMA +
// wgmma kernels are not built for, so that every call the routing gate
// admits runs a kernel on the card: fp32 operands (those kernels take bf16
// and fp16) and any head dim (they are built for 64).
//
// Same functions and rounding points as the plain versions in
// ops/attention.py, with T the operands' type:
//   forward (K1, or K4/K5 with F32_SUM): q_s = T(q * scale); s = q_s . k
//            in fp32; a running row max m and row sum l over key tiles,
//            p = exp(s - m) rounded to T for the value product, the row
//            sum over the rounded p (K1) or the fp32 p (F32_SUM);
//            o = T(acc / l), lse = m + log(l);
//   backward: delta = rowsum(dO * O) in fp32 (K6: -(hi + lo) of its T
//            hi/lo pair); p = exp(s - lse); dv = T(p)^T dO; dp = dO V^T;
//            ds = T(p * (dp - delta)); dk = ds^T q_s; dq = (ds k) * scale,
//            rounded once (K2, K6) or rounded before the scale too (K3).
// q, k, v, O and dO are read as [B, S, H, D] views through their element
// strides; O, dq, dk and dv are written dense [B, S, H, D], lse [B*H, Sq].
//
// A first, plain design on the CUDA cores. A CTA of 256 threads owns 64
// rows (queries forward and for dq, keys for dk/dv) and 64 columns of the
// head dim (grid.z steps over wider heads; each such CTA recomputes the
// row's logits). Per step of 64 keys (or queries) it forms the 64 x 64
// logit tile by staging 32-wide slices of both operands' head dim in
// shared memory as fp32, each thread summing 8 logits of each of two rows
// (two rows a thread halve the shared-memory reads per product); the 8
// threads of a row reduce its max and sum with shuffles; the probabilities
// go through shared memory into the value product. Bound on this card:
// the operations, 4*B*H*Sq*Sk*D forward (the two products; 10 backward,
// with the recomputed logits) at the fp32 rate of the CUDA cores (67
// TFLOP/s).
#include <math.h>

#include "elem.cuh"

namespace flashgen {

constexpr int THREADS = 256;
constexpr int RT = 2;        // rows a thread: rr and rr + 32 (rr = tid / 8)
constexpr int BR = 32 * RT;  // rows of a CTA
constexpr int BC = 64;       // keys (or queries) of a step
constexpr int DC = 32;       // head-dim slice of a logit step
constexpr int OC = 64;       // head-dim columns of a CTA's output

// Dynamic shared memory, in floats: the two logit operands' slices, nw
// tiles of probabilities or logit gradients, the value-side tile
constexpr int A_F = BR * (DC + 1), C_F = BC * (DC + 1);
constexpr int W_F = BR * (BC + 1), X_F = BC * (OC + 1);
constexpr int smem_bytes(int nw) {
  return static_cast<int>(sizeof(float)) * (A_F + C_F + nw * W_F + X_F);
}

struct Smem {
  float (*as)[DC + 1];
  float (*cs)[DC + 1];
  float (*xs)[OC + 1];
  float (*w0)[BC + 1];
  float (*w1)[BC + 1];
};

__device__ __forceinline__ Smem carve(float* f) {
  Smem m;
  m.as = reinterpret_cast<float (*)[DC + 1]>(f);
  m.cs = reinterpret_cast<float (*)[DC + 1]>(f + A_F);
  m.xs = reinterpret_cast<float (*)[OC + 1]>(f + A_F + C_F);
  m.w0 = reinterpret_cast<float (*)[BC + 1]>(f + A_F + C_F + X_F);
  m.w1 = reinterpret_cast<float (*)[BC + 1]>(f + A_F + C_F + X_F + W_F);
  return m;
}

// One [B, S, H, D] operand: its base and element strides
template <typename T>
struct View {
  const T* p;
  long long sb, ss, sh, sd;
  __device__ __forceinline__ float at(int b, int s, int h, int d) const {
    return elem::to_f(p[b * sb + s * ss + h * sh + d * sd]);
  }
};

template <typename T>
struct Args {
  View<T> q, k, v, o, dout;
  T* out0;      // O forward, dq backward: dense [B, Sq, H, D]
  T* out1;      // dk: dense [B, Sk, H, D]
  T* out2;      // dv: dense [B, Sk, H, D]
  float* lse;   // [B*H, Sq]
  float* delta; // [B*H, Sq] (backward)
  int b, sq, sk, h, d;
  float scale;
};

// s[r][j] = x[row0 + r][col0 + j] (zero outside n rows and D columns), as
// T(x * scale) when `pre` (the pre-scaled q)
template <typename T, int NR, int NC>
__device__ __forceinline__ void stage(float (*s)[NC + 1], const View<T>& x,
                                      int b, int h, int row0, int n,
                                      int col0, int dim, bool pre,
                                      float scale) {
  for (int i = threadIdx.x; i < NR * NC; i += THREADS) {
    const int r = i / NC, j = i % NC;
    const int row = row0 + r, col = col0 + j;
    float v = 0.f;
    if (row < n && col < dim) {
      v = x.at(b, row, h, col);
      if (pre) v = elem::round_t<T>(v * scale);
    }
    s[r][j] = v;
  }
}

// acc[i][u] = sum over the head dim of a[a0 + rr + 32 i] . c[c0 + j + 8 u]
// for this thread's rows (rr = tid / 8) and columns (j = tid % 8)
template <typename T>
__device__ __forceinline__ void logits(float (&acc)[RT][8], const Smem& m,
                                       const View<T>& a, int a0, int na,
                                       bool pre_a, const View<T>& c, int c0,
                                       int nc, bool pre_c, int b, int h,
                                       int dim, float scale) {
  const int rr = threadIdx.x / 8, j = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[i][u] = 0.f;
  for (int d0 = 0; d0 < dim; d0 += DC) {
    __syncthreads();
    stage<T, BR, DC>(m.as, a, b, h, a0, na, d0, dim, pre_a, scale);
    stage<T, BC, DC>(m.cs, c, b, h, c0, nc, d0, dim, pre_c, scale);
    __syncthreads();
#pragma unroll 4
    for (int dd = 0; dd < DC; ++dd) {
      float x[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) x[i] = m.as[rr + 32 * i][dd];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float y = m.cs[j + 8 * u][dd];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][u] = fmaf(x[i], y, acc[i][u]);
      }
    }
  }
}

// o[i][u] += sum_k w[rr + 32 i][k] * x[x0 + k][oc0 + j + 8 u] over the
// step's BC rows of x (w: this step's probabilities or logit gradients)
template <typename T>
__device__ __forceinline__ void accumulate(float (&o)[RT][8],
                                           float (*w)[BC + 1], const Smem& m,
                                           const View<T>& x, int x0, int nx,
                                           int oc0, int b, int h, int dim,
                                           bool pre, float scale) {
  const int rr = threadIdx.x / 8, j = threadIdx.x % 8;
  __syncthreads();
  stage<T, BC, OC>(m.xs, x, b, h, x0, nx, oc0, dim, pre, scale);
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < BC; ++k) {
    float p[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) p[i] = w[rr + 32 * i][k];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float y = m.xs[k][j + 8 * u];
#pragma unroll
      for (int i = 0; i < RT; ++i) o[i][u] = fmaf(p[i], y, o[i][u]);
    }
  }
}

// The 8 threads of a row: max and sum
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Grid (ceil(Sq / BR), B*H, ceil(D / OC)); smem_bytes(1)
template <typename T, bool F32_SUM>
__global__ void __launch_bounds__(THREADS) fwd_kernel(Args<T> a) {
  extern __shared__ float smem[];
  const Smem m = carve(smem);
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int q0 = blockIdx.x * BR, oc0 = blockIdx.z * OC;
  const int rr = threadIdx.x / 8, j = threadIdx.x % 8;
  float mx[RT], l[RT], o[RT][8] = {};
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    mx[i] = -INFINITY;
    l[i] = 0.f;
  }
  for (int k0 = 0; k0 < a.sk; k0 += BC) {
    float s[RT][8];
    logits(s, m, a.q, q0, a.sq, true, a.k, k0, a.sk, false, b, h, a.d,
           a.scale);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float tile_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + j + 8 * u < a.sk) tile_max = fmaxf(tile_max, s[i][u]);
      const float m_new = fmaxf(mx[i], row_max(tile_max));
      const float alpha = expf(mx[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float p = k0 + j + 8 * u < a.sk ? expf(s[i][u] - m_new) : 0.f;
        const float pr = elem::round_t<T>(p);
        sum += F32_SUM ? p : pr;
        m.w0[rr + 32 * i][j + 8 * u] = pr;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      mx[i] = m_new;
#pragma unroll
      for (int u = 0; u < 8; ++u) o[i][u] *= alpha;
    }
    accumulate(o, m.w0, m, a.v, k0, a.sk, oc0, b, h, a.d, false, a.scale);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + rr + 32 * i;
    if (row >= a.sq) continue;
    const long long base =
        ((static_cast<long long>(b) * a.sq + row) * a.h + h) * a.d;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = oc0 + j + 8 * u;
      if (col < a.d) a.out0[base + col] = elem::from_f<T>(o[i][u] / l[i]);
    }
    if (blockIdx.z == 0 && j == 0)
      a.lse[static_cast<long long>(bh) * a.sq + row] = mx[i] + logf(l[i]);
  }
}

// delta of every (b, h, query) row; `fold`: -(hi + lo) of the T pair of
// -delta (K6)
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(Args<T> a, int fold) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (i >= static_cast<long long>(a.b) * a.h * a.sq) return;
  const int bh = static_cast<int>(i / a.sq), s = static_cast<int>(i % a.sq);
  const int b = bh / a.h, h = bh % a.h;
  float acc = 0.f;
  for (int d = 0; d < a.d; ++d)
    acc = fmaf(a.dout.at(b, s, h, d), a.o.at(b, s, h, d), acc);
  if (fold) {
    const float hi = elem::round_t<T>(-acc);
    const float lo = elem::round_t<T>(-acc - hi);
    acc = -(hi + lo);
  }
  a.delta[i] = acc;
}

// dk and dv of BR keys: grid (ceil(Sk / BR), B*H, ceil(D / OC));
// smem_bytes(2)
template <typename T>
__global__ void __launch_bounds__(THREADS) dkdv_kernel(Args<T> a) {
  extern __shared__ float smem[];
  const Smem m = carve(smem);
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int k0 = blockIdx.x * BR, oc0 = blockIdx.z * OC;
  const int rr = threadIdx.x / 8, j = threadIdx.x % 8;
  float dk[RT][8] = {}, dv[RT][8] = {};
  for (int q0 = 0; q0 < a.sq; q0 += BC) {
    float s[RT][8], dp[RT][8];
    logits(s, m, a.k, k0, a.sk, false, a.q, q0, a.sq, true, b, h, a.d,
           a.scale);
    logits(dp, m, a.v, k0, a.sk, false, a.dout, q0, a.sq, false, b, h, a.d,
           a.scale);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const bool key_ok = k0 + rr + 32 * i < a.sk;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int qi = q0 + j + 8 * u;
        float p = 0.f, g = 0.f;
        if (key_ok && qi < a.sq) {
          const long long li = static_cast<long long>(bh) * a.sq + qi;
          p = expf(s[i][u] - a.lse[li]);
          g = elem::round_t<T>(p * (dp[i][u] - a.delta[li]));
        }
        m.w0[rr + 32 * i][j + 8 * u] = elem::round_t<T>(p);
        m.w1[rr + 32 * i][j + 8 * u] = g;
      }
    }
    accumulate(dv, m.w0, m, a.dout, q0, a.sq, oc0, b, h, a.d, false,
               a.scale);
    accumulate(dk, m.w1, m, a.q, q0, a.sq, oc0, b, h, a.d, true, a.scale);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int key = k0 + rr + 32 * i;
    if (key >= a.sk) continue;
    const long long base =
        ((static_cast<long long>(b) * a.sk + key) * a.h + h) * a.d;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = oc0 + j + 8 * u;
      if (col < a.d) {
        a.out1[base + col] = elem::from_f<T>(dk[i][u]);
        a.out2[base + col] = elem::from_f<T>(dv[i][u]);
      }
    }
  }
}

// dq of BR queries: grid (ceil(Sq / BR), B*H, ceil(D / OC)); smem_bytes(1);
// `twopass` rounds dq to T before the scale (K3)
template <typename T>
__global__ void __launch_bounds__(THREADS) dq_kernel(Args<T> a, int twopass) {
  extern __shared__ float smem[];
  const Smem m = carve(smem);
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int q0 = blockIdx.x * BR, oc0 = blockIdx.z * OC;
  const int rr = threadIdx.x / 8, j = threadIdx.x % 8;
  float lse[RT], delta[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + rr + 32 * i;
    const long long li = static_cast<long long>(bh) * a.sq + row;
    lse[i] = row < a.sq ? a.lse[li] : 0.f;
    delta[i] = row < a.sq ? a.delta[li] : 0.f;
  }
  float dq[RT][8] = {};
  for (int k0 = 0; k0 < a.sk; k0 += BC) {
    float s[RT][8], dp[RT][8];
    logits(s, m, a.q, q0, a.sq, true, a.k, k0, a.sk, false, b, h, a.d,
           a.scale);
    logits(dp, m, a.dout, q0, a.sq, false, a.v, k0, a.sk, false, b, h, a.d,
           a.scale);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const bool ok = q0 + rr + 32 * i < a.sq;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float g = 0.f;
        if (ok && k0 + j + 8 * u < a.sk)
          g = elem::round_t<T>(expf(s[i][u] - lse[i]) *
                               (dp[i][u] - delta[i]));
        m.w0[rr + 32 * i][j + 8 * u] = g;
      }
    }
    accumulate(dq, m.w0, m, a.k, k0, a.sk, oc0, b, h, a.d, false, a.scale);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + rr + 32 * i;
    if (row >= a.sq) continue;
    const long long base =
        ((static_cast<long long>(b) * a.sq + row) * a.h + h) * a.d;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int col = oc0 + j + 8 * u;
      if (col < a.d) {
        const float v = twopass ? elem::round_t<T>(dq[i][u]) : dq[i][u];
        a.out0[base + col] = elem::from_f<T>(v * a.scale);
      }
    }
  }
}

// Lets kernel `k` take `bytes` of dynamic shared memory (over 48 KB)
template <typename K>
cudaError_t allow_smem(K k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
View<T> view(const void* p, const long long* st) {
  return View<T>{static_cast<const T*>(p), st[0], st[1], st[2], st[3]};
}

}  // namespace flashgen

// The forward (K1; K4/K5 with f32_sum): q [b, sq, h, d], k and v
// [b, sk, h, d] of dtype code dt (elem.cuh), read through `strides` (their
// (sb, ss, sh, sd) in elements, q's then k's then v's); o dense
// [b, sq, h, d] of the same type, lse [b*h, sq] fp32; scale = 1/sqrt(d).
// Returns the launch's cudaError_t, or elem.cuh's ERR_DTYPE.
extern "C" int flash_general_fwd(int dt, const void* q, const void* k,
                                 const void* v, void* o, void* lse,
                                 const long long* strides, int b, int sq,
                                 int sk, int h, int d, int f32_sum,
                                 float scale, void* stream) {
  using namespace flashgen;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((sq + BR - 1) / BR, b * h, (d + OC - 1) / OC);
  return elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    Args<T> a{view<T>(q, strides), view<T>(k, strides + 4),
              view<T>(v, strides + 8), {}, {}, static_cast<T*>(o), nullptr,
              nullptr, static_cast<float*>(lse), nullptr, b, sq, sk, h, d,
              scale};
    const int bytes = smem_bytes(1);
    cudaError_t err = f32_sum ? allow_smem(fwd_kernel<T, true>, bytes)
                              : allow_smem(fwd_kernel<T, false>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (f32_sum)
      fwd_kernel<T, true><<<grid, THREADS, bytes, st>>>(a);
    else
      fwd_kernel<T, false><<<grid, THREADS, bytes, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  });
}

// The backward: q, k, v, o, dout as the forward's operands (strides: q, k,
// v, o, dout, four each), lse from the forward; dq, dk, dv dense out;
// delta: fp32 scratch of b*h*sq. mode 0: K2, 1: K3 (dq rounded before the
// scale), 2: K6 (delta from its hi/lo pair). Returns the launches'
// cudaError_t, or elem.cuh's ERR_DTYPE.
extern "C" int flash_general_bwd(int dt, const void* q, const void* k,
                                 const void* v, const void* o,
                                 const void* dout, const void* lse, void* dq,
                                 void* dk, void* dv, void* delta,
                                 const long long* strides, int b, int sq,
                                 int sk, int h, int d, int mode, float scale,
                                 void* stream) {
  using namespace flashgen;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int oz = (d + OC - 1) / OC;
  return elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    Args<T> a{view<T>(q, strides), view<T>(k, strides + 4),
              view<T>(v, strides + 8), view<T>(o, strides + 12),
              view<T>(dout, strides + 16), static_cast<T*>(dq),
              static_cast<T*>(dk), static_cast<T*>(dv),
              const_cast<float*>(static_cast<const float*>(lse)),
              static_cast<float*>(delta), b, sq, sk, h, d, scale};
    const long long rows = static_cast<long long>(b) * h * sq;
    delta_kernel<T><<<static_cast<unsigned>((rows + THREADS - 1) / THREADS),
                      THREADS, 0, st>>>(a, mode == 2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = allow_smem(dkdv_kernel<T>, smem_bytes(2));
    if (err == cudaSuccess) err = allow_smem(dq_kernel<T>, smem_bytes(1));
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<T><<<dim3((sk + BR - 1) / BR, b * h, oz), THREADS,
                     smem_bytes(2), st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<T><<<dim3((sq + BR - 1) / BR, b * h, oz), THREADS,
                   smem_bytes(1), st>>>(a, mode == 1);
    return static_cast<int>(cudaGetLastError());
  });
}
