// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v,
// the row log-sum-exp of the forward, dO and delta = rowsum(dO * O); q has
// sq rows, k and v sk rows.
//
// Replaces the JAX package's ops/attention.py:_flash_bwd_fused_kernel (K2,
// launched by _flash_bwd_fused_impl). That kernel loops over query blocks
// per KV block and ADDS each block's dq contribution into one fp32 buffer
// across KV grid steps, which is sound only because a TPU core runs the grid
// in order. CTAs on Hopper run concurrently, so this file splits the work
// the deterministic FlashAttention-2 way, with no atomics:
//   flash_bwd_dkdv_kernel: one CTA per (head, 64-row KV tile) loops over all
//     query tiles and keeps dk, dv in registers;
//   flash_bwd_dq_kernel:   one CTA per (head, 64-row query tile) loops over
//     all KV tiles and keeps dq in registers.
// Both recompute p = exp(s - lse). The arithmetic is the TPU kernel's:
// fp32 logits and p, dv += bf16(p)^T dO, dp = dO V^T in fp32,
// ds = bf16(p * (dp - delta)), dk += ds^T q, dq += ds k in fp32, then
// dq * 1/sqrt(d) rounded to bf16. q arrives pre-scaled by 1/sqrt(d), so dk
// needs no rescale.
//
// The same two kernels are the JAX package's two-pass backward (K3,
// _flash_bwd_dq_kernel + _flash_bwd_dkv_kernel, launched by _flash_bwd_impl),
// which stores dq in bf16 before the 1/sqrt(d) scale: at d = 64 that scale
// is 1/8, exact in bf16, so the two roundings agree with this one. And they
// are its delta-folded backward (K6, _flash_bwd_fused_fold_kernel), which
// adds -delta as a bf16 hi/lo pair inside the dp product: the wrapper
// passes delta = -(f32(d_hi) + f32(d_lo)), the same function up to fp32
// summation order.
//
// Bound: like the forward, matrix throughput (7 mma products per tile pair
// across the two kernels against 5 in the fused TPU form, the price of
// dropping the cross-CTA dq sum). This first version uses mma.sync from
// shared-memory tiles with no copy/compute overlap.
#include "flash_common.cuh"

namespace flash {

// Per-row scalars of the query tile starting at q0: lse (+inf past sq, so
// that p = 0 there) and delta.
__device__ __forceinline__ void load_row_scalars(float* lse_s, float* delta_s,
                                                 const float* lse,
                                                 const float* delta, int q0,
                                                 int sq) {
  for (int r = threadIdx.x; r < BN; r += NTHREADS) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? lse[q0 + r] : INFINITY;
    delta_s[r] = in ? delta[q0 + r] : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int sq, int sk) {
  __shared__ __align__(16) __nv_bfloat16 qs[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 dos[BN * LDS];
  __shared__ float lse_s[BN];
  __shared__ float delta_s[BN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kv0 = blockIdx.x * BM;
  q += (size_t)blockIdx.y * sq * D;
  dout += (size_t)blockIdx.y * sq * D;
  k += (size_t)blockIdx.y * sk * D;
  v += (size_t)blockIdx.y * sk * D;
  dk += (size_t)blockIdx.y * sk * D;
  dv += (size_t)blockIdx.y * sk * D;
  lse += (size_t)blockIdx.y * sq;
  delta += (size_t)blockIdx.y * sq;

  // this warp's 16 KV rows of k and v as A operands (staged through the
  // q / dO buffers before the loop reuses them)
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_tile(qs, k, kv0, sk);
  load_tile(dos, v, kv0, sk);
  __syncthreads();
  load_a_frags(ka, qs, warp * 16, g, t);
  load_a_frags(va, dos, warp * 16, g, t);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[nt][c] = dv_acc[nt][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += BN) {
    __syncthreads();
    load_tile(qs, q, q0, sq);
    load_tile(dos, dout, q0, sq);
    load_row_scalars(lse_s, delta_s, lse, delta, q0, sq);
    __syncthreads();

    // p^T = exp(k q^T - lse): rows = this warp's KV rows, cols = queries
    float pt[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) pt[nt][0] = pt[nt][1] = pt[nt][2] = pt[nt][3] = 0.f;
    mma_abt(pt, ka, qs, g, t);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        pt[nt][c] = __expf(pt[nt][c] - lse_s[nt * 8 + 2 * t + (c & 1)]);

    // dv += bf16(p)^T dO
    mma_pv(dv_acc, pt, dos, g, t);

    // dp^T = v dO^T, then ds^T = p^T * (dp^T - delta)
    float dpt[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    mma_abt(dpt, va, dos, g, t);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dpt[nt][c] =
            pt[nt][c] * (dpt[nt][c] - delta_s[nt * 8 + 2 * t + (c & 1)]);

    // dk += bf16(ds)^T q
    mma_pv(dk_acc, dpt, qs, g, t);
  }

  const int row = kv0 + warp * 16;
  store_rows(dk, dk_acc, row, sk, 1.f, 1.f, g, t);
  store_rows(dv, dv_acc, row, sk, 1.f, 1.f, g, t);
}

__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int sq, int sk,
                        float scale) {
  __shared__ __align__(16) __nv_bfloat16 ks[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[BN * LDS];
  __shared__ float lse_s[BN];
  __shared__ float delta_s[BN];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BM;
  q += (size_t)blockIdx.y * sq * D;
  dout += (size_t)blockIdx.y * sq * D;
  dq += (size_t)blockIdx.y * sq * D;
  k += (size_t)blockIdx.y * sk * D;
  v += (size_t)blockIdx.y * sk * D;
  lse += (size_t)blockIdx.y * sq;
  delta += (size_t)blockIdx.y * sq;

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_tile(ks, q, q0, sq);
  load_tile(vs, dout, q0, sq);
  load_row_scalars(lse_s, delta_s, lse, delta, q0, sq);
  __syncthreads();
  load_a_frags(qa, ks, warp * 16, g, t);
  load_a_frags(doa, vs, warp * 16, g, t);
  const float lse_r[2] = {lse_s[warp * 16 + g], lse_s[warp * 16 + g + 8]};
  const float delta_r[2] = {delta_s[warp * 16 + g],
                            delta_s[warp * 16 + g + 8]};

  float dq_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    dq_acc[nt][0] = dq_acc[nt][1] = dq_acc[nt][2] = dq_acc[nt][3] = 0.f;

  for (int kv0 = 0; kv0 < sk; kv0 += BN) {
    __syncthreads();
    load_tile(ks, k, kv0, sk);
    load_tile(vs, v, kv0, sk);
    __syncthreads();

    float p[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) p[nt][0] = p[nt][1] = p[nt][2] = p[nt][3] = 0.f;
    mma_abt(p, qa, ks, g, t);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[nt][c] = (kv0 + nt * 8 + 2 * t + (c & 1) < sk)
                       ? __expf(p[nt][c] - lse_r[c >> 1])
                       : 0.f;

    float dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    mma_abt(dp, doa, vs, g, t);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dp[nt][c] = p[nt][c] * (dp[nt][c] - delta_r[c >> 1]);

    // dq += bf16(ds) k
    mma_pv(dq_acc, dp, ks, g, t);
  }

  store_rows(dq, dq_acc, q0 + warp * 16, sq, scale, scale, g, t);
}

}  // namespace flash

// q (pre-scaled), dout, dq: [bh, sq, 64], k, v, dk, dv: [bh, sk, 64], bf16
// contiguous; lse, delta: [bh, sq] fp32; scale = 1/sqrt(64) applied to dq.
// Returns the first launch error (cudaError_t), 0 when both kernels were
// accepted.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv,
                              int bh, int sq, int sk, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const dim3 kv_grid((sk + flash::BM - 1) / flash::BM, bh);
  flash::flash_bwd_dkdv_kernel<<<kv_grid, flash::NTHREADS, 0, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf*>(dk), static_cast<bf*>(dv), sq, sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((sq + flash::BM - 1) / flash::BM, bh);
  flash::flash_bwd_dq_kernel<<<q_grid, flash::NTHREADS, 0, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf*>(dq), sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}
