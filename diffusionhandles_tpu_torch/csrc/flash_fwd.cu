// Flash-attention forward for Hopper (sm_90a): non-causal, unmasked,
// bf16 inputs, fp32 logits and softmax state, bf16 output plus the fp32
// row log-sum-exp that the backward needs. q has sq rows, k and v sk rows.
//
// Replaces three forward kernels of the JAX package's ops/attention.py,
// all launched by _flash_fwd_impl, which differ only in where p is rounded:
//   _flash_onepass_fold_kernel (K1, F32_SUM = false): the denominator l is
//     summed over the SAME bf16-rounded probabilities that feed the value
//     product (the ones column of v_aug): p is rounded once, then summed
//     and multiplied;
//   _flash_onepass_kernel (K5, F32_SUM = true): one global row max, l summed
//     over the fp32 p, p rounded to bf16 only for the value product;
//   _flash_kernel (K4, F32_SUM = true): the same sums with a running max
//     and denominator over block_k chunks of K/V.
// The TPU kernels hold a [block_q, sk] fp32 logit block (K1, K5) or a
// [block_q, block_k] one (K4) in VMEM. 227 KB of shared memory holds no
// such block, so this kernel streams K/V in 64-row tiles with an online
// max and denominator for all three. As on the TPU, q arrives pre-scaled
// by 1/sqrt(d). Here p is relative to the running max of 64-key tiles, so
// the bf16 rounding points of p differ from K1's and K5's (global max) and
// K4's (block_k chunks) by the online rescale; one F32_SUM instantiation
// serves both K4 and K5, and is held against each one's plain version.
//
// Bound: at the U-Net's shapes (S = 4096 or 1024 tokens, d = 64) the work
// is 4*sq*sk*d flops per head against (2*sq + 2*sk)*d*2 bytes of q/k/v/o,
// far above the card's flop:byte balance, so the kernel is bound by its
// matrix throughput. This first version uses warp-level mma.sync (bf16 in,
// fp32 accumulate) from shared-memory tiles with no copy/compute overlap;
// wgmma, TMA and a pipelined K/V ring are the known next steps.
//
// Grid: (ceil(sq / 64) query tiles, B*H). Block: 4 warps, 16 query rows each.
#include "flash_common.cuh"

namespace flash {

template <bool F32_SUM>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int sq, int sk) {
  __shared__ __align__(16) __nv_bfloat16 qs[BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 ks[BN * LDS];
  __shared__ __align__(16) __nv_bfloat16 vs[BN * LDS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BM;
  q += (size_t)blockIdx.y * sq * D;
  o += (size_t)blockIdx.y * sq * D;
  k += (size_t)blockIdx.y * sk * D;
  v += (size_t)blockIdx.y * sk * D;
  lse += (size_t)blockIdx.y * sq;

  load_tile(qs, q, q0, sq);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a_frags(qa, qs, warp * 16, g, t);

  // running state of rows g (index 0) and g + 8 (index 1); l is this
  // thread's partial sum over its own columns, reduced across the quad at
  // the end (the rescale factors are the same for the whole row)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int kv0 = 0; kv0 < sk; kv0 += BN) {
    __syncthreads();  // previous tile fully consumed
    load_tile(ks, k, kv0, sk);
    load_tile(vs, v, kv0, sk);
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    mma_abt(s, qa, ks, g, t);

    if (kv0 + BN > sk) {  // ragged last tile: drop columns past sk
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (kv0 + nt * 8 + 2 * t + (c & 1) >= sk) s[nt][c] = -INFINITY;
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);  // finite: kv0 < sk
      alpha[r] = __expf(m[r] - m_new);         // 0 on the first tile
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // the value product rounds p to bf16 (mma_pv); K1 sums that same
        // rounded value, K4/K5 the fp32 one
        const float p = __expf(s[nt][c] - m[c >> 1]);
        s[nt][c] = p;
        l[c >> 1] += F32_SUM ? p
                             : __bfloat162float(__float2bfloat16_rn(p));
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    mma_pv(acc, s, vs, g, t);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row = q0 + warp * 16;
  store_rows(o, acc, row, sq, 1.f / l[0], 1.f / l[1], g, t);
  if (t == 0) {
    if (row + g < sq) lse[row + g] = m[0] + logf(l[0]);
    if (row + g + 8 < sq) lse[row + g + 8] = m[1] + logf(l[1]);
  }
}

}  // namespace flash

// q, o: [bh, sq, 64], k, v: [bh, sk, 64], bf16 contiguous, q pre-scaled by
// 1/sqrt(64); lse: [bh, sq] fp32. f32_sum = 0: the row sum over the
// bf16-rounded p (K1); otherwise over the fp32 p (K4, K5). Returns the
// launch's cudaError_t.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int sk,
                              int f32_sum, void* stream) {
  const dim3 grid((sq + flash::BM - 1) / flash::BM, bh);
  auto kernel = f32_sum ? &flash::flash_fwd_kernel<true>
                        : &flash::flash_fwd_kernel<false>;
  kernel<<<grid, flash::NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), sq, sk);
  return static_cast<int>(cudaGetLastError());
}
