// Flash-attention forward for Hopper (sm_90a): non-causal, unmasked,
// bf16 inputs, fp32 logits and softmax state, bf16 output plus the fp32
// row log-sum-exp that the backward needs. q has sq rows, k and v sk rows.
// The kernel is a template over the 16-bit type: the fp16 instance
// (flash_fwd_f16) reads, rounds p to and writes fp16 where the bf16 one
// uses bf16.
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
// such block, so this kernel streams K/V in BN-row tiles with an online
// max and denominator for all three. Here p is relative to the running max
// of BN-key tiles, so the bf16 rounding points of p differ from K1's and
// K5's (global max) and K4's (block_k chunks) by the online rescale; one
// F32_SUM instantiation serves both K4 and K5, and is held against each
// one's plain version. The 1/sqrt(64) scale is applied here, to the fp32
// logits (flash_common.cuh: SCALE), folded with log2(e) into the one FFMA
// before each ex2.
//
// Bound: 4*sq*sk*64 flops per head against (2*sq + 2*sk)*64*2 bytes, far
// above the card's flop:byte balance: the tensor cores bound it. At d = 64
// the exponentials do too: the special-function units give ~3.9e12 ex2 a
// second (16 per SM per clock) against 989e12 bf16 flop/s, and each logit
// costs one ex2 against 4*64 = 256 flops of the two products, so at
// [1,4096,5,64] the 83.9 M exponentials take ~21.7 us, as long as the
// products' 21.7 us. Only overlap of the two reaches the bound. The design:
//   - a CTA owns a query tile of 64 rows per consumer warpgroup (one or
//     two); the producer warpgroup's first thread loads the Q tile once and
//     streams K and V tiles of BN keys by TMA into two rings of STAGES
//     mbarrier-tracked stages (K and V apart, so that a K tile is released
//     as soon as its logits are done); with two consumer warpgroups
//     setmaxnreg moves the producer's registers to them, with one two CTAs
//     share an SM;
//   - S = Q K^T is an SS wgmma (Q and K K-major in shared memory);
//     O += P V an RS wgmma: P packed to bf16 from the S accumulator is the
//     register A operand (hopper.cuh: acc_to_a), V is read MN-major;
//   - overlap within a warpgroup, FlashAttention-3's way: tile j's S
//     product is issued together with tile j-1's P V product, and tile j's
//     max and exponentials run while P V is still on the tensor cores; the
//     two consumer warpgroups of a CTA interleave freely (making them take
//     turns at the tensor cores, FlashAttention-3's ping-pong, measured no
//     faster: PERF.md, Findings);
//   - key columns past sk (TMA zero-fills those rows of K, which would give
//     logit 0) are set to -inf in registers on the ragged last tile;
//   - the epilogue stages each warpgroup's bf16 rows in its own Q rows of
//     shared memory and writes them with one TMA store in the [B, S, H, D]
//     layout (clipped past sq).
// The query tile (consumer warpgroups) and BN come from the planner in
// ops/attention.py (plan_flash); this file only checks them.
#include "flash_common.cuh"

namespace flash {

template <int NWG, int BN>
struct FwdCfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int STAGES = 2;
  static constexpr int Q_BYTES = BM * ROW;
  static constexpr int KV_BYTES = BN * ROW;  // one K or V tile
  // 1024 of slack to align the base for the swizzle, then the barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 256;
  static constexpr int THREADS = 128 * (NWG + 1);
  // one warpgroup: two CTAs share an SM, 128 registers a thread (enough
  // at BN = 64); two: setmaxnreg moves the producer's to the consumers
  static constexpr int MIN_BLOCKS = NWG == 1 ? 2 : 1;
  static_assert(BN % 16 == 0 && (NWG == 2 || BN == 64), "BN");
};

struct FwdParams {
  int h, sq, sk;
  float* lse;  // [B*H, sq]
};

// T: the operands' type, bf16 or fp16
template <typename T, bool F32_SUM, int NWG, int BN>
__global__ void __launch_bounds__(FwdCfg<NWG, BN>::THREADS,
                                  FwdCfg<NWG, BN>::MIN_BLOCKS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap o_map,
                     const FwdParams p) {
  using C = FwdCfg<NWG, BN>;
  constexpr int ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + C::Q_BYTES;
  uint8_t* v_s = k_s + ST * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + ST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int q0 = blockIdx.x * C::BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (p.sk + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 4 * NWG);  // one arrival per consumer warp
      mbar_init(&v_empty[s], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup: one thread issues every copy
    if constexpr (NWG == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    if (threadIdx.x == NWG * 128) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_load_4d(q_s, &q_map, q_full, 0, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t ph = ((j / ST) & 1) ^ 1;
        mbar_wait(&k_empty[s], ph);
        mbar_expect_tx(&k_full[s], C::KV_BYTES);
        tma_load_4d(k_s + s * C::KV_BYTES, &k_map, &k_full[s], 0, h, j * BN,
                    b);
        mbar_wait(&v_empty[s], ph);
        mbar_expect_tx(&v_full[s], C::KV_BYTES);
        tma_load_4d(v_s + s * C::KV_BYTES, &v_map, &v_full[s], 0, h, j * BN,
                    b);
      }
    }
  } else {
    // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of the tile
    if constexpr (NWG == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    const int lane = threadIdx.x % 32;
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * ROW;
    const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
    // exp(s - m) = 2^(s_raw * c - m_raw * c): s_raw is the unscaled logit
    constexpr float c = SCALE * LOG2E;

    float s_acc[BN / 2];     // logits of the current tile, then its p
    uint32_t pa[BN / 4];     // T p of the previous tile (A operand)
    float o_acc[32];
    float m[2] = {-INFINITY, -INFINITY};  // raw row max, rows l/4 (+8)
    float l[2] = {0.f, 0.f};  // this thread's partial row sums
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;

    auto issue_s = [&](int j) {
      const uint32_t kt = k_addr + (j % ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = smem_desc(q_addr + kk * 32, 16, 1024);
        const uint64_t db = smem_desc(kt + kk * 32, 16, 1024);
        if (kk == 0)
          Mma<BN, T>::template run<0, 0>(s_acc, da, db);
        else
          Mma<BN, T>::template run<0, 1>(s_acc, da, db);
      }
    };
    auto issue_pv = [&](int j) {
      const uint32_t vt = v_addr + (j % ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Mma<64, T>::template run_rs<1>(
            o_acc, &pa[4 * kk], smem_desc(vt + kk * 16 * ROW, 64 * ROW, 1024));
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    // Max of tile j's logits into m, p = 2^(s c - m c) into s_acc; returns
    // the factors alpha that rescale the earlier state of the two rows.
    auto softmax = [&](int j, float (&alpha)[2]) {
      if ((j + 1) * BN > p.sk) {  // ragged last tile: drop keys past sk
        const int col0 = j * BN + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          if (col0 + 8 * (i / 4) + i % 2 >= p.sk) s_acc[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[i % 4 / 2] = fmaxf(mx[i % 4 / 2], s_acc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = ex2((m[r] - mx[r]) * c);  // 0 on the first tile
        m[r] = mx[r];  // finite: every tile has a key below sk
      }
      const float mc[2] = {m[0] * c, m[1] * c};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        s_acc[i] = ex2(fmaf(s_acc[i], c, -mc[i % 4 / 2]));
    };
    // The row sums of tile j's p: K1 sums the T values the value product
    // takes (unpacked from pa), K4/K5 the fp32 ones.
    auto pack_and_sum = [&](float (&alpha)[2]) {
      acc_to_a<T>(s_acc, pa);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        if constexpr (F32_SUM)
          sum[i % 2] += s_acc[2 * i] + s_acc[2 * i + 1];
        else
          sum[i % 2] += unpack_lo<T>(pa[i]) + unpack_hi<T>(pa[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
    };

    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s_acc);
    release(&k_empty[0]);
    {
      float alpha[2];
      softmax(0, alpha);
      pack_and_sum(alpha);
    }
    for (int j = 1; j < n_tiles; ++j) {
      const uint32_t ph = (j / ST) & 1, ph_prev = ((j - 1) / ST) & 1;
      mbar_wait(&k_full[j % ST], ph);
      mbar_wait(&v_full[(j - 1) % ST], ph_prev);
      wgmma_fence();
      issue_s(j);
      wgmma_commit();
      issue_pv(j - 1);
      wgmma_commit();
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      fence_acc(s_acc);
      release(&k_empty[j % ST]);
      float alpha[2];
      softmax(j, alpha);  // the exponentials overlap the P V product
      wgmma_wait<0>();
      fence_acc(o_acc);
      fence_regs(pa);
      release(&v_empty[(j - 1) % ST]);
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[i] *= alpha[i % 4 / 2];
      pack_and_sum(alpha);
    }
    mbar_wait(&v_full[(n_tiles - 1) % ST], ((n_tiles - 1) / ST) & 1);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(o_acc);
    fence_regs(pa);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    if (lane % 4 == 0) {
      float* lse = p.lse + (static_cast<size_t>(b) * p.h + h) * p.sq;
      if (row < p.sq) lse[row] = m[0] * SCALE + logf(l[0]);
      if (row + 8 < p.sq) lse[row + 8] = m[1] * SCALE + logf(l[1]);
    }
    // the warpgroup's own Q rows are free: all its S products are done
    uint8_t* tile = q_s + wg * 64 * ROW;
    stage_rows<T>(tile, o_acc, 1.f / l[0], 1.f / l[1]);
    store_tile(&o_map, tile, 2 + wg, h, q0 + wg * 64, b);
  }
}

template <typename T, bool F32_SUM, int NWG, int BN>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const CUtensorMap& o, const FwdParams& p, int b,
           cudaStream_t stream) {
  using C = FwdCfg<NWG, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, F32_SUM, NWG, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.sq + C::BM - 1) / C::BM, p.h, b);
  flash_fwd_kernel<T, F32_SUM, NWG, BN>
      <<<grid, C::THREADS, C::SMEM, stream>>>(q, k, v, o, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool F32_SUM>
int launch_tile(int nwg, int bn, const CUtensorMap& q, const CUtensorMap& k,
                const CUtensorMap& v, const CUtensorMap& o,
                const FwdParams& p, int b, cudaStream_t st) {
// The tiles of ops/attention.py's FWD_TILES: those its planner picks.
#define FWD_CASE(NWG, BN)                                         \
  if (nwg == NWG && bn == BN)                                     \
    return launch<T, F32_SUM, NWG, BN>(q, k, v, o, p, b, st);
  FWD_CASE(2, 128)
#undef FWD_CASE
  return ERR_PLAN;
}

template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, void* lse,
            const long long* strides, int b, int sq, int sk, int h, int nwg,
            int bn, int f32_sum, void* stream) {
  if (encode_fn() == nullptr) return ERR_NO_ENCODE;
  const Bshd qt{q, strides[0], strides[1], strides[2]};
  const Bshd kt{k, strides[3], strides[4], strides[5]};
  const Bshd vt{v, strides[6], strides[7], strides[8]};
  const Bshd ot{o, static_cast<long long>(sq) * h * D,
                static_cast<long long>(h) * D, D};
  CUtensorMap q_map, k_map, v_map, o_map;
  if (!encode_bshd<T>(&q_map, qt, b, sq, h, 64 * nwg) ||
      !encode_bshd<T>(&k_map, kt, b, sk, h, bn) ||
      !encode_bshd<T>(&v_map, vt, b, sk, h, bn) ||
      !encode_bshd<T>(&o_map, ot, b, sq, h, 64))
    return ERR_ENCODE;
  FwdParams p;
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.lse = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32_sum ? launch_tile<T, true>(nwg, bn, q_map, k_map, v_map, o_map,
                                        p, b, st)
                 : launch_tile<T, false>(nwg, bn, q_map, k_map, v_map, o_map,
                                         p, b, st);
}

}  // namespace flash

// q: [b, sq, h, 64], k, v: [b, sk, h, 64] bf16 with unit-stride last dims,
// bases and the other strides (elements: sb, ss, sh per tensor, in
// `strides` q's, k's, v's) multiples of 16 bytes; o: [b, sq, h, 64] bf16
// dense out; lse: [b*h, sq] fp32 out. f32_sum = 0: the row sum over the
// bf16-rounded p (K1); otherwise over the fp32 p (K4, K5). The tile: nwg
// consumer warpgroups (64 query rows each), bn keys a step. Returns the
// launch's cudaError_t, or 1001-1003.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const long long* strides,
                              int b, int sq, int sk, int h, int nwg, int bn,
                              int f32_sum, void* stream) {
  return flash::forward<__nv_bfloat16>(q, k, v, o, lse, strides, b, sq, sk,
                                       h, nwg, bn, f32_sum, stream);
}

// flash_fwd_bf16 with q, k, v and o in fp16 (p rounded to fp16)
extern "C" int flash_fwd_f16(const void* q, const void* k, const void* v,
                             void* o, void* lse, const long long* strides,
                             int b, int sq, int sk, int h, int nwg, int bn,
                             int f32_sum, void* stream) {
  return flash::forward<__half>(q, k, v, o, lse, strides, b, sq, sk, h, nwg,
                                bn, f32_sum, stream);
}
