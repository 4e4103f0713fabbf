// Flash-attention backward for Hopper (sm_90a): dq, dk, dv from q, k, v,
// the forward's output O and row log-sum-exp, and dO; q has sq rows, k and
// v sk rows. One entry launches three kernels on the caller's stream.
//
// Replaces the JAX package's ops/attention.py:_flash_bwd_fused_kernel (K2,
// launched by _flash_bwd_fused_impl). That kernel loops over query blocks
// per KV block and ADDS each block's dq contribution into one fp32 buffer
// across KV grid steps, which is sound only because a TPU core runs the grid
// in order. CTAs on Hopper run concurrently, so this file splits the work
// the deterministic FlashAttention-2 way, with no atomics and no fp32 dq
// scratch:
//   flash_bwd_prologue_kernel: delta = rowsum(dO * O) in fp32, read from O
//     and dO in place, and lse, both copied into [B*H, sqp] rows padded to
//     a multiple of 128 (lse +inf, delta 0 past sq, so that p = 0 there);
//   flash_bwd_dkdv_kernel: one CTA per (batch, head, 128-row KV tile), K and
//     V resident in shared memory, Q/dO tiles of 64 rows streamed; dk and dv
//     stay in registers;
//   flash_bwd_dq_kernel: one CTA per (batch, head, 128-row query tile), Q
//     and dO resident, K/V tiles of 64 rows streamed; dq stays in registers.
// Both recompute p = exp(s - lse). The arithmetic is the TPU kernel's:
// fp32 logits and p, dv += bf16(p)^T dO, dp = dO V^T in fp32,
// ds = bf16(p * (dp - delta)), dk += ds^T q, dq += ds k in fp32, then
// dq * 1/sqrt(d) rounded once to bf16. The 1/sqrt(64) scale is applied to
// the fp32 logits and to dk (flash_common.cuh: SCALE, exact), not to a
// pre-scaled copy of q.
//
// The same kernels are the JAX package's two-pass backward (K3,
// _flash_bwd_dq_kernel + _flash_bwd_dkv_kernel, launched by _flash_bwd_impl),
// which stores dq in bf16 before the 1/sqrt(d) scale: at d = 64 that scale
// is 1/8, exact in bf16, so the two roundings agree with this one. And they
// are its delta-folded backward (K6, _flash_bwd_fused_fold_kernel), which
// adds -delta as a bf16 hi/lo pair inside the dp product: with `fold` the
// prologue stores delta = -(f32(d_hi) + f32(d_lo)) of that pair, the same
// function up to fp32 summation order.
//
// Bound: the tensor cores, like the forward (10*sq*sk*64 flops per head
// for the function's five products). The two-kernel split costs seven
// products and the exponentials twice: ~76 us of products at
// [1,4096,5,64], against 54 us for five; it buys determinism with no
// ordering between CTAs. The design of both main kernels is the forward's:
// a producer warpgroup whose first thread streams tiles by TMA into a ring
// of mbarrier-tracked stages, two consumer warpgroups (64 rows each) on
// wgmma with setmaxnreg, products whose A is a probability or gradient
// tile go from registers (hopper.cuh: acc_to_a). In the dk/dv kernel
// S^T = K Q^T and dP^T = V dO^T are SS products, dV += P^T dO and
// dK += dS^T Q RS products with dO and Q read MN-major; in the dq kernel
// S = Q K^T and dP = dO V^T are SS, dQ += dS K RS with K read MN-major. The
// exponentials of a tile run while its dP product is on the tensor cores.
#include "flash_common.cuh"

namespace flash {

constexpr int NWG = 2;              // consumer warpgroups of both kernels
constexpr int BM = 64 * NWG;        // rows a CTA owns
constexpr int BS = 64;              // rows of a streamed tile
constexpr int TILE = BS * ROW;      // bytes of one streamed 64-row tile
constexpr int STAGES = 3;
constexpr int THREADS = 128 * (NWG + 1);
constexpr int PAD = 128;            // multiple the padded rows round up to

struct BwdParams {
  int h, sq, sk, sqp;    // heads, rows, padded query rows
  const float* lse;      // [B*H, sqp], +inf past sq
  const float* delta;    // [B*H, sqp], 0 past sq
};

// ---------------------------------------------------------------------------
// Prologue: delta, and lse padded
// ---------------------------------------------------------------------------

constexpr int PRO_THREADS = 256;  // 8 threads (16 bytes each) per row

template <typename T>
__global__ void __launch_bounds__(PRO_THREADS)
    flash_bwd_prologue_kernel(Bshd o, Bshd dout, const float* __restrict__ lse,
                              float* __restrict__ lse_pad,
                              float* __restrict__ delta_pad, int h, int sq,
                              int sqp, long long rows, int fold) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * PRO_THREADS + threadIdx.x) / 8;
  const int part = threadIdx.x % 8;
  // rows is a multiple of 128, so the grid holds no thread past it and
  // every warp takes part in the shuffles whole
  const long long bh = row / sqp;
  const int s = static_cast<int>(row - bh * sqp);
  const int b = static_cast<int>(bh / h), hh = static_cast<int>(bh % h);
  float acc = 0.f;
  if (s < sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(o.ptr) + b * o.sb + s * o.ss +
        hh * o.sh + part * 8);
    const uint4 dv = *reinterpret_cast<const uint4*>(
        static_cast<const T*>(dout.ptr) + b * dout.sb +
        s * dout.ss + hh * dout.sh + part * 8);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
    const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc += unpack_lo<T>(ow[i]) * unpack_lo<T>(dw[i]) +
             unpack_hi<T>(ow[i]) * unpack_hi<T>(dw[i]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (part != 0) return;
  if (s >= sq) {
    lse_pad[row] = INFINITY;
    delta_pad[row] = 0.f;
    return;
  }
  if (fold) {  // K6: -delta as the T hi/lo pair it adds to dp
    const uint32_t hi = pack<T>(-acc, 0.f);
    const uint32_t lo = pack<T>(-acc - unpack_lo<T>(hi), 0.f);
    acc = -(unpack_lo<T>(hi) + unpack_lo<T>(lo));
  }
  lse_pad[row] = lse[bh * sq + s];
  delta_pad[row] = acc;
}

// ---------------------------------------------------------------------------
// Shared pieces of the two main kernels
// ---------------------------------------------------------------------------

// A resident tile of BM rows: two 64-row boxes.
__device__ __forceinline__ void load_resident(uint8_t* dst,
                                              const CUtensorMap* map,
                                              uint64_t* bar, int h, int row0,
                                              int b) {
  tma_load_4d(dst, map, bar, 0, h, row0, b);
  tma_load_4d(dst + TILE, map, bar, 0, h, row0 + BS, b);
}

// d[64 x 64] = A[64 x 64] . B^T with A (rows of the warpgroup) and B (a
// 64-row tile) K-major in shared memory.
template <typename T>
__device__ __forceinline__ void mma_abt(float (&d)[32], uint32_t a,
                                        uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = smem_desc(a + kk * 32, 16, 1024);
    const uint64_t db = smem_desc(bt + kk * 32, 16, 1024);
    if (kk == 0)
      Mma<64, T>::template run<0, 0>(d, da, db);
    else
      Mma<64, T>::template run<0, 1>(d, da, db);
  }
}

// d[64 x 64] += A[64 x 64] . B with A in registers (acc_to_a of a 64-column
// accumulator) and B a 64-row tile read MN-major.
template <typename T>
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[16],
                                       uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk)
    Mma<64, T>::template run_rs<1>(d, &a[4 * kk], smem_desc(bt + kk * 16 * ROW, 64 * ROW,
                                                1024));
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

// Stage: Q tile, dO tile, then 64 lse and 64 delta values.
constexpr int KV_STAGE = 2 * TILE + 1024;
constexpr int KV_SMEM = 1024 + 2 * BM * ROW + STAGES * KV_STAGE + 256;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const __grid_constant__ CUtensorMap dk_map,
                          const __grid_constant__ CUtensorMap dv_map,
                          const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + BM * ROW;
  uint8_t* ring = v_s + BM * ROW;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + STAGES * KV_STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int kv0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.h + h;
  const int n_tiles = (p.sq + BS - 1) / BS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NWG * 128) {
      prefetch_map(&q_map);
      prefetch_map(&do_map);
      mbar_expect_tx(kv_full, 2 * BM * ROW);
      load_resident(k_s, &k_map, kv_full, h, kv0, b);
      load_resident(v_s, &v_map, kv_full, h, kv0, b);
      const float* lse = p.lse + static_cast<size_t>(bh) * p.sqp;
      const float* delta = p.delta + static_cast<size_t>(bh) * p.sqp;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * KV_STAGE;
        mbar_expect_tx(&full[s], 2 * TILE + 2 * BS * 4);
        tma_load_4d(st, &q_map, &full[s], 0, h, j * BS, b);
        tma_load_4d(st + TILE, &do_map, &full[s], 0, h, j * BS, b);
        bulk_load(st + 2 * TILE, lse + j * BS, BS * 4, &full[s]);
        bulk_load(st + 2 * TILE + BS * 4, delta + j * BS, BS * 4, &full[s]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    const uint32_t k_addr = smem_u32(k_s) + wg * 64 * ROW;
    const uint32_t v_addr = smem_u32(v_s) + wg * 64 * ROW;
    const uint32_t ring_addr = smem_u32(ring);
    constexpr float c = SCALE * LOG2E;

    // S^T and dP^T (rows: keys, columns: queries); P^T in fp32. p and ds
    // go to registers of their own, not back into an accumulator, so that
    // no instruction writes a wgmma accumulator while another product of
    // the warpgroup is in flight (ptxas would serialize the products).
    float st_acc[32], dpt_acc[32], pt[32];
    float dk_acc[32], dv_acc[32];
    uint32_t pa[16], dsa[16];  // bf16 P^T and dS^T (A operands)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) pa[i] = dsa[i] = 0u;

    mbar_wait(kv_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t q_t = ring_addr + s * KV_STAGE, do_t = q_t + TILE;
      const float* stats =
          reinterpret_cast<const float*>(ring + s * KV_STAGE + 2 * TILE);
      mbar_wait(&full[s], (j / STAGES) & 1);
      wgmma_fence();
      mma_abt<T>(st_acc, k_addr, q_t);
      wgmma_commit();
      mma_abt<T>(dpt_acc, v_addr, do_t);
      wgmma_commit();
      wgmma_wait<1>();  // S^T and the previous tile's dV, dK are done
      fence_acc(st_acc);
      fence_acc(dk_acc);
      fence_acc(dv_acc);
      fence_regs(pa);
      fence_regs(dsa);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
      // column (query) of accumulator i: 8 (i / 4) + 2 (lane % 4) + i % 2
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float lse2 = stats[8 * (i / 4) + 2 * (lane % 4) + i % 2] * LOG2E;
        pt[i] = ex2(fmaf(st_acc[i], c, -lse2));
      }
      acc_to_a<T>(pt, pa);
      wgmma_fence();
      mma_rs<T>(dv_acc, pa, do_t);  // dV += P^T dO
      wgmma_commit();
      wgmma_wait<1>();  // dP^T is done
      fence_acc(dpt_acc);
      // delta of columns 8 (i / 2) + 2 (lane % 4) + {0, 1}
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float2 dl = *reinterpret_cast<const float2*>(
            stats + BS + 8 * (i / 2) + 2 * (lane % 4));
        dsa[i] = pack<T>(pt[2 * i] * (dpt_acc[2 * i] - dl.x),
                           pt[2 * i + 1] * (dpt_acc[2 * i + 1] - dl.y));
      }
      wgmma_fence();
      mma_rs<T>(dk_acc, dsa, q_t);  // dK += dS^T Q
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(dk_acc);
    fence_acc(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);

    // the warpgroup's own K and V rows are free: its products are done
    uint8_t* dk_t = k_s + wg * 64 * ROW;
    uint8_t* dv_t = v_s + wg * 64 * ROW;
    stage_rows<T>(dk_t, dk_acc, SCALE, SCALE);
    stage_rows<T>(dv_t, dv_acc, 1.f, 1.f);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(2 + wg, 128);
    if (threadIdx.x % 128 == 0) {
      tma_store_4d(&dk_map, dk_t, 0, h, kv0 + wg * 64, b);
      tma_store_4d(&dv_map, dv_t, 0, h, kv0 + wg * 64, b);
    }
  }
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

// Stage: K tile, V tile.
constexpr int Q_STAGE = 2 * TILE;
constexpr int Q_SMEM = 1024 + 2 * BM * ROW + STAGES * Q_STAGE + 256;

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map,
                        const __grid_constant__ CUtensorMap dq_map,
                        const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + BM * ROW;
  uint8_t* ring = do_s + BM * ROW;
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(ring + STAGES * Q_STAGE);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (p.sk + BS - 1) / BS;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == NWG * 128) {
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      mbar_expect_tx(qdo_full, 2 * BM * ROW);
      load_resident(q_s, &q_map, qdo_full, h, q0, b);
      load_resident(do_s, &do_map, qdo_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
        uint8_t* st = ring + s * Q_STAGE;
        mbar_expect_tx(&full[s], 2 * TILE);
        tma_load_4d(st, &k_map, &full[s], 0, h, j * BS, b);
        tma_load_4d(st + TILE, &v_map, &full[s], 0, h, j * BS, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lane = threadIdx.x % 32;
    const uint32_t q_addr = smem_u32(q_s) + wg * 64 * ROW;
    const uint32_t do_addr = smem_u32(do_s) + wg * 64 * ROW;
    const uint32_t ring_addr = smem_u32(ring);
    constexpr float c = SCALE * LOG2E;
    // rows l/4 and l/4 + 8 of this warp: their lse (log2 units) and delta
    const int row = q0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const size_t base = static_cast<size_t>(b * p.h + h) * p.sqp;
    const float lse2[2] = {p.lse[base + row] * LOG2E,
                           p.lse[base + row + 8] * LOG2E};
    const float dl[2] = {p.delta[base + row], p.delta[base + row + 8]};

    // p goes to registers of its own and ds straight to its bf16 pairs, as
    // in the dk/dv kernel
    float s_acc[32], dp_acc[32], dq_acc[32], pr[32];
    uint32_t dsa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dsa[i] = 0u;

    mbar_wait(qdo_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t k_t = ring_addr + s * Q_STAGE, v_t = k_t + TILE;
      mbar_wait(&full[s], (j / STAGES) & 1);
      wgmma_fence();
      mma_abt<T>(s_acc, q_addr, k_t);
      wgmma_commit();
      mma_abt<T>(dp_acc, do_addr, v_t);
      wgmma_commit();
      wgmma_wait<1>();  // S and the previous tile's dQ are done
      fence_acc(s_acc);
      fence_acc(dq_acc);
      fence_regs(dsa);
      if (j > 0 && lane == 0) mbar_arrive(&empty[(j - 1) % STAGES]);
      const int col0 = j * BS + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        // keys past sk (TMA's zero rows of K) get p = 0
        const bool in = col0 + 8 * (i / 4) + i % 2 < p.sk;
        pr[i] = in ? ex2(fmaf(s_acc[i], c, -lse2[i % 4 / 2])) : 0.f;
      }
      wgmma_wait<0>();  // dP is done
      fence_acc(dp_acc);
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dsa[i] = pack<T>(pr[2 * i] * (dp_acc[2 * i] - dl[i % 2]),
                           pr[2 * i + 1] * (dp_acc[2 * i + 1] - dl[i % 2]));
      wgmma_fence();
      mma_rs<T>(dq_acc, dsa, k_t);  // dQ += dS K
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(dq_acc);
    fence_regs(dsa);

    uint8_t* tile = q_s + wg * 64 * ROW;
    stage_rows<T>(tile, dq_acc, SCALE, SCALE);
    store_tile(&dq_map, tile, 2 + wg, h, q0 + wg * 64, b);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dq, void* dk, void* dv,
             void* scratch, const long long* strides, int b, int sq, int sk,
             int h, int fold, void* stream) {
  if (encode_fn() == nullptr) return ERR_NO_ENCODE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bshd qt{q, strides[0], strides[1], strides[2]};
  const Bshd kt{k, strides[3], strides[4], strides[5]};
  const Bshd vt{v, strides[6], strides[7], strides[8]};
  const Bshd ot{o, strides[9], strides[10], strides[11]};
  const Bshd dot{dout, strides[12], strides[13], strides[14]};
  const long long hd = static_cast<long long>(h) * D;
  const Bshd dqt{dq, sq * hd, hd, D};
  const Bshd dkt{dk, sk * hd, hd, D}, dvt{dv, sk * hd, hd, D};
  CUtensorMap q_map, k_map, v_map, do_map, dq_map, dk_map, dv_map;
  if (!encode_bshd<T>(&q_map, qt, b, sq, h, BS) ||
      !encode_bshd<T>(&k_map, kt, b, sk, h, BS) ||
      !encode_bshd<T>(&v_map, vt, b, sk, h, BS) ||
      !encode_bshd<T>(&do_map, dot, b, sq, h, BS) ||
      !encode_bshd<T>(&dq_map, dqt, b, sq, h, BS) ||
      !encode_bshd<T>(&dk_map, dkt, b, sk, h, BS) ||
      !encode_bshd<T>(&dv_map, dvt, b, sk, h, BS))
    return ERR_ENCODE;

  BwdParams p;
  p.h = h;
  p.sq = sq;
  p.sk = sk;
  p.sqp = (sq + PAD - 1) / PAD * PAD;
  float* lse_pad = static_cast<float*>(scratch);
  float* delta_pad = lse_pad + static_cast<size_t>(b) * h * p.sqp;
  p.lse = lse_pad;
  p.delta = delta_pad;

  const long long rows = static_cast<long long>(b) * h * p.sqp;
  flash_bwd_prologue_kernel<T><<<static_cast<unsigned>(
                                  (rows * 8 + PRO_THREADS - 1) / PRO_THREADS),
                              PRO_THREADS, 0, st>>>(
      ot, dot, static_cast<const float*>(lse), lse_pad, delta_pad, h, sq,
      p.sqp, rows, fold);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  static const cudaError_t attr_kv =
      allow_smem(flash_bwd_dkdv_kernel<T>, KV_SMEM);
  static const cudaError_t attr_q = allow_smem(flash_bwd_dq_kernel<T>, Q_SMEM);
  if (attr_kv != cudaSuccess) return static_cast<int>(attr_kv);
  if (attr_q != cudaSuccess) return static_cast<int>(attr_q);
  flash_bwd_dkdv_kernel<T><<<dim3((sk + BM - 1) / BM, h, b), THREADS, KV_SMEM,
                          st>>>(q_map, k_map, v_map, do_map, dk_map, dv_map,
                                p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T><<<dim3((sq + BM - 1) / BM, h, b), THREADS, Q_SMEM,
                        st>>>(q_map, k_map, v_map, do_map, dq_map, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash

// q, dout, dq: [b, sq, h, 64]; k, v, dk, dv: [b, sk, h, 64]; o: [b, sq, h,
// 64]; all bf16 with unit-stride last dims, bases and the other strides
// multiples of 16 bytes (elements, sb/ss/sh per tensor, in `strides`: q's,
// k's, v's, o's, dout's); dq, dk, dv are written dense. lse: [b*h, sq]
// fp32; scratch: 2 * b*h * sqp fp32 with sqp = sq rounded up to 128.
// fold != 0: delta from K6's bf16 hi/lo pair. Returns the first launch
// error (cudaError_t), or 1001-1002; 0 when all three were accepted.
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* scratch, const long long* strides, int b,
                              int sq, int sk, int h, int fold, void* stream) {
  return flash::backward<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv,
                                        scratch, strides, b, sq, sk, h, fold,
                                        stream);
}

// flash_bwd_bf16 with q, k, v, o, dout, dq, dk, dv in fp16 (p and dS
// rounded to fp16; K6's pair of fp16)
extern "C" int flash_bwd_f16(const void* q, const void* k, const void* v,
                             const void* o, const void* dout,
                             const void* lse, void* dq, void* dk, void* dv,
                             void* scratch, const long long* strides, int b,
                             int sq, int sk, int h, int fold, void* stream) {
  return flash::backward<__half>(q, k, v, o, dout, lse, dq, dk, dv, scratch,
                                 strides, b, sq, sk, h, fold, stream);
}
