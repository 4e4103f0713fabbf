// 3x3 SAME stride-1 conv forward and input gradient for Hopper (sm_90a):
// channels-last (NHWC) bf16 activations, the weight held channels-last
// ([Co][3][3][Ci] in memory, PyTorch's torch.channels_last of [Co, Ci, 3, 3]),
// fp32 accumulation, bf16 output. No bias: the caller adds it outside.
//
// Replaces the JAX package's ops/conv.py:_conv3_kernel (launched by
// _conv3x3_pallas for the forward of conv3x3 and, with the flipped,
// in/out-transposed kernel, for its input gradient). That kernel holds a
// whole padded NHWC image in VMEM so each of the nine taps is one shifted
// slice fed to the MXU. Here the conv is an implicit GEMM whose operands
// the Tensor Memory Accelerator (TMA) cuts straight from the tensors:
//   forward: M = B*H*W output pixels, N = Co, K = 9*Ci;
//   dx:      M = B*H*W input pixels,  N = Ci, K = 9*Co (dy in place of x,
//            B[(t, co)][ci] = w[co][8 - t][ci]: the flipped, transposed
//            kernel as a tensor-map coordinate and wgmma's transpose flag).
// K is ordered (tap, channel), channel fastest, 64 channels a step: one
// 128-byte row, the span of the 128-byte swizzle that wgmma reads.
//
// A CTA's M tile is a BB x BH x BW box of pixels (BW a row segment, BH rows,
// BB whole images when a tile spans more than one), 64 per consumer
// warpgroup. For tap (di, dj) and channel chunk c0 its A tile is ONE TMA box
// of the NHWC activation [B][H][W][C] at (c0, ow0 + dj - 1, oh0 + di - 1,
// b0): TMA's zero fill of out-of-range coordinates is the halo, so there is
// no padded copy and no wrap-around column. B is one box of the weight
// viewed as [Co][9][Ci]: (64 ci, 1, BN co) at (c0, t, n0) forward, K-major;
// for dx ceil(BN / 64) boxes (64 ci, 1, 64 co) at (n0 + 64 j, 8 - t, c0),
// MN-major. The same weight tensor serves both directions; nothing copies
// or transposes it per call.
//
// Bound on this card: 2*B*H*W*9*Ci*Co operations against the weight's
// 18*Ci*Co bytes plus the activations'. At 64x64 and 32x32 the operations
// bound it (64x64 320->320: 7.5 GFLOP, 7.6 us at 989 TFLOP/s); at 16x16 and
// 8x8 the weight stream does (8x8 2560->1280: 59 MB, 17.6 us at 3.35 TB/s
// against 3.8 us of operations), and a 64-pixel M tile there leaves most
// SMs idle. The design:
//   - one producer warp keeps a ring of STAGES (A, B) tiles in flight with
//     TMA and mbarriers; one or two consumer warpgroups run wgmma
//     m64nBNk16 from shared memory with one group in flight, so copies
//     overlap the tensor cores; setmaxnreg moves registers to the consumers;
//   - split-K where the grid is short: S CTAs each take a contiguous range
//     of the K steps, write fp32 partials, and a second pass sums them in a
//     fixed order and rounds once to bf16 (deterministic, no atomics). That
//     spreads the weight stream over all SMs at 8x8 and 16x16;
//   - the epilogue stages the bf16 tile in shared memory and writes it with
//     one TMA store (clipped at the ragged edges).
// The tile (consumer warpgroups, BN, the pixel box) and S come from the
// planner in ops/conv.py (plan_conv3x3); this file only checks them.
//
// What this kernel is not built for (fp32 or fp16 activations, channel
// counts that are not multiples of 8) runs conv_general.cu's kernel.
//
// The fused GroupNorm+SiLU+conv kernels (gn_conv.cu, K9) run this GEMM
// through run() (conv.cuh): the forward on their normalized activation,
// dx with fp32 output (every split writes partials, none are summed here)
// so that their own epilogue pass sums the splits.
#include <cstdint>

#include "conv.cuh"
#include "hopper.cuh"

namespace conv {

using namespace hopper;

constexpr int KC = 64;         // channels of one K step
constexpr int ROW = KC * 2;    // bytes of one shared-memory row (128B swizzle)
constexpr int SMEM_BUDGET = 227 * 1024;
constexpr int MAX_STAGES = 8;

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

struct Params {
  int b, h, w;          // images
  int kch, nch;         // channels along K and along N
  int bw, bh, bb;       // the M tile's pixel box (bw * bh * bb = 64 * NWG)
  int tiles_w, tiles_h; // M tiles across W and across H
  int c_steps;          // channel chunks of 64 along K (K steps = 9 * this)
  int splits;           // K ranges (grid z)
  float* part;          // [splits][B*H*W][nch] fp32 partials, or null: bf16
};

template <bool DX, int NWG, int BN>
struct Cfg {
  static constexpr int BM = 64 * NWG;
  static constexpr int B_BOXES = DX ? (BN + 63) / 64 : 1;
  static constexpr int B_ROWS = DX ? 64 * B_BOXES : BN;
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE_BYTES = (BM + B_ROWS) * ROW;
  static constexpr int FIT = (SMEM_BUDGET - 1024 - 256) / STAGE_BYTES;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  // 1024 of slack to align the base for the swizzle, then the barriers
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 256;
  static constexpr int THREADS = 128 * (NWG + 1);
  static_assert(STAGES >= 3, "too few pipeline stages");
  static_assert(BM * BN * 2 <= STAGES * STAGE_BYTES, "epilogue tile");
};

// T: the activations' and weight's type, bf16 or fp16
template <typename T, bool DX, int NWG, int BN>
__global__ void __launch_bounds__(Cfg<DX, NWG, BN>::THREADS, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap act_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const __grid_constant__ CUtensorMap out_map,
                   const Params p) {
  using C = Cfg<DX, NWG, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::STAGES *
                                               C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int tile = blockIdx.x;
  const int ow0 = tile % p.tiles_w * p.bw;
  const int oh0 = tile / p.tiles_w % p.tiles_h * p.bh;
  const int b0 = tile / (p.tiles_w * p.tiles_h) * p.bb;
  const int n0 = blockIdx.y * BN;
  const int k_steps = 9 * p.c_steps;
  const int step0 = static_cast<int>(
      static_cast<long long>(blockIdx.z) * k_steps / p.splits);
  const int nsteps = static_cast<int>(
      static_cast<long long>(blockIdx.z + 1) * k_steps / p.splits) - step0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
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
      prefetch_map(&act_map);
      prefetch_map(&w_map);
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(&empty[s], ((i / C::STAGES) & 1) ^ 1);
        uint8_t* a = smem + s * C::STAGE_BYTES;
        uint8_t* bt = a + C::A_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        const int k = step0 + i;
        const int tap = k / p.c_steps;
        const int c0 = (k - tap * p.c_steps) * KC;
        const int di = tap / 3, dj = tap - 3 * (tap / 3);
        tma_load_4d(a, &act_map, &full[s], c0, ow0 + dj - 1, oh0 + di - 1,
                    b0);
        if constexpr (!DX) {
          tma_load_3d(bt, &w_map, &full[s], c0, tap, n0);
        } else {
#pragma unroll
          for (int j = 0; j < C::B_BOXES; ++j)
            tma_load_3d(bt + j * 64 * ROW, &w_map, &full[s], n0 + 64 * j,
                        8 - tap, c0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of the tile
    if constexpr (NWG == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    const int lane = threadIdx.x % 32;
    const uint32_t base = smem_u32(smem);

    for (int i = 0; i < nsteps; ++i) {
      const int s = i % C::STAGES;
      mbar_wait(&full[s], (i / C::STAGES) & 1);
      const uint32_t a_addr = base + s * C::STAGE_BYTES + wg * 64 * ROW;
      const uint32_t b_addr = base + s * C::STAGE_BYTES + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        // A, K-major: 8-row groups 1024 B apart, k16 slices 32 B apart
        const uint64_t da = smem_desc(a_addr + kk * 32, 16, 1024);
        if constexpr (!DX) {
          const uint64_t db = smem_desc(b_addr + kk * 32, 16, 1024);
          Mma<BN, T>::template run<0>(acc, da, db);
        } else {
          // B, MN-major: 64-channel column blocks 64 rows apart (LBO),
          // 8-row groups of K 1024 B apart (SBO), k16 slices 16 rows apart
          const uint64_t db =
              smem_desc(b_addr + kk * 16 * ROW, 64 * ROW, 1024);
          Mma<BN, T>::template run<1>(acc, da, db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Accumulator i of thread t (warp wq of the warpgroup) holds row
    // 16 wq + t%32/4 + 8 (i%4/2), columns 8 (i/4) + 2 (t%4) + {0, 1}.
    const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int c0 = 2 * (lane % 4);
    if (p.part == nullptr) {
      // T tile [BM][BN] over the drained stages, then one TMA store
      consumers_sync(NWG * 128);
      T* st = reinterpret_cast<T*>(smem);
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int r = r0 + 8 * ((i % 4) / 2);
        const int c = 8 * (i / 4) + c0;
        *reinterpret_cast<uint32_t*>(st + r * BN + c) =
            pack<T>(acc[i], acc[i + 1]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumers_sync(NWG * 128);
      if (threadIdx.x == 0) tma_store_4d(&out_map, st, n0, ow0, oh0, b0);
    } else {
      float* part = p.part + static_cast<size_t>(blockIdx.z) * p.b * p.h *
                                 p.w * p.nch;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half;
        const int ww = ow0 + r % p.bw;
        const int hh = oh0 + r / p.bw % p.bh;
        const int bi = b0 + r / (p.bw * p.bh);
        if (ww >= p.w || hh >= p.h || bi >= p.b) continue;
        float* row = part + ((static_cast<size_t>(bi) * p.h + hh) * p.w +
                             ww) * p.nch;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int n = n0 + 8 * j + c0;
          if (n < p.nch)
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
        }
      }
    }
  }
}

// out[e] = T(sum over s of part[s][e]), s in order; 8 elements a thread.
template <typename T>
__global__ void __launch_bounds__(256)
    splitk_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                      long long n8, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n8) return;
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  for (int s = 0; s < splits; ++s) {
    const float4* src =
        reinterpret_cast<const float4*>(part + s * n8 * 8) + 2 * i;
    const float4 a = src[0], b = src[1];
    lo.x += a.x; lo.y += a.y; lo.z += a.z; lo.w += a.w;
    hi.x += b.x; hi.y += b.y; hi.z += b.z; hi.w += b.w;
  }
  reinterpret_cast<uint4*>(out)[i] =
      make_uint4(pack<T>(lo.x, lo.y), pack<T>(lo.z, lo.w),
                 pack<T>(hi.x, hi.y), pack<T>(hi.z, hi.w));
}

// ---------------------------------------------------------------------------
// Host side: tensor maps and launches
// ---------------------------------------------------------------------------

// A T tensor map over `rank` dims (innermost first) of a dense tensor.
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint32_t* box, bool swizzle) {
  cuuint64_t strides[4];
  cuuint64_t bytes = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode_fn()(map, tma_type<T>(), rank,
                     const_cast<void*>(ptr), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool DX, int NWG, int BN>
int launch(const CUtensorMap& act, const CUtensorMap& wmap,
           const CUtensorMap& out, const Params& p, dim3 grid,
           cudaStream_t stream) {
  using C = Cfg<DX, NWG, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv3x3_kernel<T, DX, NWG, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  conv3x3_kernel<T, DX, NWG, BN>
      <<<grid, C::THREADS, C::SMEM, stream>>>(act, wmap, out, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DX>
int launch_tile(int nwg, int bn, const CUtensorMap& act,
                const CUtensorMap& wmap, const CUtensorMap& out,
                const Params& p, dim3 grid, cudaStream_t st) {
// The tiles of ops/conv.py's TILES: those its planner picks.
#define CONV_CASE(NWG, BN)                                        \
  if (nwg == NWG && bn == BN)                                     \
    return launch<T, DX, NWG, BN>(act, wmap, out, p, grid, st);
  CONV_CASE(1, 64) CONV_CASE(1, 160)
  CONV_CASE(2, 128) CONV_CASE(2, 160) CONV_CASE(2, 256)
#undef CONV_CASE
  return ERR_PLAN;
}

template <typename T>
int run(bool dx, const void* src, const void* w, void* out, float* part,
        bool f32_out, int b, int h, int wd, int ci, int co, int nwg, int bn,
        int bw, int bh, int bb, int splits, cudaStream_t st) {
  if (encode_fn() == nullptr) return ERR_NO_ENCODE;
  const bool partials = f32_out || splits > 1;
  if (bw * bh * bb != 64 * nwg || splits < 1 || (partials && !part) ||
      (!f32_out && !out))
    return ERR_PLAN;
  const int kch = dx ? co : ci, nch = dx ? ci : co;
  CUtensorMap act_map, w_map, out_map;
  const cuuint64_t act_dims[4] = {cuuint64_t(kch), cuuint64_t(wd),
                                  cuuint64_t(h), cuuint64_t(b)};
  const cuuint32_t act_box[4] = {KC, cuuint32_t(bw), cuuint32_t(bh),
                                 cuuint32_t(bb)};
  const cuuint64_t w_dims[3] = {cuuint64_t(ci), 9, cuuint64_t(co)};
  const cuuint32_t w_box[3] = {KC, 1, dx ? cuuint32_t(KC) : cuuint32_t(bn)};
  const cuuint64_t out_dims[4] = {cuuint64_t(nch), cuuint64_t(wd),
                                  cuuint64_t(h), cuuint64_t(b)};
  const cuuint32_t out_box[4] = {cuuint32_t(bn), cuuint32_t(bw),
                                 cuuint32_t(bh), cuuint32_t(bb)};
  out_map = CUtensorMap{};  // unread when the output is fp32 partials
  if (!encode<T>(&act_map, src, 4, act_dims, act_box, true) ||
      !encode<T>(&w_map, w, 3, w_dims, w_box, true) ||
      (!f32_out && !encode<T>(&out_map, out, 4, out_dims, out_box, false)))
    return ERR_ENCODE;

  Params p;
  p.b = b; p.h = h; p.w = wd;
  p.kch = kch; p.nch = nch;
  p.bw = bw; p.bh = bh; p.bb = bb;
  p.tiles_w = (wd + bw - 1) / bw;
  p.tiles_h = (h + bh - 1) / bh;
  p.c_steps = (kch + KC - 1) / KC;
  p.splits = splits;
  p.part = partials ? part : nullptr;
  const dim3 grid(p.tiles_w * p.tiles_h * ((b + bb - 1) / bb),
                  (nch + bn - 1) / bn, splits);
  const int err = dx ? launch_tile<T, true>(nwg, bn, act_map, w_map,
                                            out_map, p, grid, st)
                     : launch_tile<T, false>(nwg, bn, act_map, w_map,
                                             out_map, p, grid, st);
  if (err != 0 || f32_out || splits == 1) return err;
  const long long n8 = static_cast<long long>(b) * h * wd * nch / 8;
  splitk_sum_kernel<T>
      <<<static_cast<unsigned>((n8 + 255) / 256), 256, 0, st>>>(
          part, static_cast<T*>(out), n8, splits);
  return static_cast<int>(cudaGetLastError());
}

template int run<__nv_bfloat16>(bool, const void*, const void*, void*,
                                float*, bool, int, int, int, int, int, int,
                                int, int, int, int, int, cudaStream_t);
template int run<__half>(bool, const void*, const void*, void*, float*, bool,
                         int, int, int, int, int, int, int, int, int, int,
                         int, cudaStream_t);

}  // namespace conv

// x: [b, h, wd, ci] bf16 (NHWC), w: [co, 3, 3, ci] bf16 (PyTorch's
// channels-last [co, ci, 3, 3]), y: [b, h, wd, co] bf16 out; all dense and
// 16-byte aligned, ci and co multiples of 8. The plan: nwg consumer
// warpgroups, N tile bn, pixel box bw x bh x bb (bw * bh * bb = 64 nwg),
// splits K ranges; part is fp32 scratch of splits * b * h * wd * co values
// when splits > 1. Returns the launch's cudaError_t, or 1001-1003.
extern "C" int conv3x3_fwd_bf16(const void* x, const void* w, void* y,
                                void* part, int b, int h, int wd, int ci,
                                int co, int nwg, int bn, int bw, int bh,
                                int bb, int splits, void* stream) {
  return conv::run<__nv_bfloat16>(false, x, w, y, static_cast<float*>(part),
                                  false, b, h, wd, ci, co, nwg, bn, bw, bh,
                                  bb, splits,
                                  static_cast<cudaStream_t>(stream));
}

// dy: [b, h, wd, co] bf16 (NHWC), w as conv3x3_fwd_bf16, dx: [b, h, wd, ci]
// bf16 out; part holds splits * b * h * wd * ci fp32 values when splits > 1.
extern "C" int conv3x3_dx_bf16(const void* dy, const void* w, void* dx,
                               void* part, int b, int h, int wd, int ci,
                               int co, int nwg, int bn, int bw, int bh,
                               int bb, int splits, void* stream) {
  return conv::run<__nv_bfloat16>(true, dy, w, dx, static_cast<float*>(part),
                                  false, b, h, wd, ci, co, nwg, bn, bw, bh,
                                  bb, splits,
                                  static_cast<cudaStream_t>(stream));
}

// The fp16 instances: conv3x3_fwd_bf16 and conv3x3_dx_bf16 with every
// tensor but part in fp16 (wgmma's f16 products, fp16 tensor maps).
extern "C" int conv3x3_fwd_f16(const void* x, const void* w, void* y,
                               void* part, int b, int h, int wd, int ci,
                               int co, int nwg, int bn, int bw, int bh,
                               int bb, int splits, void* stream) {
  return conv::run<__half>(false, x, w, y, static_cast<float*>(part), false,
                           b, h, wd, ci, co, nwg, bn, bw, bh, bb, splits,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int conv3x3_dx_f16(const void* dy, const void* w, void* dx,
                              void* part, int b, int h, int wd, int ci,
                              int co, int nwg, int bn, int bw, int bh,
                              int bb, int splits, void* stream) {
  return conv::run<__half>(true, dy, w, dx, static_cast<float*>(part), false,
                           b, h, wd, ci, co, nwg, bn, bw, bh, bb, splits,
                           static_cast<cudaStream_t>(stream));
}
