// The general 3x3 SAME stride-1 conv, forward and input gradient, for
// Hopper (sm_90a): K7's implicit GEMM (conv.cu) for what its bf16/fp16
// kernel is not built for, so that every conv the routing gate admits runs
// a kernel on the card: fp32 activations, and channel counts that are not
// multiples of 8. Same operands as conv.cu: channels-last (NHWC)
// activations, the weight as [Co][9][Ci], fp32 accumulation; the output
// rounded once to the activations' type, or left in fp32 (the input
// gradient of gn_conv.cu's general instances).
//
//   forward: M = B*H*W output pixels, N = Co, K = 9*Ci,
//            A[m][(t, c)] = x[pixel m shifted by tap t][c],
//            B[(t, c)][n] = w[n][t][c];
//   dx:      M = B*H*W input pixels, N = Ci, K = 9*Co,
//            A[m][(t, c)] = dy[pixel m shifted by tap t][c],
//            B[(t, c)][n] = w[c][8 - t][n] (the flipped, transposed kernel).
// K is ordered (tap, channel), KC = 32 channels a step (zeros past the
// channel count): one 128-byte row of fp32, the span of the swizzle.
//
// Products on the tensor cores: wgmma m64nBNk8 with tf32 operands, A from
// registers, B from shared memory (K-major: tf32 has no transpose flag). An
// fp32 operand x enters as hi = tf32(x), lo = tf32(x - hi), both rounded to
// nearest with ties away from zero (cvt.rna's rounding, done with two
// integer operations), and each product as lo.hi' + hi.lo' + hi.hi'
// (3xTF32, flash_general.cuh's recipe): the dropped terms leave < 2**-21
// of a product, against one TF32 pass's 2**-11. fp16 and bf16 values are
// tf32 numbers already: one exact pass. The tensor cores add into their
// accumulator truncating, so each K step (12 products of k8 in fp32) sums
// in a fresh accumulator, which is then added to the running one in fp32
// (round to nearest).
//
// A CTA owns an M tile that is a BB x BH x BW box of pixels, as in conv.cu
// (64 per consumer warpgroup), and BN output channels: NWG consumer
// warpgroups and one producer warpgroup, joined by a ring of S stages with
// full / empty mbarriers. A stage holds the step's A tile as fp32 and B's
// hi and lo tiles, all 128-byte swizzled K-major rows (as wgmma reads B).
// For fp32 with channel counts that are multiples of 4, one producer
// thread requests each step's A tile as one TMA box of the activation at
// the tap-shifted coordinate (TMA's zero fill is the halo and the ragged
// channels) and B as one box of the weight viewed as [Co][9][Ci]: forward
// straight into B's layout, dx as [32 co][BN ci] rows. LEAD steps later
// all producer threads split that B tile into its hi and lo tiles (in
// place forward; transposed for dx). Otherwise (16-bit types, other channel
// counts) the producer threads load elements and write the same tiles. Each
// consumer reads its 64 rows of A into registers, splitting them there,
// and runs the step's products while the producer prepares the next steps.
// No weight is copied or transposed per call. Where the planner
// (ops/conv.py:plan_conv3x3_general) splits K over grid z for a short grid,
// each split writes fp32 partials and a second pass sums them in split
// order: no atomics, and the output is bitwise repeatable.
//
// A 384-thread CTA compiles within 168 registers a thread, so the
// two-warpgroup tile is N = 80 (40 + 40 accumulators and 32 A registers);
// one warpgroup takes N = 128. Per-thread copies cannot keep the tensor
// cores fed (issuing them takes longer than a step's products), hence TMA
// and a producer warpgroup off the products' path.
//
// Bound on this card: 2*B*H*W*9*Ci*Co operations, for fp32 as three TF32
// passes at 495 TFLOP/s (64x64 320->320: 7.55 GFLOP, 45.8 us; the CUDA
// cores' fp32 rate would take 113 us), against the weight's 36*Ci*Co bytes
// plus the activations' (8x8 2560->1280 fp32: 118 MB of weight, 35 us at
// 3.35 TB/s). Shared memory comes close behind the products: wgmma reads a
// B slice once a pass.
#include <cstdint>

#include "conv.cuh"
#include "elem.cuh"
#include "hopper.cuh"

namespace conv {
namespace {

using namespace hopper;

constexpr int KC = 32;     // channels of a K step: one 128-byte row of fp32
constexpr int ROWB = 128;  // bytes of a tile row (the 128-byte swizzle)
constexpr int GEN_SMEM_BUDGET = 227 * 1024;
constexpr int GEN_STAGES = 4;

struct GenParams {
  int b, h, w;           // images
  int kch, nch;          // channels along K and along N
  int bw, bh, bb;        // the M tile's pixel box (bw * bh * bb = 64 * NWG)
  int tiles_w, tiles_h;  // M tiles across W and across H
  int c_steps;           // channel chunks of KC along K (K steps = 9 * this)
  int splits;            // K ranges (grid z)
  float* part;           // [splits][B*H*W][nch] fp32 partials, or null
};

// TMA: fp32 operands whose channel counts are multiples of 4 (16-byte
// global strides), read by tensor copies; else every producer thread loads
// elements (any type, any channel count)
template <bool DX, int NWG, int BN, bool TMA>
struct GenCfg {
  static constexpr int NT = 128 * (NWG + 1);  // NWG consumers, a producer
  static constexpr int BM = 64 * NWG;          // pixels
  static constexpr int TILE_B = BN * ROWB;     // a hi or lo tile of B
  static constexpr int TILE_A = BM * ROWB;     // A as fp32
  // a stage: B's hi and lo tiles, A; all 1024-byte aligned (the swizzle)
  static constexpr int STAGE = 2 * TILE_B + TILE_A;
  static constexpr int S = GEN_STAGES;
  // TMA dx: raw B tiles [KC][BN] (the weight's rows, transposed by the
  // split), a ring of LEAD + 1; LEAD: steps a tile is requested ahead of
  // its split (at most S - 2, so the producer never waits on the stage
  // the consumers are on)
  static constexpr int RAW_B = TMA && DX ? KC * BN * 4 : 0;
  static constexpr int LEAD =
      !TMA ? 0
           : 1024 + S * STAGE + 3 * RAW_B + 256 <= GEN_SMEM_BUDGET ? 2 : 1;
  static constexpr int RAWS = TMA && DX ? LEAD + 1 : 0;
  static constexpr int SMEM = 1024 + S * STAGE + RAWS * RAW_B + 256;
  static constexpr int TX = TILE_A + KC * BN * 4;  // TMA bytes a step
  static_assert(SMEM <= GEN_SMEM_BUDGET, "shared memory");
  static_assert(BN % 16 == 0, "B chunks");
};

// x rounded to tf32 to nearest, ties away from zero: cvt.rna.tf32.f32 on
// finite values, in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// four fp32 values as (hi, lo) tf32 pairs, or as themselves (16-bit T:
// exact in tf32, no lo)
template <bool F32>
__device__ __forceinline__ void split4(const float (&f)[4], uint4& hi,
                                       uint4& lo) {
  uint32_t* h = &hi.x;
  uint32_t* l = &lo.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (F32) {
      h[e] = tf32_rna(f[e]);
      l[e] = tf32_rna(f[e] - __uint_as_float(h[e]));
    } else {
      h[e] = __float_as_uint(f[e]);
    }
  }
}

// word of element (row, k) in a tile of 32-word rows, 128B-swizzled
__device__ __forceinline__ int swz(int row, int k) {
  return row * KC + 4 * ((k / 4) ^ (row % 8)) + k % 4;
}

template <typename T, bool DX, int NWG, int BN, bool TMA>
__global__ void __launch_bounds__(GenCfg<DX, NWG, BN, TMA>::NT, 1)
    general_kernel(const __grid_constant__ CUtensorMap act_map,
                   const __grid_constant__ CUtensorMap w_map,
                   const T* __restrict__ src, const T* __restrict__ w,
                   T* __restrict__ out, const GenParams p) {
  using C = GenCfg<DX, NWG, BN, TMA>;
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int S = C::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: B hi [BN][KC], B lo [BN][KC], A [BM][KC] (fp32 words,
  // 128B-swizzled rows); then the raw B ring, then the barriers
  auto hi_of = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + s * C::STAGE);
  };
  auto a_of = [&](int s) {
    return reinterpret_cast<uint32_t*>(smem + s * C::STAGE +
                                       2 * C::TILE_B);
  };
  auto raw_of = [&](int r) {
    return reinterpret_cast<float*>(smem + S * C::STAGE + r * C::RAW_B);
  };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * C::STAGE +
                                               C::RAWS * C::RAW_B);
  uint64_t* empty = full + S;
  uint64_t* loaded = empty + S;

  const int tid = threadIdx.x, wg = tid / 128;
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

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);       // every producer thread
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
      mbar_init(&loaded[s], 1);       // the TMA issuer, with the bytes
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // ---- producer warpgroup
    const int pt = tid - 128 * NWG;
    // the tap and first channel of local step i
    auto step_of = [&](int i, int& tap, int& c0) {
      const int k = step0 + i;
      tap = k / p.c_steps;
      c0 = (k - tap * p.c_steps) * KC;
    };
    if constexpr (TMA) {
      // pt 0 requests step i's tiles once the consumers are done with
      // the stage; all split step i - LEAD's B once it has landed
      if (pt == 0) {
        prefetch_map(&act_map);
        prefetch_map(&w_map);
      }
      for (int i = 0; i < nsteps + C::LEAD; ++i) {
        if (pt == 0 && i < nsteps) {
          const int s = i % S;
          int tap, c0;
          step_of(i, tap, c0);
          mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
          mbar_expect_tx(&loaded[s], C::TX);
          tma_load_4d(a_of(s), &act_map, &loaded[s], c0,
                      ow0 + tap % 3 - 1, oh0 + tap / 3 - 1, b0);
          if constexpr (!DX)
            tma_load_3d(hi_of(s), &w_map, &loaded[s], c0, tap, n0);
          else
            tma_load_3d(raw_of(i % C::RAWS), &w_map, &loaded[s], n0,
                        8 - tap, c0);
        }
        const int j = i - C::LEAD;
        if (j < 0) continue;
        const int s = j % S;
        mbar_wait(&loaded[s], (j / S) & 1);
        uint32_t* hi = hi_of(s);
        uint32_t* lo = hi + BN * KC;
#pragma unroll
        for (int c = 0; c < BN / 16; ++c) {
          const int q = pt + 128 * c;  // a chunk of 4 words
          float f[4];
          int off;
          if constexpr (!DX) {
            // in place: the tile landed in B's layout
            off = 4 * q;
            const float4 v = *reinterpret_cast<const float4*>(hi + off);
            f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
          } else {
            // raw [k][n] -> (n, 4 k4 .. 4 k4 + 3)
            const int n = q % BN, k4 = q / BN;
            const float* raw = raw_of(j % C::RAWS);
#pragma unroll
            for (int e = 0; e < 4; ++e) f[e] = raw[(4 * k4 + e) * BN + n];
            off = swz(n, 4 * k4);
          }
          uint4 vh, vl;
          split4<true>(f, vh, vl);
          *reinterpret_cast<uint4*>(hi + off) = vh;
          *reinterpret_cast<uint4*>(lo + off) = vl;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if constexpr (DX) named_sync(1, 128);  // raw tile j free again
        mbar_arrive(&full[s]);
      }
    } else {
      // element loads: A as fp32, B straight to its hi (and lo) tile
      for (int i = 0; i < nsteps; ++i) {
        const int s = i % S;
        int tap, c0;
        step_of(i, tap, c0);
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        uint32_t* a = a_of(s);
        for (int q = pt; q < C::BM * 8; q += 128) {
          const int r = q / 8, c = c0 + 4 * (q % 8);
          const int x = ow0 + r % p.bw + dx;
          const int y = oh0 + r / p.bw % p.bh + dy;
          const int bi = b0 + r / (p.bw * p.bh);
          const bool in = ow0 + r % p.bw < p.w && oh0 + r / p.bw % p.bh < p.h &&
                          bi < p.b && x >= 0 && x < p.w && y >= 0 && y < p.h;
          const T* sp =
              src + ((static_cast<long long>(bi) * p.h + y) * p.w + x) *
                        p.kch;
          float f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = in && c + e < p.kch ? elem::to_f(sp[c + e]) : 0.f;
          *reinterpret_cast<float4*>(a + swz(r, 4 * (q % 8))) =
              make_float4(f[0], f[1], f[2], f[3]);
        }
        uint32_t* hi = hi_of(s);
        uint32_t* lo = hi + BN * KC;
        for (int q = pt; q < BN * 8; q += 128) {
          int n, k4;
          float f[4];
          if constexpr (!DX) {
            n = q / 8;
            k4 = q % 8;
            const int c = c0 + 4 * k4;
            const T* wp =
                w + (static_cast<long long>(n0 + n) * 9 + tap) * p.kch;
#pragma unroll
            for (int e = 0; e < 4; ++e)
              f[e] = n0 + n < p.nch && c + e < p.kch ? elem::to_f(wp[c + e])
                                                    : 0.f;
          } else {
            n = q % BN;
            k4 = q / BN;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = c0 + 4 * k4 + e;
              f[e] = c < p.kch && n0 + n < p.nch
                         ? elem::to_f(w[(static_cast<long long>(c) * 9 + 8 -
                                         tap) * p.nch + n0 + n])
                         : 0.f;
            }
          }
          uint4 vh, vl;
          split4<F32>(f, vh, vl);
          const int off = swz(n, 4 * k4);
          *reinterpret_cast<uint4*>(hi + off) = vh;
          if constexpr (F32) *reinterpret_cast<uint4*>(lo + off) = vl;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows [64 wg, 64 wg + 64) of the tile
  const int warp = tid % 128 / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // A fragments of a step's four k8 slices, tf32 bits (lo: fp32 only).
  // Rows 64 wg + 16 warp + g (+ 8) sit at swizzle phase g.
  uint32_t ahi[KC / 8][4], alo[KC / 8][4];
  auto load_a = [&](int s) {
    const uint32_t* a = a_of(s) + (64 * wg + 16 * warp + g) * KC;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const int c0 = 4 * ((2 * kk) ^ g) + t, c1 = 4 * ((2 * kk + 1) ^ g) + t;
      const float v[4] = {__uint_as_float(a[c0]),
                          __uint_as_float(a[8 * KC + c0]),
                          __uint_as_float(a[c1]),
                          __uint_as_float(a[8 * KC + c1])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (F32) {
          ahi[kk][e] = tf32_rna(v[e]);
          alo[kk][e] = tf32_rna(v[e] - __uint_as_float(ahi[kk][e]));
        } else {
          ahi[kk][e] = __float_as_uint(v[e]);
        }
      }
    }
  };

  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = part[e] = 0.f;

  // stage s's products into a fresh accumulator `part`: lo.hi', hi.lo',
  // hi.hi' (the small terms first) for fp32, hi.hi' for 16-bit T
  auto mma = [&](int s) {
    const uint32_t hi_addr = smem_u32(hi_of(s));
    const uint32_t lo_addr = hi_addr + C::TILE_B;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      // K-major, 128B swizzle: 8-row groups 1024 B apart, k8 slices 32 B
      const uint64_t dh = smem_desc(hi_addr + kk * 32, 16, 1024);
      if constexpr (F32) {
        const uint64_t dl = smem_desc(lo_addr + kk * 32, 16, 1024);
        MmaTf32<BN>::run_rs(part, alo[kk], dh, kk > 0);
        MmaTf32<BN>::run_rs(part, ahi[kk], dl, 1);
        MmaTf32<BN>::run_rs(part, ahi[kk], dh, 1);
      } else {
        MmaTf32<BN>::run_rs(part, ahi[kk], dh, kk > 0);
      }
    }
    wgmma_commit();
  };

  // the step's products done: their sum joins the running one, and
  // stage s goes back to the producer
  auto drain = [&](int s) {
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      fence_regs(ahi[kk]);
      if constexpr (F32) fence_regs(alo[kk]);
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] += part[e];
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  if (nsteps > 0) {
    // step i's products run while the producer prepares the next steps
    mbar_wait(&full[0], 0);
    load_a(0);
    mma(0);
    for (int i = 1; i < nsteps; ++i) {
      mbar_wait(&full[i % S], (i / S) & 1);
      drain((i - 1) % S);
      load_a(i % S);
      mma(i % S);
    }
    drain((nsteps - 1) % S);
  }

  // accumulator 4 j + 2 half + e: tile row 64 wg + 16 warp + g + 8 half
  // (a pixel of the box), column 8 j + 2 t + e
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 64 * wg + 16 * warp + g + 8 * half;
    const int x = ow0 + r % p.bw, y = oh0 + r / p.bw % p.bh;
    const int bi = b0 + r / (p.bw * p.bh);
    if (x >= p.w || y >= p.h || bi >= p.b) continue;
    const long long row = ((static_cast<long long>(bi) * p.h + y) * p.w + x) *
                          p.nch;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= p.nch) continue;
      const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      const bool two = n + 1 < p.nch, pair = two && p.nch % 2 == 0;
      if (p.part != nullptr) {
        float* d = p.part + static_cast<long long>(blockIdx.z) * p.b * p.h *
                                p.w * p.nch + row + n;
        if (pair) {
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        } else {
          d[0] = v0;
          if (two) d[1] = v1;
        }
      } else if (F32 && pair) {
        *reinterpret_cast<float2*>(out + row + n) = make_float2(v0, v1);
      } else {
        out[row + n] = elem::from_f<T>(v0);
        if (two) out[row + n + 1] = elem::from_f<T>(v1);
      }
    }
  }
}

// out[e] = T(sum over s of part[s][e]), s in order
template <typename T>
__global__ void __launch_bounds__(256)
    general_sum_kernel(const float* __restrict__ part, T* __restrict__ out,
                       long long n, int splits) {
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * 256) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[k * n + i];
    out[i] = elem::from_f<T>(s);
  }
}

// An fp32 tensor map over `rank` dims (innermost first) of a dense tensor
bool encode_f32(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint32_t* box,
                bool swizzle) {
  cuuint64_t strides[4];
  cuuint64_t bytes = 4;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = bytes *= dims[i];
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                     const_cast<void*>(ptr), dims, strides, box, ones,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool DX, int NWG, int BN, bool TMA>
int launch_general(const CUtensorMap& act, const CUtensorMap& wm,
                   const void* src, const void* w, void* out,
                   const GenParams& p, dim3 grid, cudaStream_t st) {
  using C = GenCfg<DX, NWG, BN, TMA>;
  auto* kernel = general_kernel<T, DX, NWG, BN, TMA>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, C::NT, C::SMEM, st>>>(act, wm, static_cast<const T*>(src),
                                       static_cast<const T*>(w),
                                       static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// The instance of (T, DX, TMA) for the plan's tile: ops/conv.py's
// GENERAL_TILES
template <typename T, bool DX, bool TMA>
int launch_general_tile(int nwg, int bn, const CUtensorMap& act,
                        const CUtensorMap& wm, const void* src,
                        const void* w, void* out, const GenParams& p,
                        dim3 grid, cudaStream_t st) {
#define GEN_CASE(NWG, BN)                                              \
  if (nwg == NWG && bn == BN)                                          \
    return launch_general<T, DX, NWG, BN, TMA>(act, wm, src, w, out, p, \
                                               grid, st);
  GEN_CASE(1, 128) GEN_CASE(2, 80)
#undef GEN_CASE
  return ERR_PLAN;
}

}  // namespace

int run_general(int dt, bool dx, const void* src, const void* w, void* out,
                float* part, bool f32_out, int b, int h, int wd, int ci,
                int co, int nwg, int bn, int bw, int bh, int bb, int splits,
                cudaStream_t st) {
  const bool partials = f32_out || splits > 1;
  if (bw * bh * bb != 64 * nwg || splits < 1 ||
      (partials && part == nullptr) || (!f32_out && out == nullptr))
    return ERR_PLAN;
  GenParams p;
  p.b = b;
  p.h = h;
  p.w = wd;
  p.kch = dx ? co : ci;
  p.nch = dx ? ci : co;
  p.bw = bw;
  p.bh = bh;
  p.bb = bb;
  p.tiles_w = (wd + bw - 1) / bw;
  p.tiles_h = (h + bh - 1) / bh;
  p.c_steps = (p.kch + KC - 1) / KC;
  p.splits = splits;
  p.part = partials ? part : nullptr;
  const dim3 grid(p.tiles_w * p.tiles_h * ((b + bb - 1) / bb),
                  (p.nch + bn - 1) / bn, splits);
  // TMA reads fp32 with 16-byte strides and bases
  const bool tma = dt == elem::ELEM_F32 && p.kch % 4 == 0 &&
                   p.nch % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  CUtensorMap act_map{}, w_map{};
  if (tma) {
    if (encode_fn() == nullptr) return ERR_NO_ENCODE;
    const cuuint64_t act_dims[4] = {cuuint64_t(p.kch), cuuint64_t(wd),
                                    cuuint64_t(h), cuuint64_t(b)};
    const cuuint32_t act_box[4] = {KC, cuuint32_t(bw), cuuint32_t(bh),
                                   cuuint32_t(bb)};
    const cuuint64_t w_dims[3] = {cuuint64_t(ci), 9, cuuint64_t(co)};
    // forward: (32 ci, 1, bn co), swizzled as B; dx: (bn ci, 1, 32 co)
    // rows, transposed by the split
    const cuuint32_t w_box[3] = {dx ? cuuint32_t(bn) : cuuint32_t(KC), 1,
                                 dx ? cuuint32_t(KC) : cuuint32_t(bn)};
    if (!encode_f32(&act_map, src, 4, act_dims, act_box, true) ||
        !encode_f32(&w_map, w, 3, w_dims, w_box, !dx))
      return ERR_ENCODE;
  }
  const int err = elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    if (tma) {
      if constexpr (sizeof(T) == 4) {
        return dx ? launch_general_tile<T, true, true>(
                        nwg, bn, act_map, w_map, src, w, out, p, grid, st)
                  : launch_general_tile<T, false, true>(
                        nwg, bn, act_map, w_map, src, w, out, p, grid, st);
      }
    }
    return dx ? launch_general_tile<T, true, false>(nwg, bn, act_map, w_map,
                                                    src, w, out, p, grid, st)
              : launch_general_tile<T, false, false>(
                    nwg, bn, act_map, w_map, src, w, out, p, grid, st);
  });
  if (err != 0 || !partials || f32_out) return err;
  const long long n = static_cast<long long>(b) * h * wd * p.nch;
  const long long blocks = (n + 255) / 256;
  return elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    general_sum_kernel<T>
        <<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256, 0,
           st>>>(part, static_cast<T*>(out), n, splits);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace conv

// K7's general route: the forward (dx = 0; src = x [b, h, wd, ci], out y
// [b, h, wd, co]) or the input gradient (dx = 1; src = dy [b, h, wd, co],
// out dx [b, h, wd, ci]), w [co, 3, 3, ci], all dense channels-last of
// dtype code dt (elem.cuh). The plan (ops/conv.py:plan_conv3x3_general):
// nwg consumer warpgroups, N tile bn, pixel box bw x bh x bb (bw * bh * bb
// = 64 nwg), splits K ranges; part is fp32 scratch of splits * b * h * wd
// * (co or ci) values when splits > 1. Returns the launches' cudaError_t,
// one of conv.cuh's errors, or elem.cuh's ERR_DTYPE.
extern "C" int conv3x3_general(int dt, int dx, const void* src,
                               const void* w, void* out, void* part, int b,
                               int h, int wd, int ci, int co, int nwg, int bn,
                               int bw, int bh, int bb, int splits,
                               void* stream) {
  return conv::run_general(dt, dx != 0, src, w, out,
                           static_cast<float*>(part), false, b, h, wd, ci, co,
                           nwg, bn, bw, bh, bb, splits,
                           static_cast<cudaStream_t>(stream));
}
