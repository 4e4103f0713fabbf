// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (conv.cu, conv_general.cu, flash_fwd.cu, flash_bwd.cu): mbarriers, TMA
// copies, wgmma descriptors and products (16-bit, and tf32 with a
// register-fed A), and the libcuda entry that encodes tensor maps.
//
// wgmma m64nNk16 (bf16 or fp16 in, fp32 sum), thread t of the warpgroup
// (warp
// w = t / 32, lane l = t % 32):
//   accumulator i holds row 16 w + l / 4 + 8 (i % 4 / 2),
//                       column 8 (i / 4) + 2 (l % 4) + i % 2;
//   a register-fed A (16 columns of K) is four 32-bit registers, two
//   16-bit values each, lower column in the low half:
//     a0 = (row 16 w + l / 4,     columns 2 (l % 4) + {0, 1}),
//     a1 = (row 16 w + l / 4 + 8, columns 2 (l % 4) + {0, 1}),
//     a2 = (row 16 w + l / 4,     columns 2 (l % 4) + {8, 9}),
//     a3 = (row 16 w + l / 4 + 8, columns 2 (l % 4) + {8, 9}).
// So accumulators 8 j .. 8 j + 7 of one product, packed pairwise to 16 bits,
// are the A registers of K slice j of the next (FlashAttention-3's reuse):
// a probability or gradient tile goes from one product to the next without
// a trip through shared memory (acc_to_a below).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace hopper {

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase with parity `parity` has completed. A
// wait that outlasts ~2 s of clock (a copy that never lands) traps, so a
// fault shows as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned), completing on `bar` like a tensor load.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor of a 128B-swizzled operand tile whose
// base is 1024-byte aligned: lbo / sbo in bytes (wgmma's "leading" and
// "stride" byte offsets).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for register A operands: an in-flight product still reads
// them, so they stay live (and unchanged) until the wait that follows.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// Named barrier over the consumer warpgroups (id 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}
// Named barrier `id` (>= 1) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The kernels' 16-bit element types: T is __nv_bfloat16 or __half.
template <typename T>
__host__ __device__ constexpr bool is_f16() {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>,
                "bf16 or fp16");
  return std::is_same_v<T, __half>;
}

// Two floats rounded to one register of two T, `lo` in the low half.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (is_f16<T>()) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
// The two T of a packed register back to fp32 (exact; for bf16 a shift
// and a mask, no conversion).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ float unpack_lo(uint32_t r) {
  if constexpr (is_f16<T>())
    return __half2float(__ushort_as_half(static_cast<unsigned short>(r)));
  else
    return __uint_as_float(r << 16);
}
template <typename T = __nv_bfloat16>
__device__ __forceinline__ float unpack_hi(uint32_t r) {
  if constexpr (is_f16<T>())
    return __half2float(
        __ushort_as_half(static_cast<unsigned short>(r >> 16)));
  else
    return __uint_as_float(r & 0xFFFF0000u);
}

// K slice j of a register-fed A operand from accumulators 8 j .. 8 j + 7
// of a m64nN product (see the layout at the top), rounded to T.
template <typename T = __nv_bfloat16, int R>
__device__ __forceinline__ void acc_to_a(const float (&d)[R],
                                         uint32_t (&a)[R / 2]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = pack<T>(d[2 * i], d[2 * i + 1]);
}

#define HOPPER_ACC8(i)                                            \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]),           \
      "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), "+f"(d[(i) + 5]),       \
      "+f"(d[(i) + 6]), "+f"(d[(i) + 7])
#define HOPPER_D32                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "           \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "  \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D64                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "           \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "  \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63}"

// d[64 x BN] += A[64 x 16] . B[16 x BN] (T = bf16 or fp16 in, fp32 sum),
// both from shared memory; TRANS_B = 1 reads B MN-major; SCALE_D = 0
// overwrites d (d = A . B) instead of adding to it. run_rs takes A from
// registers (defined where a kernel uses it). Each product is one asm
// statement per type: HOPPER_BY_TYPE(T, M) expands the statement macro M
// with the type's name in PTX.
template <int BN, typename T = __nv_bfloat16>
struct Mma;

#define HOPPER_BY_TYPE(T, M) \
  if constexpr (is_f16<T>()) \
    M("f16");                \
  else                       \
    M("bf16")

template <typename T>
struct Mma<64, T> {
  template <int TRANS_B, int SCALE_D = 1>
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
#define HOPPER_SS64(TY)                                                   \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      HOPPER_D32 ", %32, %33, p, 1, 1, 0, %35;\n}\n"                      \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)  \
      : "l"(da), "l"(db), "n"(SCALE_D), "n"(TRANS_B))
    HOPPER_BY_TYPE(T, HOPPER_SS64);
#undef HOPPER_SS64
  }
  template <int TRANS_B>
  // A is K slice j of a register-fed operand: a[4 j .. 4 j + 3]
  static __device__ __forceinline__ void run_rs(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db) {
#define HOPPER_RS64(TY)                                                   \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "          \
      HOPPER_D32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"        \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),             \
        "n"(TRANS_B))
    HOPPER_BY_TYPE(T, HOPPER_RS64);
#undef HOPPER_RS64
  }
};

template <typename T>
struct Mma<128, T> {
  template <int TRANS_B, int SCALE_D = 1>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da,
                                             uint64_t db) {
#define HOPPER_SS128(TY)                                                  \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "         \
      HOPPER_D64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"                      \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56) \
      : "l"(da), "l"(db), "n"(SCALE_D), "n"(TRANS_B))
    HOPPER_BY_TYPE(T, HOPPER_SS128);
#undef HOPPER_SS128
  }
};

template <typename T>
struct Mma<160, T> {
  template <int TRANS_B, int SCALE_D = 1>
  static __device__ __forceinline__ void run(float (&d)[80], uint64_t da,
                                             uint64_t db) {
#define HOPPER_SS160(TY)                                                  \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"                        \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "      \
      "%72, %73, %74, %75, %76, %77, %78, %79"                            \
      "}, %80, %81, p, 1, 1, 0, %83;\n}\n"                                \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56), \
        HOPPER_ACC8(64), HOPPER_ACC8(72)                                  \
      : "l"(da), "l"(db), "n"(SCALE_D), "n"(TRANS_B))
    HOPPER_BY_TYPE(T, HOPPER_SS160);
#undef HOPPER_SS160
  }
};

template <typename T>
struct Mma<256, T> {
  template <int TRANS_B, int SCALE_D = 1>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
#define HOPPER_SS256(TY)                                                  \
  asm volatile(                                                           \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                       \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"        \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "      \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "      \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "      \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "    \
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "      \
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"  \
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"                             \
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56), \
        HOPPER_ACC8(64), HOPPER_ACC8(72), HOPPER_ACC8(80), HOPPER_ACC8(88), \
        HOPPER_ACC8(96), HOPPER_ACC8(104), HOPPER_ACC8(112),              \
        HOPPER_ACC8(120)                                                  \
      : "l"(da), "l"(db), "n"(SCALE_D), "n"(TRANS_B))
    HOPPER_BY_TYPE(T, HOPPER_SS256);
#undef HOPPER_SS256
  }
};

// d[64 x BN] += A[64 x 8] . B[8 x BN] in tf32 (fp32 sum), A from
// registers, B K-major from shared memory (tf32 has no transpose flag);
// scale_d = 0 overwrites d. A's four registers hold tf32 bit patterns of
// (row 16 w + l / 4 (+ 8 for a1, a3), column l % 4 (+ 4 for a2, a3)), as
// mma.sync m16n8k8's A fragment.
template <int BN>
struct MmaTf32;

template <>
struct MmaTf32<80> {
  static __device__ __forceinline__ void run_rs(float (&d)[40],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}"
        ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24),
          HOPPER_ACC8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct MmaTf32<128> {
  static __device__ __forceinline__ void run_rs(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " HOPPER_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24),
          HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};
#undef HOPPER_ACC8
#undef HOPPER_D32
#undef HOPPER_D64
#undef HOPPER_BY_TYPE

// ---------------------------------------------------------------------------
// Host side: tensor maps
// ---------------------------------------------------------------------------

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

// The tensor-map element type of T (bf16 or fp16)
template <typename T>
__host__ __device__ constexpr CUtensorMapDataType tma_type() {
  return is_f16<T>() ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// cuTensorMapEncodeTiled, a libcuda entry, found through the runtime (the
// libraries link no libcuda).
inline EncodeFn encode_fn() {
  static const EncodeFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeFn>(ptr)
               : nullptr;
  }();
  return fn;
}

}  // namespace hopper
