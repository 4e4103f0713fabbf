// What the general flash-attention kernels (flash_general.cu, forward;
// flash_general_bwd.cu, backward) share: the split operand tiles they keep
// in shared memory, the 3xTF32 products on the tensor cores, and the views
// of their [B, S, H, D] operands.
//
// Products. mma.sync m16n8k8 with tf32 operands and fp32 accumulators. An
// fp32 operand x enters as its pair hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), and each product as lo.hi' + hi.lo' + hi.hi': the
// dropped lo.lo' and the rounding of lo leave < 2**-21 of a product,
// against TF32's 2**-11 (3xTF32, as CUTLASS's OpMultiplyAddFastF32).
// Values of a 16-bit T (operands, and p, ds, q_s rounded to T) are tf32
// numbers already: one exact pass. The tensor cores add into their fp32
// accumulator truncating, so a long sum drifts (2**-15 of O over 4096 keys
// measured when one accumulator took them all); every product over the
// streamed rows therefore sums one tile of 64 rows in a fresh accumulator
// and adds it to the running one in fp32 (round to nearest).
//
// Tiles. A CTA owns 16 rows a warp (queries in the forward and the dq
// kernel, keys in the dk/dv kernel; four warps, BR = 64 rows, but for the
// forward's five) and walks the other side in steps of BS = 64 rows, one tile of 64 rows x DC = 64 head-dim
// columns at a time. A tile is first copied raw (the operand's own type,
// rows padded) into shared memory by cp.async, 16 bytes a copy where a row
// is 16-byte aligned and unit-stride along D, element by element where
// not, zeros past the rows and past D; the next tile's copy runs while the
// warps compute on the current one. The CTA's own rows stay raw and are
// split as their A fragments are read. A streamed tile is split once, by
// all threads, from raw into a tile of (hi, lo) pairs laid out for one
// 16-byte load a fragment:
//   - ROWS (the B operand of s = a . b^T): row-major, the columns of each
//     group of 8 in the order 0 4 1 5 2 6 3 7, so a fragment's columns t
//     and t + 4 lie side by side;
//   - COLS (the B operand x of o += p . x, p a C fragment read in place as
//     A, whose columns 2t and 2t + 1 are the fragment's k = t and t + 4):
//     transposed, x's rows (keys or queries) along the tile row.
// A tile row of pairs is 72 pairs (576 bytes), so the 16-byte fragment
// loads of a quarter warp fall on distinct banks; a raw fp32 row is 68
// elements, so an A fragment's 4-byte loads do. A head dim is walked in
// DC-wide chunks; a product skips the 8-column steps wholly past D.
// Fragments (g = lane / 4, t = lane % 4): A (16 x 8) holds (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B (8 x 8) (k = t, n = g),
// (k = t + 4, n = g); C (16 x 8) (g, 2t), (g, 2t + 1), (g + 8, 2t),
// (g + 8, 2t + 1).
#pragma once

#include <math.h>

#include "elem.cuh"

namespace flashgen {

constexpr int THREADS = 128;  // four warps (the forward: or five)
constexpr int BR = 64;        // rows a CTA of four warps owns
constexpr int BS = 64;        // rows of a streamed tile
constexpr int DC = 64;        // head-dim columns of a tile
constexpr int S2 = 72;        // (hi, lo) pairs a tile row
constexpr int TILE = 64 * S2;  // pairs a tile
constexpr int TILE_BYTES = TILE * 8;

// One [B, S, H, D] operand: its base, element strides, and whether its
// rows may be read 16 bytes at a time
template <typename T>
struct View {
  const T* p;
  long long sb, ss, sh, sd;
  bool vec;
  __device__ __forceinline__ const T* row(int b, int h, int s) const {
    return p + b * sb + h * sh + s * ss;
  }
};

template <typename T>
struct Args {
  View<T> q, k, v, o, dout;
  T* out0;       // O forward, dq backward: dense [B, Sq, H, D]
  T* out1;       // dk: dense [B, Sk, H, D]
  T* out2;       // dv: dense [B, Sk, H, D]
  float* lse;    // [B*H, Sq]
  float* delta;  // [B*H, Sq] (backward)
  int b, sq, sk, h, d;
  float scale;
};

// The view of the operand at p of dims (b, s, h, d) with strides st[0..3];
// a size-1 dim's stride is never stepped, so it does not bar vector loads
template <typename T>
View<T> view(const void* p, const long long* st, int b, int s, int h, int d) {
  constexpr long long V = 16 / sizeof(T);
  const bool vec = st[3] == 1 && d % V == 0 &&
                   reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   (b == 1 || st[0] % V == 0) && (s == 1 || st[1] % V == 0) &&
                   (h == 1 || st[2] % V == 0);
  return View<T>{static_cast<const T*>(p), st[0], st[1], st[2], st[3], vec};
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as its tf32 pair (fp32), or as itself (a 16-bit T's value: lo = 0)
template <typename T>
__device__ __forceinline__ float2 split(float x) {
  if constexpr (sizeof(T) == 4) {
    const float hi = __uint_as_float(to_tf32(x));
    return make_float2(hi, __uint_as_float(to_tf32(x - hi)));
  } else {
    return make_float2(x, 0.f);
  }
}

// Raw tiles: 64 rows of DC elements of T, a row RS elements apart
template <typename T>
__host__ __device__ constexpr int raw_stride() {
  return sizeof(T) == 4 ? DC + 4 : DC + 8;
}
template <typename T>
__host__ __device__ constexpr int raw_bytes() {
  return 64 * raw_stride<T>() * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows row0 .. row0 + ROWS - 1 (those < n) and head-dim columns col0
// .. col0 + DC - 1 (those < d) of x at batch b, head h raw into `tile`,
// zeros elsewhere, by the CTA's NT threads: cp.async where x.vec (then
// committed by the caller), else element loads
template <typename T, int NT = THREADS, int ROWS = BS>
__device__ __forceinline__ void stage(T* tile, const View<T>& x, int b, int h,
                                      int row0, int n, int col0, int d) {
  constexpr int RS = raw_stride<T>();
  if (x.vec) {
    constexpr int V = 16 / sizeof(T), NV = DC / V;
    for (int i = threadIdx.x; i < ROWS * NV; i += NT) {
      const int r = i / NV, c = i % NV * V;
      const int row = row0 + r, col = col0 + c;
      const bool ok = row < n && col < d;
      cp_async16(tile + r * RS + c, ok ? x.row(b, h, row) + col : x.p,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DC; i += NT) {
      const int r = i / DC, c = i % DC;
      const int row = row0 + r, col = col0 + c;
      tile[r * RS + c] = row < n && col < d
                             ? x.row(b, h, row)[col * x.sd]
                             : elem::from_f<T>(0.f);
    }
  }
}

// An element of a raw tile as fp32; `PRE`: q_s = T(q * scale)
template <typename T, bool PRE>
__device__ __forceinline__ float raw_at(const T* p, float scale) {
  const float x = elem::to_f(*p);
  return PRE ? elem::round_t<T>(x * scale) : x;
}

// Raw tile `raw` split into `tile` in the ROWS layout by the CTA's NT
// threads: a thread takes runs of 8 columns of one row, neighbouring
// threads neighbouring rows
template <typename T, bool PRE, int NT = THREADS>
__device__ __forceinline__ void split_rows(float2* tile, const T* raw,
                                           float scale) {
  constexpr int RS = raw_stride<T>(), N = BS * DC / 8;
#pragma unroll
  for (int k = 0; k < (N + NT - 1) / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (N % NT != 0 && i >= N) break;
    const int r = i % BS, c = i / BS * 8;
    float f[8];
    elem::load<T, 8>(raw + r * RS + c, f);
    float4* dst = reinterpret_cast<float4*>(tile + r * S2 + c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = PRE ? elem::round_t<T>(f[j] * scale) : f[j];
      const float z = PRE ? elem::round_t<T>(f[j + 4] * scale) : f[j + 4];
      const float2 sa = split<T>(a), sz = split<T>(z);
      dst[j] = make_float4(sa.x, sa.y, sz.x, sz.y);
    }
  }
}

// Raw tile `raw` split into `tile` in the COLS layout (tile row = a column
// of the raw tile) by the CTA's NT threads: a thread takes 4 columns of two
// neighbouring rows, neighbouring threads neighbouring row pairs
template <typename T, bool PRE, int NT = THREADS>
__device__ __forceinline__ void split_cols(float2* tile, const T* raw,
                                           float scale) {
  constexpr int RS = raw_stride<T>(), N = BS / 2 * DC / 4;
#pragma unroll
  for (int k = 0; k < (N + NT - 1) / NT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (N % NT != 0 && i >= N) break;
    const int r = i % (BS / 2) * 2, c = i / (BS / 2) * 4;
    float f0[4], f1[4];
    elem::load<T, 4>(raw + r * RS + c, f0);
    elem::load<T, 4>(raw + (r + 1) * RS + c, f1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a = PRE ? elem::round_t<T>(f0[j] * scale) : f0[j];
      const float z = PRE ? elem::round_t<T>(f1[j] * scale) : f1[j];
      const float2 sa = split<T>(a), sz = split<T>(z);
      *reinterpret_cast<float4*>(tile + (c + j) * S2 + r) =
          make_float4(sa.x, sa.y, sz.x, sz.y);
    }
  }
}

__device__ __forceinline__ void mma(float (&c)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a . b with a = (hi, lo) pairs a[0..3] and b = (hi, lo) pairs b0,
// b1: three passes for fp32 (the small terms first), one for T's values
template <typename T>
__device__ __forceinline__ void mma3(float (&c)[4], const float2 (&a)[4],
                                     float2 b0, float2 b1) {
  if constexpr (sizeof(T) == 4) {
    mma(c, __float_as_uint(a[0].y), __float_as_uint(a[1].y),
        __float_as_uint(a[2].y), __float_as_uint(a[3].y),
        __float_as_uint(b0.x), __float_as_uint(b1.x));
    mma(c, __float_as_uint(a[0].x), __float_as_uint(a[1].x),
        __float_as_uint(a[2].x), __float_as_uint(a[3].x),
        __float_as_uint(b0.y), __float_as_uint(b1.y));
  }
  mma(c, __float_as_uint(a[0].x), __float_as_uint(a[1].x),
      __float_as_uint(a[2].x), __float_as_uint(a[3].x), __float_as_uint(b0.x),
      __float_as_uint(b1.x));
}

__device__ __forceinline__ float4 lds4(const float2* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void zero_tile(float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][8][4]) {
#pragma unroll
  for (int u = 0; u < N; ++u) zero_tile(x[u]);
}

// s[j] (the warp's 16 rows x 64 columns, n-tile j) += A . B^T over the
// first kc head-dim columns: A's rows the warp's rows of raw tile `a` (q_s
// with PRE), split here, B's the rows of ROWS tile `bt`
template <typename T, bool PRE>
__device__ __forceinline__ void logits(float (&s)[8][4], const T* a,
                                       const float2* bt, int kc,
                                       float scale) {
  constexpr int RS = raw_stride<T>();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* ar = a + (threadIdx.x / 32 * 16 + g) * RS + t;
  const float2* br = bt + g * S2 + 2 * t;
#pragma unroll
  for (int kk = 0; kk < DC / 8; ++kk) {
    if (8 * kk >= kc) break;
    const float2 af[4] = {split<T>(raw_at<T, PRE>(ar + 8 * kk, scale)),
                          split<T>(raw_at<T, PRE>(ar + 8 * RS + 8 * kk, scale)),
                          split<T>(raw_at<T, PRE>(ar + 8 * kk + 4, scale)),
                          split<T>(raw_at<T, PRE>(ar + 8 * RS + 8 * kk + 4,
                                                  scale))};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 y = lds4(br + 8 * j * S2 + 8 * kk);
      mma3<T>(s[j], af, make_float2(y.x, y.y), make_float2(y.z, y.w));
    }
  }
}

// o[n] (the warp's 16 rows x 64 head-dim columns) += P . X over the tile's
// 64 rows, P in registers as C fragments (p[j]: columns 8j ..), X the COLS
// tile `x`, its first oc columns; summed in a fresh accumulator
template <typename T>
__device__ __forceinline__ void value_product(float (&o)[8][4],
                                              const float (&p)[8][4],
                                              const float2* x, int oc) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float2* xr = x + g * S2 + 2 * t;
  float acc[8][4];
  zero_tile(acc);
#pragma unroll
  for (int kk = 0; kk < BS / 8; ++kk) {
    const float2 af[4] = {split<T>(p[kk][0]), split<T>(p[kk][2]),
                          split<T>(p[kk][1]), split<T>(p[kk][3])};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (8 * n >= oc) break;
      const float4 y = lds4(xr + 8 * n * S2 + 8 * kk);
      mma3<T>(acc[n], af, make_float2(y.x, y.y), make_float2(y.z, y.w));
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += acc[n][e];
}

// The four threads of a quad (one row of a C fragment): max and sum
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write the warp's accumulator rows (o[n]: columns col0 + 8n ..) as T into
// dense [B, S, H, D] `out` at rows row0 and row0 + 8: each value v as
// v / f[half] (DIV) or v * f[half], rounded to T first where `round_first`
template <typename T, bool DIV>
__device__ __forceinline__ void store_rows(T* out, const float (&o)[8][4],
                                           const float (&f)[2], int b,
                                           int row0, int n_rows, int h,
                                           int n_heads, int col0, int d,
                                           bool round_first) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= n_rows) continue;
    T* dst = out + ((static_cast<long long>(b) * n_rows + row) * n_heads +
                    h) * d;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * n + 2 * t + e;
        if (col >= d) continue;
        float v = o[n][2 * hr + e];
        if (round_first) v = elem::round_t<T>(v);
        dst[col] = elem::from_f<T>(DIV ? v / f[hr] : v * f[hr]);
      }
  }
}

// Lets kernel `k` take `bytes` of dynamic shared memory (over 48 KB)
template <typename K>
cudaError_t allow_smem(K k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace flashgen
