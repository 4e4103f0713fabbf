// Element types of the kernels: fp32, fp16 and bf16 activations, read as
// fp32 and rounded to nearest even on the way out. The general kernels
// (flash_general.cu, conv_general.cu) and the GroupNorm passes (gn.cu,
// gn_conv.cu) are templates over them; a host entry picks the instance
// from a dtype code (ELEM_*, ops/ passes it).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace elem {

constexpr int ELEM_F32 = 0;
constexpr int ELEM_F16 = 1;
constexpr int ELEM_BF16 = 2;
constexpr int ERR_DTYPE = 1004;  // a dtype code with no instance

// The dtype code of T
template <typename T>
constexpr int code_of() {
  return std::is_same_v<T, float>    ? ELEM_F32
         : std::is_same_v<T, __half> ? ELEM_F16
                                     : ELEM_BF16;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same_v<T, __half>) {
    return __float2half_rn(v);
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

// v rounded to T and back (the identity for fp32)
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// N values of T at p as floats: 16-byte (or 8- and 4-byte) vector loads
// where N values of T fill one, else one load each. p is aligned to the
// size of N values of T.
template <typename T, int N>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int v = 0; v < N * static_cast<int>(sizeof(T)) / 16; ++v) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[v];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
        f[v * 16 / sizeof(T) + j] = to_f(e[j]);
    }
  } else if constexpr (N == 2 && sizeof(T) == 2) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
    f[0] = to_f(e[0]);
    f[1] = to_f(e[1]);
  } else if constexpr (N == 2 && sizeof(T) == 4) {
    const float2 raw = *reinterpret_cast<const float2*>(p);
    f[0] = raw.x;
    f[1] = raw.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

// N floats rounded to T into p, vectorized as load()
template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&f)[N]) {
  if constexpr (N * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int v = 0; v < N * static_cast<int>(sizeof(T)) / 16; ++v) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
        e[j] = from_f<T>(f[v * 16 / sizeof(T) + j]);
      reinterpret_cast<uint4*>(p)[v] = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = from_f<T>(f[j]);
  }
}

// Calls fn(T{}) with the element type of dtype code `code`; ERR_DTYPE for
// an unknown code.
template <typename Fn>
int dispatch(int code, Fn&& fn) {
  switch (code) {
    case ELEM_F32:
      return fn(float{});
    case ELEM_F16:
      return fn(__half{});
    case ELEM_BF16:
      return fn(__nv_bfloat16{});
    default:
      return ERR_DTYPE;
  }
}

}  // namespace elem
