// The general flash-attention backward: the flash backward's function
// (flash_bwd.cu) for fp32 operands and any head dim, as flash_general.cu
// is the forward's; the tiles and products are in flash_general.cuh.
//
// Replaces, for those calls, the JAX package's backward kernels
// (diffusionhandles_tpu/ops/attention.py): _flash_bwd_fused_kernel (K2,
// :333), _flash_bwd_dq_kernel + _flash_bwd_dkv_kernel (K3, :282 / :305)
// and _flash_bwd_fused_fold_kernel (K6, :375), as modes of the same
// kernels. Same function and rounding points as the plain versions in
// ops/attention.py, with T the operands' type: delta = rowsum(dO * O) in
// fp32 (K6: -(hi + lo) of its T hi/lo pair); p = exp(s - lse) with
// s = q_s . k, q_s = T(q * scale); dv = T(p)^T dO; dp = dO V^T;
// ds = T(p * (dp - delta)); dk = ds^T q_s; dq = (ds k) * scale, rounded
// once (K2, K6) or rounded before the scale too (K3). q, k, v, O and dO
// are read as [B, S, H, D] views through their element strides; dq, dk
// and dv are written dense [B, S, H, D].
//
// Bound on this card: the operations. The five products are
// 10*B*H*Sq*Sk*D: at [1,4096,5,64] 53.7 GFLOP, 0.80 ms on the CUDA cores'
// fp32 rate and 0.33 ms as three TF32 passes on the tensor cores. This
// design forms s and dp twice (once for dk/dv, once for dq), 14*B*H*Sq*Sk*D
// (0.46 ms at 3xTF32), to stay free of atomics: every output element is
// summed by one thread in a fixed order, so a second call gives the same
// bits. Two launches: delta, a warp a (b, h, query) row; then dk/dv and dq
// as one grid (their CTAs fill each other's last wave):
//   - dk/dv: a CTA of four warps owns 64 keys (16 a warp), keeps its k
//     and v rows raw in shared memory (copied once where the head dim is
//     one chunk; split as A fragments) and walks the queries in tiles of
//     64: s^T = k . q_s^T and dp^T = v . dO^T against each query tile,
//     then p^T and ds^T in registers, then dv += T(p)^T . dO and
//     dk += ds^T . q_s against dO and q_s split transposed, p^T and ds^T
//     read in place as A fragments;
//   - dq: a CTA owns 64 queries, keeps its q and dO rows raw and walks the
//     keys: s, dp and ds as above against k and v, then dq += ds . k.
// The tiles and products are flash_general.cuh's (a streamed tile copied
// by cp.async while the previous phase computes, then split once; fp32 as
// 3xTF32, 16-bit T in one exact pass, a fresh accumulator a tile): four
// raw tiles and one of pairs (106 KB, fp32) a CTA, two CTAs an SM. dk, dv
// and dq hold up to two chunks of 64 columns in registers; a wider head is
// walked in passes that recompute s and dp.
#include "flash_general.cuh"

namespace flashgen {

// delta of every (b, h, query) row, a warp each; `fold`: -(hi + lo) of
// the T pair of -delta (K6)
template <typename T>
__global__ void __launch_bounds__(THREADS) delta_kernel(Args<T> a, int fold) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (THREADS / 32) + threadIdx.x / 32;
  if (row >= static_cast<long long>(a.b) * a.h * a.sq) return;
  const int lane = threadIdx.x % 32;
  const int bh = static_cast<int>(row / a.sq), s = static_cast<int>(row % a.sq);
  const int b = bh / a.h, h = bh % a.h;
  const T* dout = a.dout.row(b, h, s);
  const T* o = a.o.row(b, h, s);
  float acc = 0.f;
  for (int d = lane; d < a.d; d += 32)
    acc = fmaf(elem::to_f(dout[d * a.dout.sd]), elem::to_f(o[d * a.o.sd]),
               acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  if (fold) {
    const float hi = elem::round_t<T>(-acc);
    const float lo = elem::round_t<T>(-acc - hi);
    acc = -(hi + lo);
  }
  a.delta[row] = acc;
}

template <typename T>
constexpr int bwd_smem() {
  return 4 * raw_bytes<T>() + TILE_BYTES + 2 * BS * 4;
}

// dk and dv of the BR keys of tile `tile`, head blockIdx.y
template <typename T, int NOC>
__device__ __forceinline__ void dkdv_tile(const Args<T>& a, int tile) {
  constexpr int RS = raw_stride<T>();
  extern __shared__ float4 smem4[];
  T* const rk = reinterpret_cast<T*>(smem4);  // k chunk, raw
  T* const rv = rk + 64 * RS;                  // v chunk, raw
  T* const rq = rv + 64 * RS;                  // a q chunk, raw
  T* const rd = rq + 64 * RS;                  // a dO chunk, raw
  float2* const sx = reinterpret_cast<float2*>(rd + 64 * RS);
  float* const sl = reinterpret_cast<float*>(sx + TILE);  // lse, delta
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int k0 = tile * BR;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row0 = k0 + threadIdx.x / 32 * 16 + lane / 4;
  const int nd = (a.d + DC - 1) / DC;
  const int nq = (a.sq + BS - 1) / BS;
  for (int ob = 0; ob < nd; ob += NOC) {
    // phases of a query tile: nd of q chunks (s^T), nd of dO chunks
    // (dp^T), `no` of dO chunks (dv), `no` of q chunks (dk)
    const int no = min(NOC, nd - ob), per = 2 * nd + 2 * no;
    const int items = nq * per;
    // a phase's raw tile; with one chunk the dv and dk phases split the
    // dO and q tiles their dp^T and s^T phases copied
    auto fetch = [&](int i) {
      const int q0 = i / per * BS, sub = i % per;
      if (nd == 1 && sub >= 2) return;
      const int c = sub < 2 * nd ? sub % nd : ob + (sub - 2 * nd) % no;
      const bool q_tile = sub < nd || sub >= 2 * nd + no;
      stage(q_tile ? rq : rd, q_tile ? a.q : a.dout, b, h, q0, a.sq, c * DC,
            a.d);
      cp_async_commit();
    };
    float s[8][4], dp[8][4], dk[NOC][8][4], dv[NOC][8][4];
    zero(dk);
    zero(dv);
    __syncthreads();
    fetch(0);
    for (int i = 0; i < items; ++i) {
      const int q0 = i / per * BS, sub = i % per;
      cp_async_wait_all();
      __syncthreads();
      if (sub < 2 * nd && (nd > 1 || i < 2)) {
        // this chunk of the CTA's k (or v) rows, raw
        stage(sub < nd ? rk : rv, sub < nd ? a.k : a.v, b, h, k0, a.sk,
              sub % nd * DC, a.d);
        cp_async_commit();
        cp_async_wait_all();
      }
      if (sub == 0 && threadIdx.x < BS) {
        const int qi = q0 + threadIdx.x;
        const long long li = static_cast<long long>(bh) * a.sq + qi;
        sl[threadIdx.x] = qi < a.sq ? a.lse[li] : 0.f;
        sl[BS + threadIdx.x] = qi < a.sq ? a.delta[li] : 0.f;
      }
      if (sub < nd)
        split_rows<T, true>(sx, rq, a.scale);
      else if (sub < 2 * nd)
        split_rows<T, false>(sx, rd, 0.f);
      else if (sub < 2 * nd + no)
        split_cols<T, false>(sx, rd, 0.f);
      else
        split_cols<T, true>(sx, rq, a.scale);
      __syncthreads();
      if (i + 1 < items) fetch(i + 1);
      if (sub < 2 * nd) {
        if (sub == 0) {
          zero_tile(s);
          zero_tile(dp);
        }
        if (sub < nd)
          logits<T, false>(s, rk, sx, a.d - sub * DC, 0.f);
        else
          logits<T, false>(dp, rv, sx, a.d - (sub - nd) * DC, 0.f);
        if (sub < 2 * nd - 1) continue;
        // p^T (rounded) into s, ds^T into dp; columns are queries
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * t + e;
            const bool ok = q0 + col < a.sq;
            const float l = sl[col], dl = sl[BS + col];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& x = s[j][2 * hr + e];
              float& y = dp[j][2 * hr + e];
              const float p = ok ? __expf(x - l) : 0.f;
              y = elem::round_t<T>(p * (y - dl));
              x = elem::round_t<T>(p);
            }
          }
      } else if (sub < 2 * nd + no) {
        const int c = sub - 2 * nd;
#pragma unroll
        for (int u = 0; u < NOC; ++u)
          if (u == c) value_product<T>(dv[u], s, sx, a.d - (ob + u) * DC);
      } else {
        const int c = sub - 2 * nd - no;
#pragma unroll
        for (int u = 0; u < NOC; ++u)
          if (u == c) value_product<T>(dk[u], dp, sx, a.d - (ob + u) * DC);
      }
    }
    const float one[2] = {1.f, 1.f};
#pragma unroll
    for (int u = 0; u < NOC; ++u)
      if (u < no) {
        store_rows<T, false>(a.out1, dk[u], one, b, row0, a.sk, h, a.h,
                             (ob + u) * DC, a.d, false);
        store_rows<T, false>(a.out2, dv[u], one, b, row0, a.sk, h, a.h,
                             (ob + u) * DC, a.d, false);
      }
  }
}

// dq of the BR queries of tile `tile`, head blockIdx.y; `twopass` rounds
// dq to T before the scale (K3)
template <typename T, int NOC>
__device__ __forceinline__ void dq_tile(const Args<T>& a, int tile,
                                        int twopass) {
  constexpr int RS = raw_stride<T>();
  extern __shared__ float4 smem4[];
  T* const rq = reinterpret_cast<T*>(smem4);  // q chunk, raw
  T* const rd = rq + 64 * RS;                  // dO chunk, raw
  T* const rk = rd + 64 * RS;                  // a k chunk, raw
  T* const rv = rk + 64 * RS;                  // a v chunk, raw
  float2* const sx = reinterpret_cast<float2*>(rv + 64 * RS);
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int q0 = tile * BR;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row0 = q0 + threadIdx.x / 32 * 16 + lane / 4;
  float lse[2], delta[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    const long long li = static_cast<long long>(bh) * a.sq + row;
    lse[hr] = row < a.sq ? a.lse[li] : 0.f;
    delta[hr] = row < a.sq ? a.delta[li] : 0.f;
  }
  const int nd = (a.d + DC - 1) / DC;
  const int nk = (a.sk + BS - 1) / BS;
  for (int ob = 0; ob < nd; ob += NOC) {
    // phases of a key tile: nd of k chunks (s), nd of v chunks (dp), `no`
    // of k chunks (dq)
    const int no = min(NOC, nd - ob), per = 2 * nd + no, items = nk * per;
    // a phase's raw tile; with one chunk the dq phase splits the k tile
    // the s phase copied
    auto fetch = [&](int i) {
      const int k0 = i / per * BS, sub = i % per;
      if (nd == 1 && sub == 2) return;
      const int c = sub < 2 * nd ? sub % nd : ob + sub - 2 * nd;
      const bool v_tile = sub >= nd && sub < 2 * nd;
      stage(v_tile ? rv : rk, v_tile ? a.v : a.k, b, h, k0, a.sk, c * DC,
            a.d);
      cp_async_commit();
    };
    float s[8][4], dp[8][4], dq[NOC][8][4];
    zero(dq);
    __syncthreads();
    fetch(0);
    for (int i = 0; i < items; ++i) {
      const int k0 = i / per * BS, sub = i % per;
      cp_async_wait_all();
      __syncthreads();
      if (sub < 2 * nd && (nd > 1 || i < 2)) {
        // this chunk of the CTA's q (or dO) rows, raw
        stage(sub < nd ? rq : rd, sub < nd ? a.q : a.dout, b, h, q0, a.sq,
              sub % nd * DC, a.d);
        cp_async_commit();
        cp_async_wait_all();
      }
      if (sub < 2 * nd)
        split_rows<T, false>(sx, sub < nd ? rk : rv, 0.f);
      else
        split_cols<T, false>(sx, rk, 0.f);
      __syncthreads();
      if (i + 1 < items) fetch(i + 1);
      if (sub < 2 * nd) {
        if (sub == 0) {
          zero_tile(s);
          zero_tile(dp);
        }
        if (sub < nd)
          logits<T, true>(s, rq, sx, a.d - sub * DC, a.scale);
        else
          logits<T, false>(dp, rd, sx, a.d - (sub - nd) * DC, 0.f);
        if (sub < 2 * nd - 1) continue;
        // ds into s; columns are keys
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const bool ok = k0 + 8 * j + 2 * t + e < a.sk;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& x = s[j][2 * hr + e];
              x = ok ? elem::round_t<T>(__expf(x - lse[hr]) *
                                        (dp[j][2 * hr + e] - delta[hr]))
                     : 0.f;
            }
          }
      } else {
        const int c = sub - 2 * nd;
#pragma unroll
        for (int u = 0; u < NOC; ++u)
          if (u == c) value_product<T>(dq[u], s, sx, a.d - (ob + u) * DC);
      }
    }
    const float scale[2] = {a.scale, a.scale};
#pragma unroll
    for (int u = 0; u < NOC; ++u)
      if (u < no)
        store_rows<T, false>(a.out0, dq[u], scale, b, row0, a.sq, h, a.h,
                             (ob + u) * DC, a.d, twopass != 0);
  }
}

// dk/dv (blockIdx.z 0, a tile of BR keys a CTA) and dq (blockIdx.z 1, BR
// queries) in one grid, (max(ceil(Sk / BR), ceil(Sq / BR)), B*H, 2), so
// that the dq CTAs fill the SMs the dk/dv CTAs' last wave leaves idle;
// bwd_smem<T>()
template <typename T, int NOC>
__global__ void __launch_bounds__(THREADS, 2) bwd_kernel(Args<T> a,
                                                          int twopass) {
  if (blockIdx.z == 0) {
    if (blockIdx.x * BR < a.sk) dkdv_tile<T, NOC>(a, blockIdx.x);
  } else if (blockIdx.x * BR < a.sq) {
    dq_tile<T, NOC>(a, blockIdx.x, twopass);
  }
}

template <typename T, int NOC>
int launch_bwd(const Args<T>& a, int mode, cudaStream_t st) {
  constexpr int bytes = bwd_smem<T>();
  const cudaError_t err = allow_smem(bwd_kernel<T, NOC>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((a.sk > a.sq ? a.sk : a.sq) + BR - 1) / BR, a.b * a.h, 2);
  bwd_kernel<T, NOC><<<grid, THREADS, bytes, st>>>(a, mode == 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flashgen

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
  return elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    Args<T> a{view<T>(q, strides, b, sq, h, d),
              view<T>(k, strides + 4, b, sk, h, d),
              view<T>(v, strides + 8, b, sk, h, d),
              view<T>(o, strides + 12, b, sq, h, d),
              view<T>(dout, strides + 16, b, sq, h, d),
              static_cast<T*>(dq),
              static_cast<T*>(dk),
              static_cast<T*>(dv),
              const_cast<float*>(static_cast<const float*>(lse)),
              static_cast<float*>(delta),
              b,
              sq,
              sk,
              h,
              d,
              scale};
    const long long rows = static_cast<long long>(b) * h * sq;
    const int per_block = THREADS / 32;
    delta_kernel<T><<<static_cast<unsigned>((rows + per_block - 1) /
                                            per_block),
                      THREADS, 0, st>>>(a, mode == 2);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return d > DC ? launch_bwd<T, 2>(a, mode, st)
                  : launch_bwd<T, 1>(a, mode, st);
  });
}
