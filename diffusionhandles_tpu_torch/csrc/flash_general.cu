// The general flash-attention forward: the flash forward's function
// (flash_fwd.cu) for what its TMA + wgmma kernel is not built for, so that
// every call the routing gate admits runs a kernel on the card: fp32
// operands (that kernel takes bf16 and fp16) and any head dim (it is built
// for 64). The backward is flash_general_bwd.cu; the tiles and products
// both use are in flash_general.cuh.
//
// Replaces, for those calls, the JAX package's forward kernels
// (diffusionhandles_tpu/ops/attention.py): _flash_onepass_fold_kernel
// (K1, :115), _flash_kernel (K4, :80) and _flash_onepass_kernel (K5,
// :136). Same function and rounding points as the plain versions in
// ops/attention.py, with T the operands' type: q_s = T(q * scale);
// s = q_s . k in fp32; a running row max m and row sum l over key tiles,
// p = exp(s - m) rounded to T for the value product, the row sum over the
// rounded p (K1) or the fp32 p (F32_SUM: K4, K5); o = T(acc / l),
// lse = m + log(l). q, k and v are read as [B, S, H, D] views through
// their element strides; O is written dense [B, S, H, D], lse [B*H, Sq].
//
// Bound on this card: the operations, 4*B*H*Sq*Sk*D (the two products):
// at [1,4096,5,64] 21.5 GFLOP, 0.32 ms on the CUDA cores' fp32 rate (67
// TFLOP/s) and 0.13 ms as three TF32 passes on the tensor cores (495
// TFLOP/s). The design (flash_general.cuh has the tiles and products):
//   - both products on the tensor cores, fp32 as 3xTF32 (about 2**-21
//     relative a product, where one TF32 pass gives 2**-11), 16-bit
//     instances in one exact pass;
//   - a CTA of four or five warps owns 16 query rows a warp and walks the
//     keys in tiles of 64 (flash_general.cuh has the tiles). Its q rows
//     stay raw in shared memory (copied once where the head dim is one
//     chunk) and are split as A fragments; each k tile, copied by cp.async
//     while the previous phase computes, is split once into (hi, lo) pairs
//     laid out for 16-byte fragment loads, so the inner loops are loads
//     and mma only. s = q_s . k^T chunk by chunk, the online softmax on
//     the s fragments in registers (quad shuffles), then each v chunk,
//     split transposed, into o += p . v, p read in place from the s
//     fragments (v's rows in the fragment's column order), each tile
//     summed in a fresh accumulator (the tensor cores truncate);
//   - the whole head dim stays in the CTA: o holds NOC chunks of 64
//     columns in registers (1-3: up to 192); a head dim past that is
//     walked in passes of NOC chunks, each recomputing the logits;
//   - an SM's CTAs share its tensor cores and shared memory, so the time
//     is that of the SM with the most query rows. Four warps (two raw
//     tiles and one of pairs, 70 KB fp32) fit three CTAs an SM, five two;
//     the launch takes the one that leaves the busiest SM fewer rows: at
//     [1,4096,5,64] five (260 CTAs, 160 rows) against four (320 CTAs,
//     192 rows on 56 SMs).
// What holds it at ~6x the 3xTF32 bound (PERF.md, Findings): shared-memory
// traffic (every warp reads 8 bytes an element of each split tile, beside
// the tiles' copies and splits) together with mma.sync's rate; wgmma,
// which reads B from shared memory itself, is the next step.
#include "flash_general.cuh"

namespace flashgen {

// The shared memory of a CTA of NW warps: its q rows and one streamed
// tile raw, one tile of pairs
template <typename T, int NW>
constexpr int fwd_smem() {
  return (16 * NW + BS) * raw_stride<T>() * static_cast<int>(sizeof(T)) +
         TILE_BYTES;
}

// A CTA of NW warps owns 16 NW query rows: grid (ceil(Sq / (16 NW)),
// B*H); fwd_smem<T, NW>(). Four warps fit three CTAs an SM, five two.
template <typename T, bool F32_SUM, int NOC, int NW>
__global__ void __launch_bounds__(32 * NW, NOC > 1 ? 1 : NW == 4 ? 3 : 2)
    fwd_kernel(Args<T> a) {
  constexpr int NT = 32 * NW, BQ = 16 * NW;
  extern __shared__ float4 smem4[];
  T* const rq = reinterpret_cast<T*>(smem4);  // q chunk, raw
  T* const rx = rq + BQ * raw_stride<T>();    // the next k or v chunk, raw
  float2* const sx = reinterpret_cast<float2*>(rx + BS * raw_stride<T>());
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row0 = q0 + threadIdx.x / 32 * 16 + lane / 4;
  const int nd = (a.d + DC - 1) / DC;   // head-dim chunks
  const int nk = (a.sk + BS - 1) / BS;  // key tiles
  for (int ob = 0; ob < nd; ob += NOC) {
    // phases of a key tile: nd of k chunks (logits), `no` of v chunks
    const int no = min(NOC, nd - ob), per = nd + no, items = nk * per;
    auto fetch = [&](int i) {
      const int k0 = i / per * BS, sub = i % per;
      if (sub < nd)
        stage<T, NT>(rx, a.k, b, h, k0, a.sk, sub * DC, a.d);
      else
        stage<T, NT>(rx, a.v, b, h, k0, a.sk, (ob + sub - nd) * DC, a.d);
      cp_async_commit();
    };
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[8][4], o[NOC][8][4];
    zero(o);
    __syncthreads();  // the previous pass is done with the tiles
    fetch(0);
    for (int i = 0; i < items; ++i) {
      const int k0 = i / per * BS, sub = i % per;
      cp_async_wait_all();
      __syncthreads();  // tile i landed; every warp is done with phase i - 1
      if (sub < nd && (nd > 1 || i == 0)) {
        stage<T, NT, BQ>(rq, a.q, b, h, q0, a.sq, sub * DC, a.d);
        cp_async_commit();
        cp_async_wait_all();
      }
      if (sub < nd)
        split_rows<T, false, NT>(sx, rx, 0.f);
      else
        split_cols<T, false, NT>(sx, rx, 0.f);
      __syncthreads();  // the split tile (and q) are ready, rx is free
      if (i + 1 < items) fetch(i + 1);
      if (sub < nd) {
        if (sub == 0) zero_tile(s);
        logits<T, true>(s, rq, sx, a.d - sub * DC, a.scale);
        if (sub < nd - 1) continue;
        // the online softmax of this key tile: rows row0 (hr 0), row0 + 8
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[j][2 * hr + e];
              if (k0 + 8 * j + 2 * t + e >= a.sk) x = -INFINITY;
              mx = fmaxf(mx, x);
            }
          const float m_new = fmaxf(m[hr], quad_max(mx));
          const float alpha = __expf(m[hr] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[j][2 * hr + e];
              const float p = __expf(x - m_new);
              x = elem::round_t<T>(p);
              sum += F32_SUM ? p : x;
            }
          l[hr] = l[hr] * alpha + sum;
          m[hr] = m_new;
#pragma unroll
          for (int u = 0; u < NOC; ++u)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              o[u][n][2 * hr] *= alpha;
              o[u][n][2 * hr + 1] *= alpha;
            }
        }
      } else {
        const int c = sub - nd;
#pragma unroll
        for (int u = 0; u < NOC; ++u)
          if (u == c)
            value_product<T>(o[u], s, sx, a.d - (ob + u) * DC);
      }
    }
    // each thread summed its own columns: the quad's sum is the row's
    const float lr[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
    for (int u = 0; u < NOC; ++u)
      if (u < no)
        store_rows<T, true>(a.out0, o[u], lr, b, row0, a.sq, h, a.h,
                            (ob + u) * DC, a.d, false);
    if (ob == 0 && t == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (row0 + 8 * hr < a.sq)
          a.lse[static_cast<long long>(bh) * a.sq + row0 + 8 * hr] =
              m[hr] + logf(lr[hr]);
    }
  }
}

template <typename T, bool F32_SUM, int NOC, int NW>
int launch_fwd_noc(const Args<T>& a, cudaStream_t st) {
  constexpr int bytes = fwd_smem<T, NW>();
  const cudaError_t err = allow_smem(fwd_kernel<T, F32_SUM, NOC, NW>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.sq + 16 * NW - 1) / (16 * NW), a.b * a.h);
  fwd_kernel<T, F32_SUM, NOC, NW><<<grid, 32 * NW, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Query rows on the busiest SM with CTAs of nw warps (16 nw rows), the
// CTAs spread evenly over the card's SMs: the forward's time where an SM's
// CTAs share its tensor cores and shared memory
inline long long busiest_rows(int b, int h, int sq, int nw, int sms) {
  const long long ctas =
      static_cast<long long>((sq + 16 * nw - 1) / (16 * nw)) * b * h;
  return (ctas + sms - 1) / sms * 16 * nw;
}

// The instance whose o holds the head dim's chunks, or three a pass; at
// one chunk, CTAs of five warps where they leave the busiest SM fewer rows
template <typename T, bool F32_SUM>
int launch_fwd(const Args<T>& a, cudaStream_t st) {
  switch ((a.d + DC - 1) / DC) {
    case 1: {
      int dev = 0, sms = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      return busiest_rows(a.b, a.h, a.sq, 5, sms) <
                     busiest_rows(a.b, a.h, a.sq, 4, sms)
                 ? launch_fwd_noc<T, F32_SUM, 1, 5>(a, st)
                 : launch_fwd_noc<T, F32_SUM, 1, 4>(a, st);
    }
    case 2:
      return launch_fwd_noc<T, F32_SUM, 2, 4>(a, st);
    default:
      return launch_fwd_noc<T, F32_SUM, 3, 4>(a, st);
  }
}

}  // namespace flashgen

// The forward (K1; K4/K5 with f32_sum): q [b, sq, h, d], k and v
// [b, sk, h, d] of dtype code dt (elem.cuh), read through `strides` (their
// (sb, ss, sh, sd) in elements, q's then k's then v's); o dense
// [b, sq, h, d] of the same type, lse [b*h, sq] fp32; scale = 1/sqrt(d).
// Returns the launch's cudaError_t, or elem.cuh's ERR_DTYPE.
extern "C" int flash_general_fwd(int dt, const void* q, const void* k,
                                 const void* v, void* o, void* lse,
                                 const long long* strides, int b, int sq,
                                 int sk, int h, int d, int f32_sum,
                                 float scale, void* stream) {
  using namespace flashgen;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    Args<T> a{view<T>(q, strides, b, sq, h, d),
              view<T>(k, strides + 4, b, sk, h, d),
              view<T>(v, strides + 8, b, sk, h, d),
              {},
              {},
              static_cast<T*>(o),
              nullptr,
              nullptr,
              static_cast<float*>(lse),
              nullptr,
              b,
              sq,
              sk,
              h,
              d,
              scale};
    return f32_sum ? launch_fwd<T, true>(a, st) : launch_fwd<T, false>(a, st);
  });
}
