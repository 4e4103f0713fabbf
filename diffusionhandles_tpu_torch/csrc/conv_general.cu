// The general 3x3 SAME stride-1 conv, forward and input gradient: K7's
// implicit GEMM (conv.cu) for what its TMA + wgmma kernel is not built for,
// so that every conv the routing gate admits runs a kernel on the card:
// fp32 activations (conv.cu's wgmma products take bf16 and fp16), and
// channel counts that are not multiples of 8 (TMA takes global strides in
// 16-byte units). Same operands as conv.cu: channels-last
// (NHWC) activations, the weight as [Co][9][Ci], fp32 accumulation; the
// output rounded once to the activations' type, or left in fp32 (the input
// gradient of gn_conv.cu's general instance).
//
//   forward: M = B*H*W output pixels, N = Co, K = 9*Ci,
//            A[m][(t, c)] = x[pixel m shifted by tap t][c],
//            B[(t, c)][n] = w[n][t][c];
//   dx:      M = B*H*W input pixels, N = Ci, K = 9*Co,
//            A[m][(t, c)] = dy[pixel m shifted by tap t][c],
//            B[(t, c)][n] = w[c][8 - t][n] (the flipped, transposed kernel).
//
// A first, plain design on the CUDA cores: a CTA of 256 threads owns a
// 64-pixel x 64-channel output tile, stages 16-deep K slices of A (zero
// outside the image: the halo) and B in shared memory as fp32, the next
// slice's loads held in registers while the current one is summed, and
// each thread sums a 4 x 4 block of outputs with fused multiply-adds, the
// K terms in order. Bound on this card: the operations, 2*B*H*W*9*Ci*Co at
// the fp32 rate of the CUDA cores (67 TFLOP/s; the tensor cores' tf32 and
// fp16 rates are what a faster instance would reach for).
#include "conv.cuh"
#include "elem.cuh"

namespace conv {
namespace {

constexpr int GM = 64;    // output pixels of a CTA
constexpr int GN = 64;    // output channels of a CTA
constexpr int GK = 16;    // K terms a step
constexpr int GT = 256;   // threads: 16 x 16, each 4 x 4 outputs

template <typename T, bool DX, bool F32_OUT>
__global__ void __launch_bounds__(GT)
    general_kernel(const T* __restrict__ src, const T* __restrict__ w,
                   void* __restrict__ out, int b, int h, int wd, int ka,
                   int nch) {
  __shared__ __align__(16) float as[GK][GM + 4];
  __shared__ __align__(16) float bs[GK][GN + 4];
  const int m_all = b * h * wd, k_all = 9 * ka;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  // This thread's loads: A's K term tid % GK at pixels tid / GK + 16 j;
  // B's the same K term at channels tid / GK + 16 j (forward), or channel
  // tid % GN at K terms tid / GN + 4 j (dx: the weight's contiguous dim is
  // N). The pixels' coordinates are found once.
  int img[4], py[4], px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + tid / GK + 16 * j;
    img[j] = m / (wd * h);
    py[j] = m < m_all ? m / wd % h : -2;  // out of range at every tap
    px[j] = m % wd;
  }
  float ra[4], rb[4];
  auto load = [&](int k0) {
    const int k = k0 + tid % GK;
    const int tap = k / ka, c = k - tap * ka;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sy = py[j] + dy, sx = px[j] + dx;
      ra[j] = k < k_all && sy >= 0 && sy < h && sx >= 0 && sx < wd
                  ? elem::to_f(src[(static_cast<long long>(img[j] * h + sy) *
                                        wd + sx) * ka + c])
                  : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!DX) {
        const int n = n0 + tid / GK + 16 * j;
        rb[j] = k < k_all && n < nch
                    ? elem::to_f(w[(static_cast<long long>(n) * 9 + tap) * ka
                                   + c])
                    : 0.f;
      } else {
        const int n = n0 + tid % GN;
        const int kb = k0 + tid / GN + 4 * j;
        const int tb = kb / ka, cb = kb - tb * ka;
        rb[j] = kb < k_all && n < nch
                    ? elem::to_f(w[(static_cast<long long>(cb) * 9 + 8 - tb) *
                                   nch + n])
                    : 0.f;
      }
    }
  };
  float acc[4][4] = {};
  load(0);
  for (int k0 = 0; k0 < k_all; k0 += GK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      as[tid % GK][tid / GK + 16 * j] = ra[j];
      if (!DX)
        bs[tid % GK][tid / GK + 16 * j] = rb[j];
      else
        bs[tid / GN + 4 * j][tid % GN] = rb[j];
    }
    __syncthreads();
    // the next step's loads fly while this step's products run
    if (k0 + GK < k_all) load(k0 + GK);
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[kk][tm * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[kk][tn * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(a[i], bb[jj], acc[i][jj]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= m_all) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tn * 4 + jj;
      if (n >= nch) continue;
      const long long o = static_cast<long long>(m) * nch + n;
      if (F32_OUT)
        static_cast<float*>(out)[o] = acc[i][jj];
      else
        static_cast<T*>(out)[o] = elem::from_f<T>(acc[i][jj]);
    }
  }
}

template <typename T, bool DX>
void launch(const void* src, const void* w, void* out, bool f32_out, int b,
            int h, int wd, int ka, int nch, cudaStream_t st) {
  const dim3 grid((b * h * wd + GM - 1) / GM, (nch + GN - 1) / GN);
  const T* s = static_cast<const T*>(src);
  const T* wt = static_cast<const T*>(w);
  if (f32_out)
    general_kernel<T, DX, true><<<grid, GT, 0, st>>>(s, wt, out, b, h, wd, ka,
                                                     nch);
  else
    general_kernel<T, DX, false><<<grid, GT, 0, st>>>(s, wt, out, b, h, wd,
                                                      ka, nch);
}

}  // namespace

int run_general(int dt, bool dx, const void* src, const void* w, void* out,
                bool f32_out, int b, int h, int wd, int ci, int co,
                cudaStream_t st) {
  return elem::dispatch(dt, [&](auto tag) {
    using T = decltype(tag);
    if (dx)
      launch<T, true>(src, w, out, f32_out, b, h, wd, co, ci, st);
    else
      launch<T, false>(src, w, out, f32_out, b, h, wd, ci, co, st);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace conv

// K7's general route: the forward (dx = 0; src = x [b, h, wd, ci], out y
// [b, h, wd, co]) or the input gradient (dx = 1; src = dy [b, h, wd, co],
// out dx [b, h, wd, ci]), w [co, 3, 3, ci], all dense channels-last of
// dtype code dt (elem.cuh). Returns the launch's cudaError_t, or
// elem.cuh's ERR_DTYPE.
extern "C" int conv3x3_general(int dt, int dx, const void* src,
                               const void* w, void* out, int b, int h, int wd,
                               int ci, int co, void* stream) {
  return conv::run_general(dt, dx != 0, src, w, out, false, b, h, wd, ci, co,
                           static_cast<cudaStream_t>(stream));
}
