// The foreground guidance loss's weighted L1 term and its gradient, for
// Hopper (sm_90a): one launch a direction, fp32 throughout.
//
//   forward:  S[c] = sum over live slots s of w_s * |f1[c, s] - f2[c, k_s]|
//   backward: grad_f2[c, k] = -g[c] * sum over the slots s of cell k of
//             w_s * sign(f1[c, s] - f2[c, k])   (sign(0) = 0)
//
// f2 is the current feature map [C, H*W] (fp32, the pooled map the loss
// compares), f1 the orig features at the slots, channel-major [C, ld] in
// slot order, k_s the transformed cell of slot s, w_s its multiplicity
// weight. The slots come sorted by transformed cell once per edit
// (guidance.fg_slot_order): live slots first, cell k's run at
// [offsets[k], offsets[k+1]), offsets[H*W] the live count. The kernels read
// the live count from device memory, so the launch never depends on the
// data and the pair can be captured in a CUDA graph.
//
// Replaces no TPU kernel: the JAX package leaves the gather of guidance.py's
// foreground loss to XLA. On the card, autograd's backward of that gather
// was ATen's index_put_(accumulate=True) over C x max_corr keys, a sort and
// a serial sum of each run of equal keys, the empty slots all piling on
// cell (0, 0).
//
// Bound: memory. An element costs a few operations against 4 bytes of f2
// read and 4 of its gradient written; the orig rows are max_corr x C x 4
// bytes at most (SD-2's three terms: 37 + 37 + at most 147 MB an iteration,
// about 0.07 ms at 3.35 TB/s). Design:
//   forward, a block per channel: its threads stride over the live slots,
//     reading f1's row and the slot weights along the slots and f2 at the
//     slots' cells, which ascend with the slots; each thread's partial, then
//     a warp shuffle tree and the warps' partials summed in warp order.
//   backward, a thread per output element (c, k), neighbouring threads on
//     neighbouring cells: it sums cell k's run, which lies next to its
//     neighbours' runs in f1's row, and writes its element once (0 where
//     the cell has no slot).
// No atomics and a fixed order of every sum: two calls give the same bits.
#include <cuda_runtime.h>

#include <cstdint>

namespace fg {

constexpr int FWD_THREADS = 256;
constexpr int BWD_THREADS = 256;

__global__ void __launch_bounds__(FWD_THREADS)
    l1_fwd(const float* __restrict__ f1, const float* __restrict__ f2,
           const int* __restrict__ cells, const float* __restrict__ w,
           const int* __restrict__ offsets, int hw, int ld,
           float* __restrict__ out) {
  const int c = blockIdx.x;
  const int n = offsets[hw];
  const float* f1c = f1 + static_cast<size_t>(c) * ld;
  const float* f2c = f2 + static_cast<size_t>(c) * hw;
  float acc = 0.f;
  for (int s = threadIdx.x; s < n; s += FWD_THREADS)
    acc += w[s] * fabsf(f1c[s] - f2c[cells[s]]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float part[FWD_THREADS / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < FWD_THREADS / 32; ++i) total += part[i];
    out[c] = total;
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
    l1_bwd(const float* __restrict__ f1, const float* __restrict__ f2,
           const float* __restrict__ w, const int* __restrict__ offsets,
           const float* __restrict__ g, int hw, int ld, int64_t total,
           float* __restrict__ grad) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * BWD_THREADS +
                    threadIdx.x;
  if (i >= total) return;
  const int c = static_cast<int>(i / hw);
  const int k = static_cast<int>(i - static_cast<int64_t>(c) * hw);
  const int lo = offsets[k];
  const int hi = offsets[k + 1];
  float acc = 0.f;
  if (lo < hi) {
    const float v = f2[i];
    const float* f1c = f1 + static_cast<size_t>(c) * ld;
    for (int s = lo; s < hi; ++s) {
      const float d = f1c[s] - v;
      acc += w[s] * static_cast<float>((d > 0.f) - (d < 0.f));
    }
  }
  grad[i] = acc != 0.f ? -g[c] * acc : 0.f;
}

}  // namespace fg

// out [C] = the forward's S; f1 [C, ld], f2 [C, hw], cells and w [ld],
// offsets [hw + 1]. Returns the launch's CUDA error code.
extern "C" int fg_l1_fwd(const void* f1, const void* f2, const void* cells,
                         const void* w, const void* offsets, int c, int hw,
                         int ld, void* out, void* stream) {
  fg::l1_fwd<<<c, fg::FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const int*>(cells), static_cast<const float*>(w),
      static_cast<const int*>(offsets), hw, ld, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// grad [C, hw] = the backward's grad_f2 for the gradient g [C] of S.
extern "C" int fg_l1_bwd(const void* f1, const void* f2, const void* w,
                         const void* offsets, const void* g, int c, int hw,
                         int ld, void* grad, void* stream) {
  const int64_t total = static_cast<int64_t>(c) * hw;
  const unsigned blocks = static_cast<unsigned>(
      (total + fg::BWD_THREADS - 1) / fg::BWD_THREADS);
  fg::l1_bwd<<<blocks, fg::BWD_THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(w), static_cast<const int*>(offsets),
      static_cast<const float*>(g), hw, ld, total,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}
