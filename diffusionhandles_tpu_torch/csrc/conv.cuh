// The host entry of conv.cu's 3x3 implicit-GEMM conv (K7), for the other
// sources of its library (gn_conv.cu runs K9's GEMMs through it).
#pragma once

#include <cuda_runtime.h>

namespace conv {

// Errors run() reports besides cudaError_t values.
constexpr int ERR_NO_ENCODE = 1001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 1002;     // a tensor map was refused
constexpr int ERR_PLAN = 1003;       // a plan this file has no kernel for

// One conv GEMM over channels-last tensors of T (bf16 or fp16; conv.cu
// instantiates both): the forward (dx = false, src = x [b, h, wd, ci]) or
// the input gradient (dx = true, src = dy [b, h, wd, co]), w [co, 3, 3, ci].
// The output has nch = co (forward) or ci (dx) channels per pixel. With
// f32_out, each of the `splits` K ranges writes its fp32 partial sums to
// part ([splits][b*h*wd][nch]) and out is unused; otherwise out gets T
// [b, h, wd, nch], through part (splits * b*h*wd*nch fp32 values) and a
// fixed-order sum when splits > 1. The plan: nwg consumer warpgroups, N
// tile bn, pixel box bw x bh x bb.
template <typename T>
int run(bool dx, const void* src, const void* w, void* out, float* part,
        bool f32_out, int b, int h, int wd, int ci, int co, int nwg, int bn,
        int bw, int bh, int bb, int splits, cudaStream_t st);

// The general conv GEMM (conv_general.cu: tf32 on the tensor cores, fp32
// as three passes) for what run() has no kernel for: activations and
// weight of dtype code dt (elem.cuh), any ci and co, the same operands,
// directions and output contract as run() (f32_out: every split's fp32
// partials in part), dense channels-last. The plan as run()'s: nwg
// consumer warpgroups, N tile bn, pixel box bw x bh x bb, `splits` K
// ranges. Returns the launches' cudaError_t, one of the errors above, or
// elem.cuh's ERR_DTYPE.
int run_general(int dt, bool dx, const void* src, const void* w, void* out,
                float* part, bool f32_out, int b, int h, int wd, int ci,
                int co, int nwg, int bn, int bw, int bh, int bb, int splits,
                cudaStream_t st);

}  // namespace conv
