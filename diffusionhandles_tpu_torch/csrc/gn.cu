// GroupNorm(+SiLU) forward and backward for Hopper (sm_90a), one kernel
// launch per direction: x read in place, channels-last (NHWC) or NCHW, y
// and dx written in the same layout, fp32 statistics, the parameters read
// in their own dtype.
//
// Replaces the JAX package's ops/groupnorm.py:_gn_fwd_kernel and
// _gn_bwd_kernel (launched by _fwd_impl / _bwd_impl). Each TPU kernel makes
// two passes over a (B, 2, S/bs) grid that runs in order on one core and
// carries the channel sums from the first pass to the second in VMEM
// scratch. Here blocks run in parallel, so the unit of work is one
// thread-block cluster per (image b, channel slab): a slab is a set of
// whole groups (ops/groupnorm.py:plan_gn picks it: channels-last, the
// fewest whole groups whose pixel row is a multiple of 16 bytes; NCHW, one
// group), and each CTA of the cluster holds one pixel range of the slab in
// shared memory. A CTA
//   1. copies its tile in once (16-byte cp.async; for the backward x and
//      dy), loading the parameters while the copy is in flight,
//   2. forms per-channel fp32 partials in a fixed order (forward: sum x and
//      sum of x*x rounded to x's type; backward: u = sum T(dz), v = sum
//      T(dz*xh)): each warp sums a column of the tile (channels-last: a
//      16-byte vector of channels down the pixels; NCHW: a channel) over
//      its share of the rows, then a shuffle sum,
//   3. pushes them into every rank's shared memory (mapa +
//      st.shared::cluster, a row per rank) once every rank has started (a
//      cluster barrier arrived at as the copy is issued, waited on before
//      the push), then passes a second cluster barrier (arrive.release,
//      wait.acquire); every rank then sums the rows in rank order and forms
//      the same per-channel totals and per-group statistics (mean and rsig;
//      t1 and t2). No shared memory of a peer is touched after the second
//      barrier, so no CTA waits for its peers to exit,
//   4. normalizes (SiLU when asked) or forms dx from the tile still in
//      shared memory, and stores it with 16-byte stores.
// Rank 0 writes mean and rsig [2, B, G] (forward) or u and v [2, B, C]
// (backward; dbeta and dgamma are their sums over b). No atomics: two calls
// give the same bits. A cluster of one is a plain launch with no barrier.
//
// A slab too large for any cluster's shared memory takes the streaming plan
// of the same kernel: a statistics launch (the CTAs loop over their pixel
// range in chunks, accumulating the partials, and the cluster writes the
// statistics to global memory), then an apply launch over the same chunks.
//
// Bound: a few operations per element against 2 bytes read and 2 written
// (forward; backward reads x and dy), far below the card's flop:byte
// balance, so it is bound by memory: each element is read once and written
// once (the earlier version of this kernel read x twice, in three launches
// a direction). At the U-Net's sizes (0.3-2.6 MB a call) it is bound by
// latency: a CTA's phases (copy in, partial sums, exchange, statistics,
// normalize and store) run one after another, each behind a barrier.
//
// Rounding points are the TPU kernel's: x*x and the gradient products are
// rounded to x's type before the fp32 sums, the variance is clamped at 0.
// The kernel is a template over the types of x and y (elem.cuh) and the
// layout: the bf16 instance is the pipeline's, the fp32 and fp16 instances
// (and bf16 x with another y) serve the general route.
#include "gn_common.cuh"

namespace gn {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_MAX = 232448;  // a CTA's shared memory on sm_90
constexpr int MAX_CLUSTER = 16;   // non-portable cluster size limit
constexpr int PIXELS = 8;         // pixel ranges and chunks are multiples
constexpr int ERR_ARGS = 1;       // cudaErrorInvalidValue

enum Mode { FUSED = 0, STATS = 1, APPLY = 2 };

struct Args {
  const void* x;
  const void* dy;      // backward
  const void* gamma;   // [C] of dtype code pdt
  const void* beta;
  void* out;           // y (forward) or dx (backward), x's layout
  float* stats;        // forward out: mean at stats, rsig at stats + B*G
  const float* mean;   // backward in, [B, G]
  const float* rsig;
  float* uv;           // backward out: u at uv, v at uv + B*C
  float* t12;          // backward, streaming: t1 at t12, t2 at t12 + B*G
  int b, c, s, groups;
  int slab;            // channels of one cluster's unit (whole groups)
  int ctas;            // CTAs sharing a slab (the cluster, unless APPLY)
  int ppc;             // pixels per CTA, a multiple of PIXELS
  int chunk;           // pixels per shared-memory tile (ppc unless streaming)
  int mode, act, pdt;
  float eps;
  // set by run() from the above: channels a group, groups a slab, columns
  // of the partial sums and the warps that share one, jobs (columns x
  // parts), the shared-memory layout
  int cg, ng, cols, parts, jobs;
  int red, recv, chan;
};

// Byte offsets of the shared-memory regions of one CTA. The planner asks
// for `bytes` on the card (gn_smem_bytes); ops/groupnorm.py's smem_bytes
// is its copy for planning off the card, and must agree.
struct Smem {
  int red, recv, chan, bytes;
};

// The warps that share one column of the partial sums: a column is a
// channel (NCHW) or a 16-byte vector of channels (channels-last).
inline int parts_of(int cols) {
  return cols >= WARPS ? 1 : WARPS / cols;
}

inline Smem smem_layout(int es, bool cl, bool bwd, int slab, int chunk,
                        int ctas) {
  Smem m;
  const int tile = chunk * slab * es * (bwd ? 2 : 1);
  const int parts = parts_of(cl ? slab * es / 16 : slab);
  // sums are kept per column: [column][2 sums][W channels of a column]
  m.red = tile;                               // [parts][...]: warps' sums
  m.recv = m.red + 4 * 2 * slab * parts;      // [ctas][...]: pushed
  m.chan = m.recv + (ctas > 1 ? 4 * 2 * slab * ctas : 0);
  m.bytes = m.chan + 4 * (bwd ? 6 : 4) * slab;  // per channel, see below
  return m;
}

__device__ __forceinline__ float load_param(const void* p, int code, int i) {
  if (code == elem::ELEM_F32) return static_cast<const float*>(p)[i];
  if (code == elem::ELEM_F16)
    return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

// an arrival that orders no memory: the start barrier's
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Store v at `p` in the shared memory of cluster rank `rank`
__device__ __forceinline__ void st_rank(float* p, uint32_t rank, float v) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))),
                 "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

// 4 bytes of U from o (two 16-bit values, the first in the low half, or
// one fp32)
template <typename U>
__device__ __forceinline__ uint32_t word(const float* o) {
  if constexpr (sizeof(U) == 4) {
    return __float_as_uint(o[0]);
  } else if constexpr (std::is_same_v<U, __half>) {
    const __half2 h = __floats2half2_rn(o[0], o[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(o[0], o[1]);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}

// E values rounded to U stored at p (global, aligned to their size) as
// 16-byte vector stores (one 8-byte store where they make 8 bytes):
// written out, since the compiler split elem::store's 16-byte store into
// four 4-byte ones here, four times the transactions on the channels-last
// tile's strided rows.
template <typename U, int E>
__device__ __forceinline__ void store_out(U* p, const float (&o)[E]) {
  constexpr int PW = 4 / static_cast<int>(sizeof(U));  // values a word
  constexpr int WORDS = E / PW;
  static_assert(WORDS % 4 == 0 || WORDS == 2, "8 or 16n bytes a vector");
  if constexpr (WORDS % 4 == 0) {
#pragma unroll
    for (int w = 0; w < WORDS; w += 4)
      asm volatile("st.global.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"l"(
                       p + w * PW),
                   "r"(word<U>(o + w * PW)), "r"(word<U>(o + (w + 1) * PW)),
                   "r"(word<U>(o + (w + 2) * PW)),
                   "r"(word<U>(o + (w + 3) * PW))
                   : "memory");
  } else {
    asm volatile("st.global.v2.b32 [%0], {%1, %2};\n" ::"l"(p),
                 "r"(word<U>(o)), "r"(word<U>(o + PW))
                 : "memory");
  }
}

// One chunk of a CTA's pixel range as a dense tile of rows x nc 16-byte
// vectors: channels-last, a row is a pixel (nc vectors of the slab's
// channels); NCHW, a row is a channel (nc vectors of pixels).
struct Chunk {
  int rows, nc;
  long long base, stride;  // element offset of row 0, and between rows
};

template <typename T, bool CL>
__device__ __forceinline__ Chunk chunk_at(const Args& a, long long bi,
                                          int c0, int p0, int np) {
  constexpr int E = 16 / sizeof(T);
  Chunk k;
  if (CL) {
    k.rows = np;
    k.nc = a.slab / E;
    k.base = (bi * a.s + p0) * a.c + c0;
    k.stride = a.c;
  } else {
    k.rows = a.slab;
    k.nc = np / E;
    k.base = (bi * a.c + c0) * a.s + p0;
    k.stride = a.s;
  }
  return k;
}

// The per-element terms of the partial sums: forward (x, round(x*x));
// backward (round(dz), round(dz*xh)) with channel c's parameters in chan.
template <typename T, bool BWD>
__device__ __forceinline__ void terms(float f, float d, int act,
                                      const float* prm, float& t1,
                                      float& t2) {
  if (BWD) {
    // prm: gamma, beta, mean, rsig of the element's channel
    const float xh = (f - prm[2]) * prm[3];
    const float dz = act ? d * silu_grad(xh * prm[0] + prm[1]) : d;
    t1 = elem::round_t<T>(dz);
    t2 = elem::round_t<T>(dz * xh);
  } else {
    t1 = f;
    t2 = elem::round_t<T>(f * f);
  }
}

// The sum of t over the lanes that differ in the bits of OFF and below.
template <int OFF>
__device__ __forceinline__ float lane_sum(float t) {
  if constexpr (OFF > 0) {
    t += __shfl_xor_sync(0xffffffffu, t, OFF);
    return lane_sum<OFF / 2>(t);
  } else {
    return t;
  }
}

// Sums each of the N values v (N a power of two, at most 32) over the
// warp with N - 1 + 5 - log2(N) shuffles instead of 5 N: at each of the
// first log2(N) steps a lane keeps half of its values and adds its
// partner's copies of them, sending the other half; then the last steps
// sum the one value left. Lane l returns the sum of value l / (32 / N).
// A fixed order: repeatable. (Templates, so that every index is a
// constant and v stays in registers.)
template <int N, int OFF = 16>
__device__ __forceinline__ float warp_sum_scatter(float* v, int lane) {
  if constexpr (N > 1) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float lo = v[i], hi = v[i + N / 2];
      v[i] = (up ? hi : lo) +
             __shfl_xor_sync(0xffffffffu, up ? lo : hi, OFF);
    }
    return warp_sum_scatter<N / 2, OFF / 2>(v, lane);
  } else {
    return lane_sum<OFF>(v[0]);
  }
}

// Calls f(r, v) for the vectors (row r, column v) of a rows x nc tile,
// each once, with no division per vector: nc <= THREADS, thread tid takes
// column tid % nc of rows tid / nc, + THREADS / nc, ...; else the columns
// tid, tid + THREADS, ... of every row.
template <typename F>
__device__ __forceinline__ void for_tile(int rows, int nc, F&& f) {
  const int tid = threadIdx.x;
  if (nc > THREADS) {
    for (int r = 0; r < rows; ++r)
      for (int v = tid; v < nc; v += THREADS) f(r, v);
    return;
  }
  const int per = THREADS / nc;
  if (tid >= per * nc) return;
  const int v = tid % nc;
#pragma unroll 2
  for (int r = tid / nc; r < rows; r += per) f(r, v);
}

template <typename T, typename U, bool CL, bool BWD>
__global__ void __launch_bounds__(THREADS) gn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = 16 / sizeof(T);
  constexpr int W = CL ? E : 1;  // channels of one column of the sums
  // grid: (rank in the cluster, slab, image)
  const int slab = a.slab, cg = a.cg, rank = blockIdx.x;
  const int c0 = blockIdx.y * slab;
  const long long bi = blockIdx.z;
  const long long bg0 = bi * a.groups + blockIdx.y * a.ng;
  const long long bg_all = (long long)a.b * a.groups;
  const int p_begin = rank * a.ppc;
  const int p_end = min(a.s, p_begin + a.ppc);
  const bool clustered = a.mode != APPLY && a.ctas > 1;
  T* tile = reinterpret_cast<T*>(smem);
  T* tile_dy = tile + (size_t)a.chunk * slab;
  float* red = reinterpret_cast<float*>(smem + a.red);
  // red (each warp's sums) and recv (each rank's): by column,
  // [column][2][W], so a channel c's sum s is at (c / W * 2 + s) * W + c % W
  float* recv = reinterpret_cast<float*>(smem + a.recv);
  // chan, per channel: at 0 and 1 the forward's A and B (y = x*A + B) or
  // the backward's t1 and t2; at 2 and 3 (forward) or 2..5 (backward)
  // gamma, beta (, mean, rsig)
  float* chan = reinterpret_cast<float*>(smem + a.chan);
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  U* out = static_cast<U*>(a.out);
  const int tid = threadIdx.x;
  // the warp's index, known to the compiler as uniform across the warp
  // (so the shuffles of the loops over it need no divergence handling)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);

  // issue the copy of the chunk at p0 into the tile
  auto load = [&](int p0) {
    const Chunk k = chunk_at<T, CL>(a, bi, c0, p0, min(a.chunk, p_end - p0));
    for_tile(k.rows, k.nc, [&](int r, int v) {
      const size_t q = (size_t)r * k.nc + v;
      const long long off = k.base + r * k.stride + (long long)v * E;
      cp_async16(tile + q * E, x + off);
      if (BWD) cp_async16(tile_dy + q * E, dy + off);
    });
    return k;
  };

  // y (or dx) of the tile in shared memory: channels-last, a thread's
  // column (its E channels) is fixed, so their coefficients are read once
  auto apply = [&](const Chunk& k) {
    float cf[W][BWD ? 6 : 2];
    bool loaded = false;
    for_tile(k.rows, k.nc, [&](int r, int v) {
      if (!CL || !loaded) {
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const int c = CL ? v * E + j : r;
#pragma unroll
          for (int n = 0; n < (BWD ? 6 : 2); ++n)
            cf[j][n] = chan[n * slab + c];
        }
        loaded = true;
      }
      const size_t q = (size_t)r * k.nc + v;
      float f[E], d[E], o[E];
      elem::load<T, E>(tile + q * E, f);
      if (BWD) elem::load<T, E>(tile_dy + q * E, d);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float* p = cf[CL ? e : 0];
        if (BWD) {
          // p: t1, t2, gamma, beta, mean, rsig
          const float xh = (f[e] - p[4]) * p[5];
          const float dz =
              a.act ? d[e] * silu_grad(xh * p[2] + p[3]) : d[e];
          o[e] = p[5] * (p[2] * dz - p[0] - xh * p[1]);
        } else {
          const float z = f[e] * p[0] + p[1];
          o[e] = a.act ? silu(z) : z;
        }
      }
      store_out<U, E>(out + k.base + r * k.stride + (long long)v * E, o);
    });
  };

  // this chunk's partial sums of job j (warp j % WARPS): column j % cols
  // over part j / cols of its rows (channels-last: pixel rows of a vector
  // column; NCHW: the vectors of a channel), into red[j]
  auto partials = [&](const Chunk& k, int j, bool first) {
    const int col = j % a.cols, pi = j / a.cols, lane = tid % 32;
    float prm[W][4], s[2 * W];  // s: the W first sums, then the W second
#pragma unroll
    for (int i = 0; i < W; ++i) {
      s[i] = s[W + i] = 0.f;
      if (BWD)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          prm[i][n] = chan[(2 + n) * slab + col * W + i];
    }
    const int count = CL ? k.rows : k.nc;
#pragma unroll 2
    for (int r = pi * 32 + lane; r < count; r += a.parts * 32) {
      const size_t q = CL ? (size_t)r * k.nc + col : (size_t)col * k.nc + r;
      float f[E], d[E];
      elem::load<T, E>(tile + q * E, f);
      if (BWD) elem::load<T, E>(tile_dy + q * E, d);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float t1, t2;
        terms<T, BWD>(f[e], BWD ? d[e] : 0.f, a.act, prm[CL ? e : 0], t1,
                      t2);
        s[CL ? e : 0] += t1;
        s[W + (CL ? e : 0)] += t2;
      }
    }
    const float t = warp_sum_scatter<2 * W>(s, lane);
    constexpr int span = 32 / (2 * W);  // lanes holding one value
    if (lane % span == 0) {
      float* dst = red + j * 2 * W + lane / span;
      *dst = first ? t : *dst + t;
    }
  };

  // the first chunk's copy is in flight while the parameters load
  Chunk k{};
  if (p_begin < p_end) k = load(p_begin);
  // a peer's shared memory may be written only once the peer has started:
  // this rank has, so arrive now and wait before the push
  if (clustered) cluster_arrive_relaxed();
  for (int c = tid; c < slab; c += THREADS) {
    const float g = load_param(a.gamma, a.pdt, c0 + c);
    const float bt = load_param(a.beta, a.pdt, c0 + c);
    chan[2 * slab + c] = g;
    chan[3 * slab + c] = bt;
    if (BWD || a.mode == APPLY) {
      const int gi = c / cg;
      const float* st = BWD ? a.mean : a.stats;  // mean, then rsig
      const float m = st[bg0 + gi];
      const float rs = BWD ? a.rsig[bg0 + gi] : a.stats[bg_all + bg0 + gi];
      if (BWD) {
        chan[4 * slab + c] = m;
        chan[5 * slab + c] = rs;
        if (a.mode == APPLY) {
          chan[c] = a.t12[bg0 + gi];
          chan[slab + c] = a.t12[bg_all + bg0 + gi];
        }
      } else {
        chan[c] = rs * g;
        chan[slab + c] = bt - m * rs * g;
      }
    }
  }
  if (p_begin >= p_end && a.mode != APPLY) {
    // no pixels: zero sums
    for (int i = tid; i < 2 * slab * a.parts; i += THREADS) red[i] = 0.f;
  }

  for (int p0 = p_begin; p0 < p_end; p0 += a.chunk) {
    if (p0 != p_begin) {
      __syncthreads();  // the last chunk's readers are done
      k = load(p0);
    }
    cp_async_wait_all();
    __syncthreads();
    if (a.mode == APPLY) {
      apply(k);
    } else {
      for (int j = warp; j < a.jobs; j += WARPS)
        partials(k, j, p0 == p_begin);
    }
  }
  if (a.mode == APPLY) return;
  __syncthreads();
  // this CTA's sum e (by column, as red), its warps' parts in order
  auto cta_sum = [&](int e) {
    float t = red[e];
    for (int pi = 1; pi < a.parts; ++pi) t += red[pi * 2 * slab + e];
    return t;
  };
  if (clustered) {
    cluster_wait();  // every rank has started
    // push this CTA's sums into every rank's recv at this rank's row
    for (int i = tid; i < 2 * slab * a.ctas; i += THREADS) {
      const int r = i / (2 * slab), e = i - r * 2 * slab;
      st_rank(recv + rank * 2 * slab + e, r, cta_sum(e));
    }
    // every push has landed (release / acquire); no CTA reads or writes
    // a peer's shared memory after this, so each may exit when done (and
    // none wrote one before every peer had started)
    cluster_arrive();
    cluster_wait();
    // the cluster's sums, the ranks in order, in place of rank 0's
    for (int e = tid; e < 2 * slab; e += THREADS) {
      float t = recv[e];
      for (int r = 1; r < a.ctas; ++r) t += recv[r * 2 * slab + e];
      recv[e] = t;
    }
    __syncthreads();
  }
  // the totals: the cluster's, or this CTA's own
  auto total = [&](int e) { return clustered ? recv[e] : cta_sum(e); };

  // a warp a group: lane l sums channels l, l + 32, ... of the group (the
  // backward's weighted by gamma), a shuffle sum; rank 0 writes the
  // statistics (and the backward's u and v); in the fused plan each lane
  // then forms its channels' coefficients
  const float n = (float)cg * (float)a.s;
  const int lane = tid % 32;
  for (int gi = warp; gi < a.ng; gi += WARPS) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const int c = gi * cg + j;
      const int at = (c / W * 2) * W + c % W;
      const float t1 = total(at), t2 = total(at + W);
      if (BWD && rank == 0) {
        a.uv[bi * a.c + c0 + c] = t1;
        a.uv[(long long)a.b * a.c + bi * a.c + c0 + c] = t2;
      }
      const float w = BWD ? chan[2 * slab + c] : 1.f;
      s1 += t1 * w;
      s2 += t2 * w;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    float g1, g2;  // mean and rsig, or t1 and t2
    if (BWD) {
      g1 = s1 / n;
      g2 = s2 / n;
    } else {
      g1 = s1 / n;
      g2 = 1.f / sqrtf(fmaxf(s2 / n - g1 * g1, 0.f) + a.eps);
    }
    if (rank == 0 && lane == 0 && (!BWD || a.mode == STATS)) {
      float* dst = BWD ? a.t12 : a.stats;
      dst[bg0 + gi] = g1;
      dst[bg_all + bg0 + gi] = g2;
    }
    for (int j = lane; a.mode == FUSED && j < cg; j += 32) {
      const int c = gi * cg + j;
      if (BWD) {
        chan[c] = g1;
        chan[slab + c] = g2;
      } else {
        const float ag = g2 * chan[2 * slab + c];
        chan[c] = ag;
        chan[slab + c] = chan[3 * slab + c] - g1 * ag;
      }
    }
  }
  if (a.mode != FUSED || p_begin >= p_end) return;
  __syncthreads();
  apply(k);
}

template <typename T, typename U, bool CL, bool BWD>
cudaError_t prepare() {
  // once per instance: the largest dynamic shared memory, clusters of 16
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        gn_kernel<T, U, CL, BWD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(gn_kernel<T, U, CL, BWD>,
                                cudaFuncAttributeNonPortableClusterSizeAllowed,
                                1);
  }();
  return err;
}

inline cudaLaunchConfig_t config(dim3 grid, int cluster, int smem,
                                 cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  // a cluster of one is a plain launch
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// The plan's checks, then one launch (or the streaming plan's two).
template <typename T, typename U, bool CL, bool BWD>
int run(Args a, int streaming, cudaStream_t st) {
  const int es = sizeof(T);
  if (a.groups <= 0 || a.c % a.groups || a.slab <= 0 || a.c % a.slab ||
      a.slab % (a.c / a.groups) || a.s % PIXELS || a.ppc % PIXELS ||
      a.chunk % PIXELS || a.chunk <= 0 || a.ppc <= 0 || a.ctas < 1 ||
      a.ctas > MAX_CLUSTER || (long long)a.ctas * a.ppc < a.s ||
      (!streaming && a.chunk < a.ppc) ||
      (CL && (a.slab * es % 16 || a.slab * es / 16 > THREADS)) ||
      a.c / a.slab > 65535 || a.b > 65535)
    return ERR_ARGS;
  a.cg = a.c / a.groups;
  a.ng = a.slab / a.cg;
  a.cols = CL ? a.slab * es / 16 : a.slab;
  a.parts = parts_of(a.cols);
  a.jobs = a.cols * a.parts;
  const Smem L = smem_layout(es, CL, BWD, a.slab, a.chunk, a.ctas);
  if (L.bytes > SMEM_MAX) return ERR_ARGS;
  a.red = L.red;
  a.recv = L.recv;
  a.chan = L.chan;
  cudaError_t err = prepare<T, U, CL, BWD>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.ctas, a.c / a.slab, a.b);
  cudaLaunchAttribute attr;
  a.mode = streaming ? STATS : FUSED;
  cudaLaunchConfig_t cfg = config(grid, a.ctas, L.bytes, st, &attr);
  err = cudaLaunchKernelEx(&cfg, gn_kernel<T, U, CL, BWD>, a);
  if (err != cudaSuccess || !streaming) return static_cast<int>(err);
  a.mode = APPLY;
  cfg = config(grid, 1, L.bytes, st, &attr);
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, gn_kernel<T, U, CL, BWD>, a));
}

template <typename T, typename U, bool CL, bool BWD>
int max_clusters(int cluster, int smem) {
  cudaError_t err = prepare<T, U, CL, BWD>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(dim3(cluster), cluster, smem, 0, &attr);
  cfg.numAttrs = 1;  // the query counts clusters, of one CTA too
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, gn_kernel<T, U, CL, BWD>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// fn(x type, y type, layout) for the forward's dtype codes
template <typename Fn>
int with_fwd_types(int xdt, int ydt, int cl, Fn&& fn) {
  return elem::dispatch(xdt, [&](auto xt) {
    return elem::dispatch(ydt, [&](auto yt) {
      return cl ? fn(xt, yt, std::true_type{})
                : fn(xt, yt, std::false_type{});
    });
  });
}

template <typename Fn>
int with_bwd_types(int dt, int cl, Fn&& fn) {
  return elem::dispatch(dt, [&](auto t) {
    return cl ? fn(t, std::true_type{}) : fn(t, std::false_type{});
  });
}

}  // namespace gn

// What one call of a direction takes besides its tensors; ops/groupnorm.py
// builds one per plan (GNCall) and keeps it.
struct GnCall {
  int xdt, ydt, pdt;  // elem.cuh dtype codes of x, y (forward), gamma/beta
  int cl;             // 1: channels-last, 0: NCHW
  int b, c, s, groups;
  int slab, cluster, ppc, chunk, streaming;
  int act;
  float eps;
};

static gn::Args args_of(const GnCall* k) {
  gn::Args a = {};
  a.b = k->b;
  a.c = k->c;
  a.s = k->s;
  a.groups = k->groups;
  a.slab = k->slab;
  a.ctas = k->cluster;
  a.ppc = k->ppc;
  a.chunk = k->chunk;
  a.act = k->act;
  a.pdt = k->pdt;
  a.eps = k->eps;
  return a;
}

// Forward: x [b, c, s] in the call's layout (16-byte aligned), gamma and
// beta [c] of code pdt; y like x in code ydt; stats [2, b, groups] fp32
// out (mean, rsig). Returns the launch's cudaError_t (1 for arguments the
// kernel does not take).
extern "C" int gn_fwd(const GnCall* k, const void* x, const void* gamma,
                      const void* beta, void* y, void* stats,
                      void* stream) {
  gn::Args a = args_of(k);
  a.x = x;
  a.gamma = gamma;
  a.beta = beta;
  a.out = y;
  a.stats = static_cast<float*>(stats);
  return gn::with_fwd_types(k->xdt, k->ydt, k->cl, [&](auto xt, auto yt,
                                                        auto cl) {
    return gn::run<decltype(xt), decltype(yt), decltype(cl)::value, false>(
        a, k->streaming, static_cast<cudaStream_t>(stream));
  });
}

// Backward: x, dy, dx like x (code xdt); mean, rsig [b, groups] fp32 from
// the forward; uv [2, b, c] fp32 out (u, v); t12 fp32 scratch of
// 2*b*groups (streaming plan only, else unused).
extern "C" int gn_bwd(const GnCall* k, const void* x, const void* dy,
                      const void* gamma, const void* beta, const void* mean,
                      const void* rsig, void* dx, void* uv, void* t12,
                      void* stream) {
  gn::Args a = args_of(k);
  a.x = x;
  a.dy = dy;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = static_cast<const float*>(mean);
  a.rsig = static_cast<const float*>(rsig);
  a.out = dx;
  a.uv = static_cast<float*>(uv);
  a.t12 = static_cast<float*>(t12);
  return gn::with_bwd_types(k->xdt, k->cl, [&](auto t, auto cl) {
    return gn::run<decltype(t), decltype(t), decltype(cl)::value, true>(
        a, k->streaming, static_cast<cudaStream_t>(stream));
  });
}

// Clusters of `cluster` CTAs with `smem` bytes each that the card holds at
// once for the instance (bwd, xdt, ydt, cl): 0 when it cannot schedule one,
// a negative cudaError_t on failure.
extern "C" int gn_max_clusters(int bwd, int xdt, int ydt, int cl,
                               int cluster, int smem) {
  if (bwd)
    return gn::with_bwd_types(xdt, cl, [&](auto t, auto c) {
      return gn::max_clusters<decltype(t), decltype(t), decltype(c)::value,
                              true>(cluster, smem);
    });
  return gn::with_fwd_types(xdt, ydt, cl, [&](auto xt, auto yt, auto c) {
    return gn::max_clusters<decltype(xt), decltype(yt), decltype(c)::value,
                            false>(cluster, smem);
  });
}

// The shared memory one CTA of a plan takes (smem_layout).
extern "C" int gn_smem_bytes(int es, int cl, int bwd, int slab, int chunk,
                             int cluster) {
  return gn::smem_layout(es, cl, bwd, slab, chunk, cluster).bytes;
}
