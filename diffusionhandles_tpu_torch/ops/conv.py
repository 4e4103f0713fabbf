"""3x3 SAME stride-1 convolution with a hand-written kernel: the JAX
package's `ops/conv.py` (Pallas `_conv3_kernel`, reached through `conv3x3`
and `UNetConfig(pallas_conv=True)`).

    y = conv3x3(x, w)        x [B, Ci, H, W], w [Co, Ci, 3, 3]

No bias: the caller adds it after the op, in the compute dtype. The kernel
is CUDA C++ for Hopper (`csrc/conv.cu`: a TMA-fed wgmma implicit GEMM over
channels-last activations, split-K where the grid is short), built at
first use (`utils/cuda_build.py`). Shapes stay logical NCHW; on the card
the kernel takes and returns channels-last memory (`torch.channels_last`)
and reads the weight in that layout too, so a caller holds its weights
there once (`to_kernel_layout`) instead of paying a copy per call. The tile
and the K split of each call come from `plan_conv3x3`.

Numerics are the TPU kernel's, reproduced by the plain versions
(`conv3x3_fwd_ref`, `conv3x3_dx_ref`): w cast to x's dtype, products of
the nine taps summed in fp32, the sum rounded once to x's dtype. dx is the
same conv of dy (cast to x's dtype) with the flipped, in/out-transposed
kernel. dw is a plain fp32 recomputation (the JAX package's `_dw_taps` is
XLA, not Pallas), made only when autograd asks for it: the pipeline's
weights are frozen. A call takes the route `conv3x3_route` names from its
device, dtype and channels: the plain version on the CPU; on the card this
kernel for bf16 or fp16 (an instance each) with Ci and Co multiples of 8,
else the general kernel (`csrc/conv_general.cu`: fp32, fp16 or bf16, any
channel count; tf32 products on the tensor cores, fp32 as three passes,
split over K by `plan_conv3x3_general`), counted as `conv3x3_fwd_general` /
`conv3x3_dx_general`.

The JAX package's two mixed routes are here too: `conv3x3_hybrid` (the
library's forward, this kernel's dx; its `pallas_conv='hybrid'`) and
`conv3x3_mixed` (this kernel's forward, a plain backward; 'mixed').
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.utils.cuda_build import (ELEM_CODES,
                                                         HALF_SUFFIX,
                                                         check_cuda,
                                                         elem_code, general,
                                                         load_library,
                                                         raise_on, route,
                                                         run_route, stream_of)
from diffusionhandles_tpu_torch.utils.profiling import span

# Launches of each kernel wrapper, the Hopper kernel's and the general
# kernel's (`<name>_general`), since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {
    n: 0 for k in ("conv3x3_fwd", "conv3x3_dx") for n in (k, general(k))}
# the span of each wrapper's launch, by its LAUNCHES key
_SPANS = {n: "kernel." + n for n in LAUNCHES}

# One library for the conv kernels and the fused GN+SiLU+conv kernels
# (ops/gn_conv.py), which run these GEMMs (csrc/conv.cuh).
KERNEL_SOURCES = ("conv.cu", "conv_general.cu", "gn_conv.cu")
# Ci and Co divide by it: TMA takes global strides in 16-byte units
CHANNEL_MULTIPLE = 8


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Routing gate: the JAX package's conv3x3_ok (conv.py:94-122), copied with
# its TPU VMEM budget, so that the same convs take the kernel in both
# packages. Shapes are in the JAX package's layouts: x [B, H, W, Ci],
# w [3, 3, Ci, Co].
# ---------------------------------------------------------------------------

def _co_tile(co: int) -> int:
    if co % 256 == 0:
        return 256
    if co % 128 == 0:
        return 128
    return co


def _vmem_bytes(h, wdt, ci, co_tile, dtype_bytes=2):
    s_in = (h + 2) * (wdt + 2) * ci * dtype_bytes
    s_w = 9 * ci * co_tile * dtype_bytes
    s_acc = h * (wdt + 2) * co_tile * 4
    s_out = h * (wdt + 2) * co_tile * dtype_bytes
    return s_in + s_w + s_acc + s_out


def conv3x3_ok(x_shape: Sequence[int], w_shape: Sequence[int],
               dtype_bytes: int = 2) -> bool:
    """True where the JAX package runs its conv kernel: a 3x3 kernel, at
    least 64 channels each way, output rows tile-aligned, and both
    orientations (forward and dx) inside its VMEM budget."""
    if len(w_shape) != 4 or w_shape[0] != 3 or w_shape[1] != 3:
        return False
    b, h, wdt, ci = x_shape
    co = w_shape[-1]
    if ci < 64 or co < 64:
        return False
    if (h * (wdt + 2)) % 8:
        return False
    budget = 64 * 1024 * 1024
    return (_vmem_bytes(h, wdt, ci, _co_tile(co), dtype_bytes) < budget
            and _vmem_bytes(h, wdt, co, _co_tile(ci), dtype_bytes)
            < budget)


def conv3x3_route(device, dtype, ci: int, co: int) -> str:
    """The route (`utils.cuda_build.route`) of a conv of Ci -> Co
    channels in `dtype` on `device`: the Hopper kernel takes bf16 or fp16
    with Ci and Co multiples of 8, the general kernel the rest."""
    return route(device, dtype in HALF_SUFFIX
                 and ci % CHANNEL_MULTIPLE == 0
                 and co % CHANNEL_MULTIPLE == 0)


# ---------------------------------------------------------------------------
# The planner: tile and K split of one launch, from the shape alone
# ---------------------------------------------------------------------------

SMS = 132                        # streaming multiprocessors of an H100 SXM
# (consumer warpgroups, N tile) of the kernels csrc/conv.cu has: the tiles
# the planner picks at the SD-2 U-Net's 16 conv shapes, B 1 and 2, forward
# and dx, out of 1-2 warpgroups x N 64/128/160/256
TILES = ((1, 64), (1, 160), (2, 128), (2, 160), (2, 256))
K_STEP = 64                      # channels of one K step
MIN_SPLIT_STEPS = 4              # K steps a split keeps at least

# The cost model that ranks plans (seconds). A CTA runs its K steps one
# after another; each moves (BM + BN) rows of 128 bytes into shared memory
# and does 2 * BM * BN * 64 operations, and takes the longer of the two at
# one SM's share of the card: the tensor cores at the share of peak its
# consumer warpgroups reach, the copies at what one SM draws from L2.
# Whole waves of CTAs run in turn; the call takes at least its unique
# bytes over device memory, and a split adds its fp32 partials (written
# and read back) and the second pass's launch. With fp32 output (K9's dx,
# whose epilogue pass sums the splits) every plan writes and reads its
# partials. Estimates, set against chip_smoke.py's per-site times.
_SM_FLOPS = 989e12 / SMS
_MMA_SHARE = {1: 0.6, 2: 0.8}
_SM_COPY_BPS = 60e9
_HBM_BPS = 0.85 * 3.35e12
_SPLIT_PASS_S = 3e-6


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """One launch: `warpgroups` consumer warpgroups (64 output pixels
    each), an N tile of `block_n` channels, an M tile that is the pixel box
    `box` = (columns, rows, images), the K steps cut into `splits` ranges.
    `note` says why the grid falls short of one wave, where it does."""

    warpgroups: int
    block_n: int
    box: Tuple[int, int, int]
    splits: int
    m_tiles: int
    n_tiles: int
    k_steps: int
    est_s: float
    note: str = ""

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def split_ranges(self) -> Tuple[Tuple[int, int], ...]:
        """[start, end) of each split's K steps, as the kernel cuts them."""
        k, s = self.k_steps, self.splits
        return tuple((i * k // s, (i + 1) * k // s) for i in range(s))

    def launch_args(self) -> Tuple[int, ...]:
        return (self.warpgroups, self.block_n, *self.box, self.splits)


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def pixel_box(b: int, h: int, w: int, warpgroups: int) -> Tuple[int, int,
                                                                 int]:
    """The M tile (columns, rows, images) of 64 * warpgroups pixels: a row
    segment of up to 64 columns, then rows, then whole images."""
    bw = min(64, _pow2_ceil(w))
    rest = 64 * warpgroups // bw
    bh = min(rest, _pow2_ceil(h))
    return bw, bh, rest // bh


def _estimate(b, h, w, kch, nch, nwg, bn, splits, m_tiles, k_steps,
              f32_out):
    bm = 64 * nwg
    step = max(2.0 * bm * bn * K_STEP / (_SM_FLOPS * _MMA_SHARE[nwg]),
               (bm + bn) * 2 * K_STEP / _SM_COPY_BPS)
    ctas = m_tiles * math.ceil(nch / bn) * splits
    main = math.ceil(ctas / SMS) * math.ceil(k_steps / splits) * step
    unique = 2.0 * (b * h * w * (kch + nch) + 9 * kch * nch)
    partials = 8.0 * splits * b * h * w * nch / _HBM_BPS
    extra = (partials if f32_out else 0.0 if splits == 1
             else partials + _SPLIT_PASS_S)
    return max(main, unique / _HBM_BPS) + extra


def fixed_plan(b: int, h: int, w: int, kch: int, nch: int,
               warpgroups: int, block_n: int, splits: int,
               f32_out: bool = False) -> ConvPlan:
    """The plan with the given tile and split (the planner's candidates;
    tests use it to reach every kernel instance)."""
    box = pixel_box(b, h, w, warpgroups)
    m_tiles = (math.ceil(b / box[2]) * math.ceil(h / box[1])
               * math.ceil(w / box[0]))
    k_steps = 9 * math.ceil(kch / K_STEP)
    est = _estimate(b, h, w, kch, nch, warpgroups, block_n, splits, m_tiles,
                    k_steps, f32_out)
    return ConvPlan(warpgroups, block_n, box, splits, m_tiles,
                    math.ceil(nch / block_n), k_steps, est)


@functools.lru_cache(maxsize=None)
def plan_conv3x3(b: int, h: int, w: int, kch: int, nch: int,
                 f32_out: bool = False) -> ConvPlan:
    """The plan of the conv GEMM with `kch` channels along K (Ci forward,
    Co for dx) and `nch` along N, over B x H x W pixels: the candidate
    tiles and splits ranked by the cost model above. `f32_out`: the GEMM
    writes fp32 partials at every split (K9's dx)."""
    k_steps = 9 * math.ceil(kch / K_STEP)
    best = None
    for nwg, bn in TILES:
        tiles = fixed_plan(b, h, w, kch, nch, nwg, bn, 1).grid
        max_splits = max(1, min(k_steps // MIN_SPLIT_STEPS,
                                math.ceil(2 * SMS / tiles)))
        for splits in range(1, max_splits + 1):
            cand = fixed_plan(b, h, w, kch, nch, nwg, bn, splits, f32_out)
            key = (cand.est_s, splits, -nwg, -bn)
            if best is None or key < best[0]:
                best = (key, cand)
    plan = best[1]
    if plan.grid < SMS:
        tiles = plan.m_tiles * plan.n_tiles
        why = (f"{tiles} tiles x {plan.splits} splits = {plan.grid} CTAs: ")
        if plan.splits * MIN_SPLIT_STEPS > k_steps - MIN_SPLIT_STEPS:
            why += (f"more splits would leave fewer than {MIN_SPLIT_STEPS} "
                    f"of the {k_steps} K steps each")
        else:
            why += ("the cost model ranks every plan with a full wave "
                    "slower (smaller tiles move more bytes a flop; more "
                    "splits add fp32 partials)")
        plan = dataclasses.replace(plan, note=why)
    return plan


# ---------------------------------------------------------------------------
# The general kernel's planner (csrc/conv_general.cu)
# ---------------------------------------------------------------------------

# (consumer warpgroups, N tile) of the general kernel's instances, the
# planner's picks at the U-Net's sites: two warpgroups take N = 80 (a
# 384-thread CTA compiles within 168 registers a thread: 40 + 40
# accumulators and 32 A registers fit, 64 + 64 spill)
GENERAL_TILES = ((1, 128), (2, 80))
GENERAL_K_STEP = 32              # channels of one K step
GENERAL_MIN_SPLIT_STEPS = 16     # K steps a split keeps at least
# Its cost model (seconds). A CTA's K step takes the longer of its products
# (three TF32 passes over 64 * warpgroups pixels x N tile x 32 channels at
# one SM's 1024 tf32 multiply-adds a clock) and the bytes it moves through
# shared memory at 128 a clock (the raw A tile written and read, the raw B
# tile written and read, its hi and lo tiles written, and B read by wgmma
# once a pass a warpgroup), with an overhead for the step's barriers and
# issue. The call takes at least its unique bytes over device memory; a
# split adds its fp32 partials and, unless the caller sums them (f32_out),
# the second pass. Estimates, set against chip_smoke.py's times.
_SM_CLOCK_HZ = 1.755e9
_SM_TF32_FMA_PER_CLOCK = 1024
_SM_SMEM_BYTES_PER_CLOCK = 128
_GENERAL_STEP_OVERHEAD = 1.15


@dataclasses.dataclass(frozen=True)
class GeneralPlan:
    """One launch of the general kernel: `warpgroups` consumer warpgroups
    (64 output pixels each), an N tile of `block_n` channels, an M tile
    that is the pixel box `box` (as K7's, `pixel_box`), the K steps cut
    into `splits` ranges."""

    warpgroups: int
    block_n: int
    box: Tuple[int, int, int]
    splits: int
    m_tiles: int
    n_tiles: int
    k_steps: int
    est_s: float

    @property
    def grid(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def launch_args(self) -> Tuple[int, ...]:
        return (self.warpgroups, self.block_n, *self.box, self.splits)


def _general_step_s(warpgroups: int, block_n: int) -> float:
    bm = 64 * warpgroups
    mma = 3 * bm * block_n * GENERAL_K_STEP / _SM_TF32_FMA_PER_CLOCK
    smem = 4 * GENERAL_K_STEP * (2 * bm + block_n * (4 + 3 * warpgroups))
    return (_GENERAL_STEP_OVERHEAD * max(mma, smem / _SM_SMEM_BYTES_PER_CLOCK)
            / _SM_CLOCK_HZ)


def general_fixed_plan(b: int, h: int, w: int, kch: int, nch: int,
                       warpgroups: int, block_n: int, splits: int,
                       f32_out: bool = False) -> GeneralPlan:
    """The general kernel's plan with the given tile and split (the
    planner's candidates; tests use it to reach every instance)."""
    m = b * h * w
    box = pixel_box(b, h, w, warpgroups)
    m_tiles = (math.ceil(b / box[2]) * math.ceil(h / box[1])
               * math.ceil(w / box[0]))
    n_tiles = math.ceil(nch / block_n)
    k_steps = 9 * math.ceil(kch / GENERAL_K_STEP)
    main = (math.ceil(m_tiles * n_tiles * splits / SMS)
            * math.ceil(k_steps / splits)
            * _general_step_s(warpgroups, block_n))
    unique = 4.0 * (m * (kch + nch) + 9 * kch * nch)  # fp32
    partials = 8.0 * splits * m * nch / _HBM_BPS
    extra = (partials if f32_out else 0.0 if splits == 1
             else partials + _SPLIT_PASS_S)
    return GeneralPlan(warpgroups, block_n, box, splits, m_tiles, n_tiles,
                       k_steps, max(main, unique / _HBM_BPS) + extra)


@functools.lru_cache(maxsize=None)
def plan_conv3x3_general(b: int, h: int, w: int, kch: int, nch: int,
                         f32_out: bool = False) -> GeneralPlan:
    """The general kernel's plan for `kch` channels along K (Ci forward,
    Co for dx) and `nch` along N over B x H x W pixels: each tile of
    GENERAL_TILES with every split that keeps the grid within two waves
    and each split at least GENERAL_MIN_SPLIT_STEPS K steps, ranked by the
    cost model above. `f32_out`: every split's partials go to the caller (K9's
    dx)."""
    k_steps = 9 * math.ceil(kch / GENERAL_K_STEP)
    best = None
    for nwg, bn in GENERAL_TILES:
        tiles = general_fixed_plan(b, h, w, kch, nch, nwg, bn, 1).grid
        max_splits = max(1, min(k_steps // GENERAL_MIN_SPLIT_STEPS,
                                2 * SMS // tiles))
        for splits in range(1, max_splits + 1):
            cand = general_fixed_plan(b, h, w, kch, nch, nwg, bn, splits,
                                      f32_out)
            key = (cand.est_s, splits, -nwg, -bn)
            if best is None or key < best[0]:
                best = (key, cand)
    return best[1]


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def conv3x3_fwd_ref(x, w):
    """Plain version of the kernel: y [B, Co, H, W] in x's dtype, the fp32
    sum of products of x and w cast to x's dtype."""
    y = F.conv2d(x.float(), w.to(x.dtype).float(), padding=1)
    return y.to(x.dtype)


def conv3x3_dx_ref(dy, w, dtype):
    """Plain version of the dx kernel: dx [B, Ci, H, W] in `dtype` (x's),
    the conv of dy cast to `dtype` with the kernel spatially flipped and
    its in/out channels swapped (conv.py:152-158)."""
    return conv3x3_fwd_ref(dy.to(dtype), w.flip(2, 3).transpose(0, 1))


def conv3x3_dw(x, dy, w_dtype):
    """dw [Co, Ci, 3, 3]: the nine shifted x^T dy products summed in fp32
    (the JAX package's _dw_taps), rounded to w's dtype."""
    return torch.nn.grad.conv2d_weight(
        x.float(), (dy.shape[1], x.shape[1], 3, 3), dy.float(),
        padding=1).to(w_dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def kernel_library() -> ctypes.CDLL:
    """Build (first call) and load the conv and fused GN+SiLU+conv
    kernels."""
    global _LIB
    if _LIB is None:
        lib = load_library("conv3x3", KERNEL_SOURCES)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fast = [getattr(lib, f"{e}_{sfx}") for sfx in HALF_SUFFIX.values()
                for e in ("conv3x3_fwd", "conv3x3_dx", "gn_conv_fwd",
                          "gn_conv_dx")]
        for sfx in HALF_SUFFIX.values():
            for e in ("conv3x3_fwd", "conv3x3_dx"):
                getattr(lib, f"{e}_{sfx}").argtypes = ([ptr] * 4 + [i32] * 11
                                                       + [ptr])
            getattr(lib, f"gn_conv_fwd_{sfx}").argtypes = (
                [ptr] * 10 + [i32] * 6 + [f32] + [i32] * 6 + [ptr])
            getattr(lib, f"gn_conv_dx_{sfx}").argtypes = ([ptr] * 12
                                                          + [i32] * 12
                                                          + [ptr])
        lib.conv3x3_general.argtypes = ([i32] * 2 + [ptr] * 4 + [i32] * 11
                                        + [ptr])
        lib.gn_conv_fwd_general.argtypes = ([i32] + [ptr] * 10 + [i32] * 6
                                            + [f32] + [i32] * 6 + [ptr])
        lib.gn_conv_dx_general.argtypes = ([i32] + [ptr] * 12 + [i32] * 12
                                           + [ptr])
        for fn in (*fast, lib.conv3x3_general, lib.gn_conv_fwd_general,
                   lib.gn_conv_dx_general):
            fn.restype = i32
        _LIB = lib
    return _LIB


def in_kernel_layout(t: torch.Tensor) -> bool:
    """True when `t` (an activation [B, C, H, W] or a weight
    [Co, Ci, 3, 3]) is dense channels-last: the memory the kernel reads."""
    return t.is_contiguous(memory_format=torch.channels_last)


def to_kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """`t` in channels-last memory, the same logical shape; `t` itself
    when it already is."""
    return t.contiguous(memory_format=torch.channels_last)


def _check(src, w, ci: int, co: int) -> Tuple[int, int, int]:
    check_cuda("conv3x3", src, w, dtypes=tuple(HALF_SUFFIX))
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"conv3x3: w {tuple(w.shape)} is not "
                         f"[{co}, {ci}, 3, 3]")
    if ci % CHANNEL_MULTIPLE or co % CHANNEL_MULTIPLE:
        raise ValueError(f"conv3x3 kernel: Ci={ci} and Co={co} must be "
                         f"multiples of {CHANNEL_MULTIPLE} (TMA strides "
                         "are 16-byte units)")
    for t in (src, w):
        if not in_kernel_layout(t) or t.data_ptr() % 16:
            raise ValueError("conv3x3 kernel takes dense channels-last, "
                             "16-byte aligned tensors")
    b, _, h, wd = src.shape
    return b, h, wd


def _launch(name, src, w, plan: Optional[ConvPlan] = None):
    """Run K7's `name` kernel ("conv3x3_fwd" or "conv3x3_dx") on the
    channels-last bf16 or fp16 `src` (x, or dy for dx) and w [Co, Ci, 3,
    3], writing a channels-last output of their type, with `plan` or the
    planner's (the CUDA tests force plans through here to reach every
    kernel instance)."""
    co, ci = w.shape[:2]
    kch, nch = (co, ci) if name == "conv3x3_dx" else (ci, co)
    b, h, wd = _check(src, w, ci, co)
    plan = plan or plan_conv3x3(b, h, wd, kch, nch)
    with span(_SPANS[name]):
        out = torch.empty((b, nch, h, wd), dtype=src.dtype,
                          device=src.device,
                          memory_format=torch.channels_last)
        part = (torch.empty((plan.splits * b * h * wd * nch,),
                            dtype=torch.float32, device=src.device)
                if plan.splits > 1 else None)
        entry = getattr(kernel_library(),
                        f"{name}_{HALF_SUFFIX[src.dtype]}")
        with torch.cuda.device(src.device):
            err = entry(src.data_ptr(), w.data_ptr(), out.data_ptr(),
                        None if part is None else part.data_ptr(), b, h, wd,
                        ci, co, *plan.launch_args(), stream_of(src))
        raise_on(err, name)
        LAUNCHES[name] += 1
    return out


def conv3x3_fwd_cuda(x, w):
    """The kernel on the card: y [B, Co, H, W] in x's dtype (bf16 or fp16)
    in channels-last memory. x and w in another memory format are copied
    to channels-last first (the conv U-Net holds its weights there, so its
    calls copy none)."""
    ci = w.shape[1]
    if x.dim() != 4 or x.shape[1] != ci:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} is not [B, {ci}, H, W]")
    x = to_kernel_layout(x)
    return _launch("conv3x3_fwd", x, to_kernel_layout(w.to(x.dtype)))


def conv3x3_dx_cuda(dy, w, dtype):
    """The dx kernel on the card: dx [B, Ci, H, W] in `dtype` (x's: bf16
    or fp16) in channels-last memory. dy and w in another memory format
    are copied to channels-last first."""
    if dtype not in HALF_SUFFIX:
        raise TypeError(f"conv3x3 dx kernel writes bfloat16 or float16, "
                        f"asked {dtype}")
    co = w.shape[0]
    if dy.dim() != 4 or dy.shape[1] != co:
        raise ValueError(f"conv3x3: dy {tuple(dy.shape)} is not "
                         f"[B, {co}, H, W]")
    return _launch("conv3x3_dx", to_kernel_layout(dy.to(dtype)),
                   to_kernel_layout(w.to(dtype)))


def _general_launch(name, src, w, dtype,
                    plan: Optional[GeneralPlan] = None):
    """Run K7's general kernel ("conv3x3_fwd" or "conv3x3_dx") on `src`
    (x, or dy for dx) and w [Co, Ci, 3, 3], both cast to `dtype` and
    copied to channels-last where they are not, with `plan` or the
    planner's: the output channels-last in `dtype`."""
    co, ci = w.shape[:2]
    kch, nch = (co, ci) if name == "conv3x3_dx" else (ci, co)
    if src.dim() != 4 or src.shape[1] != kch:
        raise ValueError(f"conv3x3: input {tuple(src.shape)} is not "
                         f"[B, {kch}, H, W]")
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"conv3x3: w {tuple(w.shape)} is not "
                         f"[{co}, {ci}, 3, 3]")
    src = to_kernel_layout(src.to(dtype))
    w = to_kernel_layout(w.to(dtype))
    check_cuda("conv3x3 general kernel", src, w,
               dtypes=tuple(ELEM_CODES))
    b, _, h, wd = src.shape
    plan = plan or plan_conv3x3_general(b, h, wd, kch, nch)
    with span(_SPANS[general(name)]):
        out = torch.empty((b, nch, h, wd), dtype=dtype, device=src.device,
                          memory_format=torch.channels_last)
        part = (torch.empty((plan.splits * b * h * wd * nch,),
                            dtype=torch.float32, device=src.device)
                if plan.splits > 1 else None)
        with torch.cuda.device(src.device):
            err = kernel_library().conv3x3_general(
                elem_code(dtype), int(name == "conv3x3_dx"), src.data_ptr(),
                w.data_ptr(), out.data_ptr(),
                None if part is None else part.data_ptr(), b, h, wd, ci, co,
                *plan.launch_args(), stream_of(src))
        raise_on(err, general(name))
        LAUNCHES[general(name)] += 1
    return out


def conv3x3_fwd_general(x, w):
    """K7's general kernel on the card: y [B, Co, H, W] in x's dtype, in
    channels-last memory."""
    return _general_launch("conv3x3_fwd", x, w, x.dtype)


def conv3x3_dx_general(dy, w, dtype):
    """K7's general dx kernel on the card: dx [B, Ci, H, W] in `dtype`
    (x's), in channels-last memory."""
    return _general_launch("conv3x3_dx", dy, w, dtype)


def _fwd_route(x, w) -> str:
    return conv3x3_route(x.device, x.dtype, w.shape[1], w.shape[0])


def conv3x3_fwd(x, w):
    """The forward by conv3x3_route."""
    return run_route(_fwd_route(x, w), lambda: conv3x3_fwd_ref(x, w),
                     lambda: conv3x3_fwd_cuda(x, w),
                     lambda: conv3x3_fwd_general(x, w))


def conv3x3_dx(dy, w, dtype):
    """dx by conv3x3_route of x's dtype."""
    return run_route(conv3x3_route(dy.device, dtype, w.shape[1], w.shape[0]),
                     lambda: conv3x3_dx_ref(dy, w, dtype),
                     lambda: conv3x3_dx_cuda(dy, w, dtype),
                     lambda: conv3x3_dx_general(dy, w, dtype))


class Conv3x3Function(torch.autograd.Function):
    """Differentiable conv3x3 (the JAX package's custom VJP, conv.py:125-
    161): forward and dx are the kernel's, dw a plain recomputation made
    only when asked for."""

    @staticmethod
    def forward(ctx, x, w):
        if _fwd_route(x, w) != "cpu":
            x = to_kernel_layout(x)  # saved as the kernels take it
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = conv3x3_dx(dy, w, x.dtype) if need[0] else None
        dw = conv3x3_dw(x, dy, w.dtype) if need[1] else None
        return dx, dw


def _records_grad(x, w) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)


def conv3x3(x, w):
    """3x3 SAME stride-1 conv over x [B, Ci, H, W], no bias. Callers gate
    with conv3x3_ok. Where no gradient is recorded (the pipeline's
    inference calls) the forward runs without the autograd Function, which
    costs ~20 us of host time a call."""
    if _records_grad(x, w):
        return Conv3x3Function.apply(x, w)
    return conv3x3_fwd(x, w)


# ---------------------------------------------------------------------------
# The JAX package's two mixed routes (conv.py:172-183 and 284-310): the
# kernel on one side of the custom VJP only
# ---------------------------------------------------------------------------

def library_conv3x3(x, w):
    """The library's 3x3 SAME conv with the kernel's numerics: y in x's
    dtype, the fp32 sum of products of x and w cast to x's dtype, rounded
    once. On the card cuDNN's half-precision convs sum in fp32 and round
    once; on the CPU the fp32 sum is taken explicitly (conv3x3_fwd_ref)."""
    if x.device.type == "cpu":
        return conv3x3_fwd_ref(x, w)
    return F.conv2d(x, w.to(x.dtype), padding=1)


class Conv3x3HybridFunction(Conv3x3Function):
    """The JAX package's conv3x3_hybrid: the library conv forward (XLA's
    there) with Conv3x3Function's backward, dx on the kernel's dx route,
    dw the plain recomputation made only when asked for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return library_conv3x3(x, w)


class Conv3x3MixedFunction(torch.autograd.Function):
    """The JAX package's conv3x3_mixed: the kernel's forward with the
    backward of its `_taps_dx_dw`. That backward is plain jnp there, no
    Pallas kernel, so this is its counterpart and not a port of a kernel:
    dx and dw are the fp32 sums rounded once (conv3x3_dx_ref,
    conv3x3_dw), each made only when asked for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = conv3x3_dx_ref(dy, w, x.dtype) if need[0] else None
        dw = conv3x3_dw(x, dy, w.dtype) if need[1] else None
        return dx, dw


def conv3x3_hybrid(x, w):
    """3x3 SAME stride-1 conv, no bias: the library forward and the
    kernel's dx (Conv3x3HybridFunction). Callers gate with conv3x3_ok."""
    if _records_grad(x, w):
        return Conv3x3HybridFunction.apply(x, w)
    return library_conv3x3(x, w)


def conv3x3_mixed(x, w):
    """3x3 SAME stride-1 conv, no bias: the kernel's forward and a plain
    backward (Conv3x3MixedFunction). Callers gate with conv3x3_ok."""
    if _records_grad(x, w):
        return Conv3x3MixedFunction.apply(x, w)
    return conv3x3_fwd(x, w)
