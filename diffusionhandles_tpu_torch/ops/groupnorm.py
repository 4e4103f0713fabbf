"""GroupNorm(+SiLU) with a hand-written kernel: the JAX package's
`ops/groupnorm.py` (Pallas `_gn_fwd_kernel` / `_gn_bwd_kernel`).

    y = cast(silu?(groupnorm(x; gamma, beta)))

x is [B, C, *spatial], in NCHW memory or, 4-D, channels-last (as the
fused U-Net gives it); y and dx keep x's memory format
(`memory_format_of`). The kernel is CUDA C++ for Hopper (`csrc/gn.cu`),
built at first use (`utils/cuda_build.py`): one launch per direction, a
thread-block cluster per (image, channel slab) reading the slab once into
shared memory and reducing its statistics across the cluster. `plan_gn`
picks the slab, the cluster and the pixels per CTA from shape, dtype and
layout, or the streaming plan (a statistics launch, then an apply launch)
for a slab no cluster holds.

Numerics are the TPU kernel's recipe, reproduced by the plain versions
(`gn_silu_fwd_ref`, `gn_silu_bwd_ref`):
  forward:  s1 = sum x, s2 = sum of x*x rounded to x's dtype (the kernel's
            stated deviation from flax), fp32; var = max(s2/n - mean^2, 0);
            y = x * A + B with A = rsig * gamma, B = beta - mean * A; SiLU.
  backward: dy rounded to x's dtype; dz = dy * silu'(z) (or dy);
            u = sum cast(dz), v = sum cast(dz * xh) per channel;
            dgamma = sum_b v, dbeta = sum_b u;
            dx = rsig * (gamma * dz - t1 - xh * t2), t1 and t2 the group
            means of u * gamma and v * gamma.
A call takes the route `gn_route` names from its device and dtypes: the
plain version on the CPU; on the card the kernel's bf16 instance for bf16
in and out, else its general instances (the same kernel over fp32, fp16
or bf16 x and y, rounding to x's dtype where the bf16 instance rounds to
bf16), counted as `gn_silu_fwd_general` / `gn_silu_bwd_general`. Both take
C divisible by the groups and H*W by 8, as the gate requires; gamma and
beta are read in their own dtype.
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
                                                         check_cuda,
                                                         elem_code, general,
                                                         load_library,
                                                         raise_on, route,
                                                         run_route)
from diffusionhandles_tpu_torch.utils.profiling import span

# Launches of each kernel wrapper, the bf16 instance's and the general
# instances' (`<name>_general`), since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {
    n: 0 for k in ("gn_silu_fwd", "gn_silu_bwd") for n in (k, general(k))}
# the span of each wrapper's launch, by its LAUNCHES key
_SPANS = {n: "kernel." + n for n in LAUNCHES}
# Tensors the wrappers copied into or out of the kernel's layout (x or dy
# neither dense NCHW nor dense channels-last, or 16-byte misaligned; a
# channels-last x whose channels make no 16-byte slab).
LAYOUT_COPIES: Dict[str, int] = {"gn": 0}

KERNEL_SOURCES = ("gn.cu",)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Routing gate: the JAX package's gn_ok (groupnorm.py:257-271), so that the
# same sites take the kernel in both packages.
# ---------------------------------------------------------------------------

def gn_ok(x_shape: Sequence[int], groups: int, dtype_bytes: int = 2) -> bool:
    """True where the JAX package runs its GroupNorm kernel. `x_shape` is
    in the JAX package's channels-last layout: [B, ...spatial..., C]."""
    *lead, c = x_shape
    s = 1
    for d in lead[1:]:
        s *= d
    if c % groups or c < 64:
        return False
    if s % 8:
        return False
    return s * c * dtype_bytes < 512 * 1024 * 1024


def gn_route(device, dtype, out_dtype) -> str:
    """The route (`utils.cuda_build.route`) of a GroupNorm of x in
    `dtype`, written in `out_dtype`, on `device`: the bf16 instance for
    bf16 in and out, the general instances the rest."""
    return route(device, dtype == torch.bfloat16
                 and out_dtype == torch.bfloat16)


def memory_format_of(x: torch.Tensor) -> torch.memory_format:
    """The memory format of y and dx for input x: channels-last for a 4-D
    x whose channels are its innermost dimension and that is not also
    dense NCHW, else NCHW."""
    if (x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1
            and not x.is_contiguous()):
        return torch.channels_last
    return torch.contiguous_format


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def silu_grad(z: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(z)
    return s * (1.0 + z * (1.0 - s))


def grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C, *spatial] -> [B, G, C/G, S]."""
    b, c = t.shape[:2]
    return t.reshape(b, groups, c // groups, -1)


def per_channel(p: torch.Tensor, groups: int) -> torch.Tensor:
    """A [C] parameter as fp32 [1, G, C/G, 1]."""
    return p.float().reshape(1, groups, -1, 1)


def gn_silu_fwd_ref(x, gamma, beta, groups: int, eps: float, act: bool,
                    out_dtype) -> Tuple[torch.Tensor, ...]:
    """Plain version of the forward kernel: (y [B, C, *spatial] in
    out_dtype and x's memory format, mean [B, G] fp32, rsig [B, G]
    fp32)."""
    xg = grouped(x, groups)
    n = xg.shape[2] * xg.shape[3]
    xf = xg.float()
    mean = xf.sum((2, 3)) / n
    ex2 = (xg * xg).float().sum((2, 3)) / n
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    rsig = torch.rsqrt(var + eps)
    a = rsig[:, :, None, None] * per_channel(gamma, groups)
    bb = per_channel(beta, groups) - mean[:, :, None, None] * a
    z = xf * a + bb
    if act:
        z = F.silu(z)
    y = z.reshape(x.shape).to(out_dtype)
    return y.contiguous(memory_format=memory_format_of(x)), mean, rsig


def gn_silu_bwd_ref(x, dy, gamma, beta, mean, rsig, groups: int,
                    act: bool) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: (dx like x, in x's memory
    format, u [B, C] fp32, v [B, C] fp32), u and v the per-channel sums of
    dz and dz * xh."""
    b, c = x.shape[:2]
    xg = grouped(x, groups).float()
    n = xg.shape[2] * xg.shape[3]
    m = mean[:, :, None, None]
    r = rsig[:, :, None, None]
    g = per_channel(gamma, groups)
    xh = (xg - m) * r
    dz = grouped(dy.to(x.dtype), groups).float()
    if act:
        dz = dz * silu_grad(xh * g + per_channel(beta, groups))
    u = dz.to(x.dtype).float().sum(3)
    v = (dz * xh).to(x.dtype).float().sum(3)
    t1 = (u * g[..., 0]).sum(2) / n
    t2 = (v * g[..., 0]).sum(2) / n
    dx = r * (g * dz - t1[:, :, None, None] - xh * t2[:, :, None, None])
    dx = dx.reshape(x.shape).to(x.dtype)
    return (dx.contiguous(memory_format=memory_format_of(x)),
            u.reshape(b, c), v.reshape(b, c))


# ---------------------------------------------------------------------------
# The planner (csrc/gn.cu's shapes of work)
# ---------------------------------------------------------------------------

SMS = 132                 # the H100's SMs
SMEM_MAX = 232448         # shared memory one CTA may use (227 KB)
SMEM_SM = 233472          # shared memory of one SM (228 KB)
THREADS = 512             # threads a CTA (csrc/gn.cu)
WARPS = THREADS // 32
CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes tried; 16 is non-portable
PIXELS = 8                # pixel ranges and chunks are multiples of this
STREAM_SMEM = SMEM_MAX // 2  # the streaming plan's tile budget: 2 CTAs/SM
# Cost model of a fused plan, in us, fitted to the sweep of every plan at
# the U-Net's 40 sites (scripts/sweep_gn_plans.py, NVIDIA H100 80GB HBM3,
# 700 W): the kernel-input-plus-output bytes one SM holds at a time, over
# what one CTA moves and computes per us, times the waves of clusters; plus
# the cost of a cluster of each size (its push and barrier, and the
# scheduling of clusters that span SMs). Forward / backward.
US_PER_KB = {False: 0.033, True: 0.043}
CLUSTER_US = {False: {1: 0.0, 2: 1.5, 4: 2.3, 8: 3.2, 16: 5.5},
              True: {1: 0.0, 2: 2.0, 4: 3.0, 8: 7.0, 16: 12.0}}
CARD_BYTES_PER_US = 3.35e6


@dataclasses.dataclass(frozen=True)
class GNPlan:
    """How csrc/gn.cu cuts one call: a cluster of `cluster` CTAs per (image,
    `slab` channels), `ppc` pixels per CTA, held `chunk` pixels at a time
    in `smem` bytes of shared memory (chunk == ppc: the whole range, one
    launch; else the streaming plan's two launches). `grid`: CTAs a
    launch; `est_us`: the cost model's estimate."""
    slab: int
    cluster: int
    ppc: int
    chunk: int
    streaming: bool
    smem: int
    grid: int
    est_us: float

    @property
    def launches(self) -> int:
        return 2 if self.streaming else 1


def slab_of(c: int, groups: int, dtype_bytes: int,
            channels_last: bool) -> Optional[int]:
    """The channels of one cluster's unit: whole groups. NCHW: one group
    (a channel's pixel row is a multiple of 16 bytes by the gate's S % 8).
    Channels-last: the fewest whole groups whose pixel row is a multiple
    of 16 bytes, lcm(C/G, 16 / dtype_bytes) channels; None where that does
    not divide C or has more 16-byte vectors than the CTA has threads (then
    x is read as NCHW)."""
    cg = c // groups
    if not channels_last:
        return cg
    slab = math.lcm(cg, 16 // dtype_bytes)
    return None if c % slab or slab * dtype_bytes // 16 > THREADS else slab


def smem_bytes(dtype_bytes: int, channels_last: bool, bwd: bool, slab: int,
               chunk: int, cluster: int) -> int:
    """Shared memory of one CTA: the tile (x, and dy for the backward), the
    warps' partial sums (two a channel for each of the warps that share a
    column), the rows its cluster pushes (one a rank), the per-channel
    coefficients and parameters. A copy of csrc/gn.cu:smem_layout for the
    planner off the card; on the card the planner asks the library
    (`gn_smem_bytes`), and a CUDA test holds the two equal."""
    cols = slab * dtype_bytes // 16 if channels_last else slab
    parts = 1 if cols >= WARPS else WARPS // cols
    floats = (2 * slab * parts + (2 * slab * cluster if cluster > 1 else 0)
              + (6 if bwd else 4) * slab)
    return chunk * slab * dtype_bytes * (2 if bwd else 1) + 4 * floats


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _estimated_clusters(cluster: int, smem: int) -> int:
    """Clusters the card holds at once, from threads and shared memory
    alone (the card's own count, `gn_max_clusters`, also knows its
    GPCs)."""
    per_sm = min(2048 // THREADS, SMEM_SM // (smem + 1024))
    return SMS * per_sm // cluster


def _card_clusters(bwd, xdt, ydt, cl, cluster, smem) -> int:
    n = kernel_library().gn_max_clusters(int(bwd), xdt, ydt, int(cl),
                                         cluster, smem)
    if n < 0:
        raise_on(-n, "gn_max_clusters")
    return n


def _card_smem(dtype_bytes, channels_last, bwd, slab, chunk, cluster) -> int:
    return kernel_library().gn_smem_bytes(dtype_bytes, int(channels_last),
                                          int(bwd), slab, chunk, cluster)


@functools.lru_cache(maxsize=None)
def plan_gn(b: int, c: int, s: int, groups: int, dtype,
            out_dtype=None, channels_last: bool = False, bwd: bool = False,
            cluster: Optional[int] = None, stream: bool = False,
            card: bool = False) -> GNPlan:
    """The plan of one call over x [b, c, s pixels] in `dtype` (y in
    `out_dtype`, x's by default), channels-last or NCHW, forward or
    backward (`bwd`): of the cluster sizes whose slab fits in shared
    memory with no idle CTA, the one the cost model ranks first; the
    streaming plan where none fits. `cluster` forces a fused plan of that
    size, `stream` the streaming plan. With `card`, the library gives a
    plan's shared memory (`gn_smem_bytes`) and the card says which
    clusters it can schedule (`gn_max_clusters`); else both are
    estimated. Raises ValueError where no plan exists."""
    out_dtype = out_dtype or dtype
    es = dtype.itemsize
    io = 3 * es if bwd else es + out_dtype.itemsize
    slab = slab_of(c, groups, es, channels_last)
    if c % groups or s % PIXELS or slab is None:
        raise ValueError(f"gn_silu kernel: no plan for C={c}, G={groups}, "
                         f"S={s}, channels_last={channels_last}")
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"gn_silu kernel: a cluster of {cluster} is not "
                         f"one of {CLUSTERS}")
    units = b * (c // slab)
    codes = (int(bwd), elem_code(dtype), elem_code(out_dtype),
             channels_last)

    smem_of = _card_smem if card else smem_bytes

    def active(size: int, smem: int) -> int:
        return (_card_clusters(*codes, size, smem) if card
                else _estimated_clusters(size, smem))

    best = None
    for size in () if stream else ((cluster,) if cluster else CLUSTERS):
        ppc = _round_up(-(-s // size), PIXELS)
        smem = smem_of(es, channels_last, bwd, slab, ppc, size)
        if (size - 1) * ppc >= s or smem > SMEM_MAX:
            continue
        held = active(size, smem)
        if held < 1:
            continue
        waves = -(-units // held)
        per_sm = -(-min(units, held) * size // SMS)
        cta_kb = ppc * slab * io / 1024
        est = (waves * per_sm * cta_kb * US_PER_KB[bwd]
               + CLUSTER_US[bwd][size])
        if best is None or est < best.est_us:
            best = GNPlan(slab, size, ppc, ppc, False, smem, units * size,
                          est)
    if best is not None:
        return best
    if cluster:
        raise ValueError(f"gn_silu kernel: a cluster of {cluster} cannot "
                         f"hold C={c}, S={s}")
    return _streaming_plan(s, slab, units, es, io, channels_last, bwd,
                           active, smem_of)


def _streaming_plan(s, slab, units, es, io, channels_last, bwd, active,
                    smem_of) -> GNPlan:
    """The largest cluster the card schedules, each CTA's pixel range in
    chunks of at most STREAM_SMEM bytes (estimate: x, and dy, read twice
    and the output written once at the card's bandwidth)."""
    per_pixel = slab * es * (2 if bwd else 1)
    for size in reversed(CLUSTERS):
        fixed = smem_of(es, channels_last, bwd, slab, 0, size)
        ppc = _round_up(-(-s // size), PIXELS)
        for budget in (STREAM_SMEM, SMEM_MAX):
            chunk = min(ppc, (budget - fixed) // per_pixel // PIXELS
                        * PIXELS)
            if chunk < PIXELS:
                continue
            smem = smem_of(es, channels_last, bwd, slab, chunk, size)
            if (size - 1) * ppc < s and active(size, smem) >= 1:
                est = (units * s * slab * (io + es * (2 if bwd else 1))
                       / CARD_BYTES_PER_US)
                return GNPlan(slab, size, ppc, chunk, True, smem,
                              units * size, est)
    raise ValueError(f"gn_silu kernel: no cluster holds a {slab}-channel "
                     "slab's state")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

class GNCall(ctypes.Structure):
    """What one call takes besides its tensors (csrc/gn.cu's GnCall)."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "xdt", "ydt", "pdt", "cl", "b", "c", "s", "groups", "slab",
        "cluster", "ppc", "chunk", "streaming", "act")] + [
            ("eps", ctypes.c_float)]


_LIB = None


def kernel_library() -> ctypes.CDLL:
    """Build (first call) and load the GroupNorm kernel."""
    global _LIB
    if _LIB is None:
        lib = load_library("groupnorm", KERNEL_SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        call = ctypes.POINTER(GNCall)
        lib.gn_fwd.argtypes = [call] + [ptr] * 6
        lib.gn_bwd.argtypes = [call] + [ptr] * 10
        lib.gn_max_clusters.argtypes = [i32] * 6
        lib.gn_smem_bytes.argtypes = [i32] * 6
        for fn in (lib.gn_fwd, lib.gn_bwd, lib.gn_max_clusters,
                   lib.gn_smem_bytes):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _check_shape(x, groups: int) -> None:
    b, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    if c % groups or hw % PIXELS:
        raise ValueError(f"gn_silu kernel: C={c} must divide into {groups} "
                         f"groups and H*W={hw} be a multiple of {PIXELS}")


def _kernel_layout(x, groups: int) -> Tuple[torch.memory_format, bool]:
    """(the memory format the kernel reads x in, channels_last): x's own
    (`memory_format_of`), or NCHW for a channels-last x whose channels
    make no 16-byte slab."""
    fmt = memory_format_of(x)
    cl = fmt == torch.channels_last
    if cl and slab_of(x.shape[1], groups, x.element_size(), True) is None:
        return torch.contiguous_format, False
    return fmt, cl


@dataclasses.dataclass(frozen=True)
class _Prepared:
    """What a call of one shape, strides and dtypes needs beyond its
    tensors: the call struct of its plan, the memory format the kernel
    reads (`fmt`), whether x in its strides must be copied into it, and
    whether the output must be copied back into x's memory format."""
    call: GNCall
    fmt: torch.memory_format
    copy: bool
    restore: bool
    streaming: bool


def _prepare(bwd: bool, shape, stride, dtype, out_dtype, pdt, groups: int,
             act: bool, eps: float, plan: Optional[GNPlan] = None
             ) -> _Prepared:
    x = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    _check_shape(x, groups)
    fmt, cl = _kernel_layout(x, groups)
    b, c = shape[:2]
    s = math.prod(shape[2:])
    plan = plan or plan_gn(b, c, s, groups, dtype, out_dtype, cl, bwd,
                           card=True)
    call = GNCall(elem_code(dtype), elem_code(out_dtype), elem_code(pdt),
                  int(cl), b, c, s, groups, plan.slab, plan.cluster,
                  plan.ppc, plan.chunk, int(plan.streaming), int(act), eps)
    return _Prepared(call, fmt, not x.is_contiguous(memory_format=fmt),
                     fmt != memory_format_of(x), plan.streaming)


# the preparation of the planner's plan, per shape, strides and dtypes
_prepared = functools.lru_cache(maxsize=None)(_prepare)


def _prep(bwd, x, out_dtype, pdt, groups, act, eps, plan) -> _Prepared:
    args = (bwd, x.shape, x.stride(), x.dtype, out_dtype, pdt, groups,
            bool(act), float(eps))
    return _prepared(*args) if plan is None else _prepare(*args, plan)


def _operand(x: torch.Tensor, fmt, copy: bool) -> torch.Tensor:
    """`x` itself when it is dense in memory format `fmt` (not `copy`) and
    16-byte aligned, else a dense copy, counted in LAYOUT_COPIES. (A copy
    by `clone`: `Tensor.to(memory_format=)` aliases a channels-last view
    that is not dense, and `contiguous` keeps a misaligned one.)"""
    if not copy and x.data_ptr() % 16 == 0:
        return x
    LAYOUT_COPIES["gn"] += 1
    return x.clone(memory_format=fmt)


def _restored(out, x, prep: _Prepared):
    """`out` (the kernel's, in its layout) in x's memory format: a copy,
    counted, only where the kernel read a channels-last x as NCHW."""
    if not prep.restore:
        return out
    LAYOUT_COPIES["gn"] += 1
    return out.contiguous(memory_format=memory_format_of(x))


def _params(x, gamma, beta):
    """gamma and beta as the kernel reads them: [C] in one dtype of
    ELEM_CODES, contiguous (else fp32 copies)."""
    if (gamma.dtype == beta.dtype and gamma.dtype in ELEM_CODES
            and gamma.is_contiguous() and beta.is_contiguous()):
        return gamma, beta
    return (gamma.float().contiguous().to(x.device),
            beta.float().contiguous().to(x.device))


def _launch(entry, dev, *args) -> int:
    """`entry(*args, stream)` on device `dev`, on its current stream (the
    raw handle, as PyTorch's own generated kernels take it: a fraction of
    `torch.cuda.current_stream`'s host cost, paid on every call)."""
    idx = dev.index
    if idx == torch.cuda.current_device():
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(dev):
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))


def _fwd_stats(x, gamma, beta, groups: int, eps: float, act: bool,
               out_dtype, name: str, plan: Optional[GNPlan] = None):
    """The forward kernel on x in its own layout, with `plan` or the
    planner's (the CUDA tests and scripts/sweep_gn_plans.py force plans
    here): (y in x's memory format, [2, B, G] fp32: mean, rsig), counted
    as `name`."""
    g, bt = _params(x, gamma, beta)
    if g.device != x.device or bt.device != x.device:
        raise ValueError(f"gn_silu kernel: gamma and beta must be on "
                         f"{x.device}")
    prep = _prep(False, x, out_dtype, g.dtype, groups, act, eps, plan)
    with span(_SPANS[name]):
        xk = _operand(x, prep.fmt, prep.copy)
        y = torch.empty_like(xk, dtype=out_dtype)
        stats = torch.empty((2, x.shape[0], groups), dtype=torch.float32,
                            device=x.device)
        err = _launch(kernel_library().gn_fwd, x.device,
                      ctypes.byref(prep.call), xk.data_ptr(), g.data_ptr(),
                      bt.data_ptr(), y.data_ptr(), stats.data_ptr())
        raise_on(err, name)
        LAUNCHES[name] += 1
    return _restored(y, x, prep), stats


def _bwd_uv(x, dy, gamma, beta, mean_ptr: int, rsig_ptr: int, groups: int,
            act: bool, name: str, plan: Optional[GNPlan] = None):
    """The backward kernel on x and dy (in x's dtype) in x's layout, the
    statistics at `mean_ptr` and `rsig_ptr` (fp32 [B, G] each), with
    `plan` or the planner's: (dx in x's memory format, [2, B, C] fp32: u,
    v), counted as `name`."""
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"gn_silu kernel: dy {tuple(dy.shape)} is not "
                         f"{tuple(x.shape)}")
    g, bt = _params(x, gamma, beta)
    prep = _prep(True, x, x.dtype, g.dtype, groups, act, 0.0, plan)
    with span(_SPANS[name]):
        xk = _operand(x, prep.fmt, prep.copy)
        dyk = _operand(dy, prep.fmt,
                       not dy.is_contiguous(memory_format=prep.fmt))
        b, c = x.shape[:2]
        dx = torch.empty_like(xk)
        uv = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
        t12 = (torch.empty((2, b, groups), dtype=torch.float32,
                           device=x.device)
               if prep.streaming else None)
        err = _launch(kernel_library().gn_bwd, x.device,
                      ctypes.byref(prep.call), xk.data_ptr(), dyk.data_ptr(),
                      g.data_ptr(), bt.data_ptr(), mean_ptr, rsig_ptr,
                      dx.data_ptr(), uv.data_ptr(),
                      None if t12 is None else t12.data_ptr())
        raise_on(err, name)
        LAUNCHES[name] += 1
    return _restored(dx, x, prep), uv


def _check_gn(x, out_dtype) -> None:
    check_cuda("gn_silu", x)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"gn_silu kernel writes bfloat16, asked {out_dtype}")


def _check_general(x, out_dtype) -> None:
    check_cuda("gn_silu general kernel", x, dtypes=tuple(ELEM_CODES))
    elem_code(out_dtype)


def gn_silu_fwd_cuda(x, gamma, beta, groups: int, eps: float, act: bool,
                     out_dtype):
    """Forward kernel on the card: (y bf16 in x's memory format, mean
    [B, G], rsig [B, G]; mean and rsig are views of one [2, B, G])."""
    _check_gn(x, out_dtype)
    y, stats = _fwd_stats(x, gamma, beta, groups, eps, act, out_dtype,
                          "gn_silu_fwd")
    return y, stats[0], stats[1]


def gn_silu_fwd_general(x, gamma, beta, groups: int, eps: float, act: bool,
                        out_dtype):
    """The kernel's general instances on the card: x and y of any dtype
    in ELEM_CODES (y in out_dtype, in x's memory format)."""
    _check_general(x, out_dtype)
    y, stats = _fwd_stats(x, gamma, beta, groups, eps, act, out_dtype,
                          "gn_silu_fwd_general")
    return y, stats[0], stats[1]


def _bwd_public(check, name, x, dy, gamma, beta, mean, rsig, groups, act):
    """The backward wrappers' checks, then the kernel: (dx, u, v)."""
    dy = dy.to(x.dtype)
    check(x, x.dtype)
    check_cuda(name, x, dy, dtypes=tuple(ELEM_CODES))
    mean, rsig = mean.float().contiguous(), rsig.float().contiguous()
    if mean.shape != (x.shape[0], groups) or rsig.shape != mean.shape:
        raise ValueError(f"gn_silu kernel: statistics {tuple(mean.shape)}, "
                         f"{tuple(rsig.shape)} are not "
                         f"{(x.shape[0], groups)}")
    dx, uv = _bwd_uv(x, dy, gamma, beta, mean.data_ptr(), rsig.data_ptr(),
                     groups, act, name)
    return dx, uv[0], uv[1]


def gn_silu_bwd_cuda(x, dy, gamma, beta, mean, rsig, groups: int,
                     act: bool):
    """Backward kernel on the card: (dx bf16 in x's memory format, u
    [B, C], v [B, C]); dy is cast to x's dtype."""
    return _bwd_public(_check_gn, "gn_silu_bwd", x, dy, gamma, beta, mean,
                       rsig, groups, act)


def gn_silu_bwd_general(x, dy, gamma, beta, mean, rsig, groups: int,
                        act: bool):
    """The backward's general instances: dx in x's dtype and memory
    format, dy cast to x's dtype."""
    return _bwd_public(_check_general, "gn_silu_bwd_general", x, dy, gamma,
                       beta, mean, rsig, groups, act)


def gn_silu_fwd(x, gamma, beta, groups, eps, act, out_dtype):
    """The forward by gn_route."""
    return run_route(
        gn_route(x.device, x.dtype, out_dtype),
        lambda: gn_silu_fwd_ref(x, gamma, beta, groups, eps, act, out_dtype),
        lambda: gn_silu_fwd_cuda(x, gamma, beta, groups, eps, act,
                                 out_dtype),
        lambda: gn_silu_fwd_general(x, gamma, beta, groups, eps, act,
                                    out_dtype))


def gn_silu_bwd(x, dy, gamma, beta, mean, rsig, groups, act):
    """The backward by gn_route (dx is written in x's dtype)."""
    return run_route(
        gn_route(x.device, x.dtype, x.dtype),
        lambda: gn_silu_bwd_ref(x, dy, gamma, beta, mean, rsig, groups, act),
        lambda: gn_silu_bwd_cuda(x, dy, gamma, beta, mean, rsig, groups,
                                 act),
        lambda: gn_silu_bwd_general(x, dy, gamma, beta, mean, rsig, groups,
                                    act))


# The counters of the two kernel routes
_NAMES = {"kernel": ("gn_silu_fwd", "gn_silu_bwd"),
          "general": ("gn_silu_fwd_general", "gn_silu_bwd_general")}


class GNSiLUFunction(torch.autograd.Function):
    """Differentiable gn_silu (the JAX package's custom VJP): the forward
    saves x as it came and the group statistics ([2, B, G], one tensor),
    the backward is the kernel's. On the card both directions launch
    through the wrappers' inner calls: the route (from x's device and
    dtype) stands for the public wrappers' device and dtype checks, and
    the statistics pass as two pointers into one tensor, with no views."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, act, out_dtype):
        r = gn_route(x.device, x.dtype, out_dtype)
        if r == "cpu":
            y, mean, rsig = gn_silu_fwd_ref(x, gamma, beta, groups, eps, act,
                                            out_dtype)
            stats = torch.stack((mean, rsig))
        else:
            y, stats = _fwd_stats(x, gamma, beta, groups, eps, act,
                                  out_dtype, _NAMES[r][0])
        ctx.save_for_backward(x, gamma, beta, stats)
        ctx.groups, ctx.act, ctx.route = groups, act, r
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, stats = ctx.saved_tensors
        if ctx.route == "cpu":
            dx, u, v = gn_silu_bwd_ref(x, dy, gamma, beta, stats[0],
                                       stats[1], ctx.groups, ctx.act)
            uv = (u, v)
        else:
            dy = dy.to(x.dtype)
            if dy.device != x.device:
                raise ValueError("gn_silu kernel: dy is not on x's device")
            ptr = stats.data_ptr()
            dx, uv = _bwd_uv(x, dy, gamma, beta, ptr,
                             ptr + stats.stride(0) * stats.element_size(),
                             ctx.groups, ctx.act, _NAMES[ctx.route][1])
        need = ctx.needs_input_grad
        dgamma = uv[1].sum(0).to(gamma.dtype) if need[1] else None
        dbeta = uv[0].sum(0).to(beta.dtype) if need[2] else None
        return (dx if need[0] else None), dgamma, dbeta, None, None, None, None


def gn_silu(x, gamma, beta, groups: int, eps: float, act: bool, out_dtype):
    """cast(silu?(groupnorm(x))) over x [B, C, *spatial], NCHW or
    channels-last. Callers gate with gn_ok."""
    return GNSiLUFunction.apply(x, gamma, beta, groups, eps, act, out_dtype)
