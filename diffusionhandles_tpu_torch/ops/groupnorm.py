"""GroupNorm(+SiLU) with a hand-written kernel: the JAX package's
`ops/groupnorm.py` (Pallas `_gn_fwd_kernel` / `_gn_bwd_kernel`).

    y = cast(silu?(groupnorm(x; gamma, beta)))

x is NCHW ([B, C, *spatial]); a group of one image is one contiguous run
of (C / G) * H * W values. The kernels are CUDA C++ for Hopper
(`csrc/gn.cu`), built at first use (`utils/cuda_build.py`).

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
in and out, else its general instances (the same kernels over fp32, fp16
or bf16 x and y, rounding to x's dtype where the bf16 instance rounds to
bf16), counted as `gn_silu_fwd_general` / `gn_silu_bwd_general`. Both take
C divisible by the groups and H*W by 8, as the gate requires.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.utils.cuda_build import (ELEM_CODES,
                                                         check_cuda,
                                                         elem_code, general,
                                                         load_library,
                                                         raise_on, route,
                                                         run_route, stream_of)

# Launches of each kernel wrapper, the bf16 instance's and the general
# instances' (`<name>_general`), since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {
    n: 0 for k in ("gn_silu_fwd", "gn_silu_bwd") for n in (k, general(k))}

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
    out_dtype, mean [B, G] fp32, rsig [B, G] fp32)."""
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
    return z.reshape(x.shape).to(out_dtype), mean, rsig


def gn_silu_bwd_ref(x, dy, gamma, beta, mean, rsig, groups: int,
                    act: bool) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: (dx like x, u [B, C] fp32,
    v [B, C] fp32), u and v the per-channel sums of dz and dz * xh."""
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
    return dx.reshape(x.shape).to(x.dtype), u.reshape(b, c), v.reshape(b, c)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LIB = None


def kernel_library() -> ctypes.CDLL:
    """Build (first call) and load the GroupNorm kernels."""
    global _LIB
    if _LIB is None:
        lib = load_library("groupnorm", KERNEL_SOURCES)
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gn_fwd_bf16.argtypes = [ptr] * 7 + [i32] * 4 + [f32, i32, ptr]
        lib.gn_bwd_bf16.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        lib.gn_fwd_general.argtypes = ([i32] * 2 + [ptr] * 7 + [i32] * 4
                                       + [f32, i32, ptr])
        lib.gn_bwd_general.argtypes = [i32] + [ptr] * 11 + [i32] * 5 + [ptr]
        for fn in (lib.gn_fwd_bf16, lib.gn_bwd_bf16, lib.gn_fwd_general,
                   lib.gn_bwd_general):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _check_shape(x, groups: int) -> Tuple[int, int, int]:
    b, c = x.shape[:2]
    hw = x[0, 0].numel()
    if c % groups or hw % 8:
        raise ValueError(f"gn_silu kernel: C={c} must divide into {groups} "
                         f"groups and H*W={hw} be a multiple of 8")
    return b, c, hw


def _check_gn(x, groups: int, out_dtype) -> Tuple[int, int, int]:
    check_cuda("gn_silu", x, aligned=True)
    if out_dtype != torch.bfloat16:
        raise TypeError(f"gn_silu kernel writes bfloat16, asked {out_dtype}")
    return _check_shape(x, groups)


def _check_general(x, out_dtype, *rest) -> None:
    check_cuda("gn_silu general kernel", x, *rest, aligned=True,
               dtypes=tuple(ELEM_CODES))
    elem_code(out_dtype)


def _launch_fwd(entry, codes, x, gamma, beta, groups, eps, act, out_dtype):
    """Run a forward entry (the bf16 one, or the general one with the
    dtype codes `codes`) on contiguous x: (y, mean, rsig)."""
    b, c, hw = _check_shape(x, groups)
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    y = torch.empty_like(x, dtype=out_dtype)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rsig = torch.empty_like(mean)
    sums = torch.empty((2, b * c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = entry(*codes, x.data_ptr(), g32.data_ptr(), b32.data_ptr(),
                    y.data_ptr(), mean.data_ptr(), rsig.data_ptr(),
                    sums.data_ptr(), b, c, hw, groups, eps, int(act),
                    stream_of(x))
    return err, (y, mean, rsig)


def _launch_bwd(entry, codes, x, dy, gamma, beta, mean, rsig, groups, act):
    """Run a backward entry on contiguous x and dy in x's dtype: (dx, u,
    v)."""
    b, c, hw = _check_shape(x, groups)
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    mean, rsig = mean.contiguous(), rsig.contiguous()
    dx = torch.empty_like(x)
    u = torch.empty((b, c), dtype=torch.float32, device=x.device)
    v = torch.empty_like(u)
    t12 = torch.empty((2, b * groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = entry(*codes, x.data_ptr(), dy.data_ptr(), g32.data_ptr(),
                    b32.data_ptr(), mean.data_ptr(), rsig.data_ptr(),
                    dx.data_ptr(), u.data_ptr(), v.data_ptr(),
                    t12.data_ptr(), t12[1].data_ptr(), b, c, hw, groups,
                    int(act), stream_of(x))
    return err, (dx, u, v)


def gn_silu_fwd_cuda(x, gamma, beta, groups: int, eps: float, act: bool,
                     out_dtype):
    """Forward kernel on the card: (y bf16 like x, mean [B, G], rsig
    [B, G]). x in another memory format is copied to NCHW first."""
    x = x.contiguous()
    _check_gn(x, groups, out_dtype)
    err, out = _launch_fwd(kernel_library().gn_fwd_bf16, (), x, gamma, beta,
                           groups, eps, act, out_dtype)
    raise_on(err, "gn_silu_fwd")
    LAUNCHES["gn_silu_fwd"] += 1
    return out


def gn_silu_bwd_cuda(x, dy, gamma, beta, mean, rsig, groups: int,
                     act: bool):
    """Backward kernel on the card: (dx bf16, u [B, C], v [B, C])."""
    x = x.contiguous()
    _check_gn(x, groups, torch.bfloat16)
    dy = dy.to(torch.bfloat16).contiguous()
    check_cuda("gn_silu", x, dy, aligned=True)
    err, out = _launch_bwd(kernel_library().gn_bwd_bf16, (), x, dy, gamma,
                           beta, mean, rsig, groups, act)
    raise_on(err, "gn_silu_bwd")
    LAUNCHES["gn_silu_bwd"] += 1
    return out


def gn_silu_fwd_general(x, gamma, beta, groups: int, eps: float, act: bool,
                        out_dtype):
    """The kernel's general instances on the card: x and y of any dtype
    in ELEM_CODES (y in out_dtype, like x)."""
    x = x.contiguous()
    _check_general(x, out_dtype)
    err, out = _launch_fwd(kernel_library().gn_fwd_general,
                           (ELEM_CODES[x.dtype], ELEM_CODES[out_dtype]), x,
                           gamma, beta, groups, eps, act, out_dtype)
    raise_on(err, "gn_silu_fwd_general")
    LAUNCHES["gn_silu_fwd_general"] += 1
    return out


def gn_silu_bwd_general(x, dy, gamma, beta, mean, rsig, groups: int,
                        act: bool):
    """The backward's general instances: dx in x's dtype, dy cast to it."""
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    _check_general(x, x.dtype, dy)
    err, out = _launch_bwd(kernel_library().gn_bwd_general,
                           (ELEM_CODES[x.dtype],), x, dy, gamma, beta, mean,
                           rsig, groups, act)
    raise_on(err, "gn_silu_bwd_general")
    LAUNCHES["gn_silu_bwd_general"] += 1
    return out


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


class GNSiLUFunction(torch.autograd.Function):
    """Differentiable gn_silu (the JAX package's custom VJP): the forward
    saves the group statistics, the backward is the kernel's."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps, act, out_dtype):
        x = x.contiguous()  # saved as the kernels take it
        y, mean, rsig = gn_silu_fwd(x, gamma, beta, groups, eps, act,
                                    out_dtype)
        ctx.save_for_backward(x, gamma, beta, mean, rsig)
        ctx.groups, ctx.act = groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rsig = ctx.saved_tensors
        dx, u, v = gn_silu_bwd(x, dy.contiguous(), gamma, beta, mean, rsig,
                               ctx.groups, ctx.act)
        need = ctx.needs_input_grad
        dgamma = v.sum(0).to(gamma.dtype) if need[1] else None
        dbeta = u.sum(0).to(beta.dtype) if need[2] else None
        return (dx if need[0] else None), dgamma, dbeta, None, None, None, None


def gn_silu(x, gamma, beta, groups: int, eps: float, act: bool, out_dtype):
    """cast(silu?(groupnorm(x))) over NCHW x. Callers gate with gn_ok."""
    return GNSiLUFunction.apply(x, gamma, beta, groups, eps, act, out_dtype)
