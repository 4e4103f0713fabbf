"""Fused GroupNorm + SiLU + 3x3 conv with hand-written kernels: the JAX
package's `ops/gn_conv.py` (Pallas `_gn_conv_fwd_kernel` /
`_gn_conv_bwd_kernel`).

    y = conv3x3(silu(groupnorm(x; gamma, beta)), w)    SAME, stride 1

x is [B, Ci, H, W], w PyTorch's [Co, Ci, 3, 3]; no conv bias (the caller
adds it after the op, in the compute dtype). The kernels are CUDA C++ for
Hopper (`csrc/gn_conv.cu`, in the library of `ops/conv.py`): the statistics
and the normalization are passes of their own around K7's TMA + wgmma
implicit GEMM (`csrc/conv.cu`), whose tile and K split come from K7's
planner. On the card they take and return channels-last memory
(`torch.channels_last`), like K7; an input in another memory format is
copied first (counted in `LAYOUT_COPIES`).

Numerics are the TPU kernels', reproduced by the plain versions
(`gn_silu_conv3x3_fwd_ref`, `gn_silu_conv3x3_dx_ref`):
  forward: fp32 statistics E[x^2] - E[x]^2 over each group, not clamped;
           normalize, affine and SiLU in fp32, rounded to x's dtype (z,
           `gn_silu_z_ref`); nine taps of products in x's dtype summed in
           fp32; the sum rounded.
  dx:      dy rounded to x's dtype; dz = fp32 sum of products with
           w[2-di, 2-dj]^T; dxh = dz * silu'(ygn) * gamma; the GroupNorm
           backward in fp32, dx = rsig * (dxh - mean_g(dxh)
           - xh * mean_g(dxh * xh)).
The parameter gradients are plain recomputations, made only when autograd
asks for them (the pipeline's weights are frozen). Sites the gate refuses
take `gn_silu_conv3x3_ref`, the unfused composition. A call the gate
admits takes the route `gn_conv_route` names from its device, dtype and
channels: the plain version on the CPU; on the card the kernels for bf16
or fp16 (an instance each) with Ci and Co multiples of 8, else their
general instances (the same passes in x's dtype, one channel a thread,
around K7's general GEMM, `csrc/conv_general.cu`: tf32 on the tensor
cores, fp32 as three passes, planned by `plan_conv3x3_general`), counted as
`gn_silu_conv3x3_fwd_general` / `gn_silu_conv3x3_dx_general`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.ops.conv import (CHANNEL_MULTIPLE, ConvPlan,
                                                 in_kernel_layout,
                                                 kernel_library,
                                                 plan_conv3x3,
                                                 plan_conv3x3_general)
from diffusionhandles_tpu_torch.ops.groupnorm import (grouped, per_channel,
                                                      silu_grad)
from diffusionhandles_tpu_torch.utils.cuda_build import (ELEM_CODES,
                                                         HALF_SUFFIX,
                                                         check_cuda,
                                                         elem_code, general,
                                                         raise_on, route,
                                                         run_route, stream_of)
from diffusionhandles_tpu_torch.utils.profiling import span

# Launches of each kernel wrapper, the Hopper kernels' and the general
# instances' (`<name>_general`), since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {
    n: 0 for k in ("gn_silu_conv3x3_fwd", "gn_silu_conv3x3_dx")
    for n in (k, general(k))}
# Inputs the wrappers copied into the kernels' layout (dense channels-last).
LAYOUT_COPIES: Dict[str, int] = {"gn_conv": 0}

SLOT = 8  # pixels of one partial-sum slot (csrc/gn_conv.cu)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Routing gate: the JAX package's gn_silu_conv3x3_ok (gn_conv.py:292-313),
# so that the same resnet halves take the kernels in both packages.
# ---------------------------------------------------------------------------

def _vmem_estimate(h, wdt, ci, co) -> int:
    s_pad = (h + 3) * (wdt + 2)
    s_out = h * (wdt + 2)
    f32 = 4 * s_pad * ci * 3 + 4 * s_out * ci * 2
    wts = 2 * 9 * ci * co * 2
    io = 2 * s_pad * (ci + co) + 2 * s_out * ci
    return f32 + wts + io


def gn_silu_conv3x3_ok(x_shape: Sequence[int], w_shape: Sequence[int],
                       groups: int) -> bool:
    """True where the JAX package runs its fused kernel. Shapes are in the
    JAX package's layouts: x [B, H, W, Ci], w [3, 3, Ci, Co]."""
    if len(w_shape) != 4 or w_shape[0] != 3 or w_shape[1] != 3:
        return False
    b, h, wdt, ci = x_shape
    co = w_shape[-1]
    if ci % groups or ci // groups < 1:
        return False
    if ci < 64 or co < 64 or (h * (wdt + 2)) % 8:
        return False
    return _vmem_estimate(h, wdt, ci, co) < 72 * 1024 * 1024


def gn_conv_route(device, dtype, ci: int, co: int) -> str:
    """The route (`utils.cuda_build.route`) of a call of Ci -> Co channels
    with x in `dtype` on `device`: the Hopper kernels take bf16 or fp16
    with Ci and Co multiples of 8 (K7's GEMM: TMA strides are 16-byte
    units), the general instances the rest."""
    return route(device, dtype in HALF_SUFFIX
                 and ci % CHANNEL_MULTIPLE == 0
                 and co % CHANNEL_MULTIPLE == 0)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def _group_stats(x, groups: int, eps: float):
    """fp32 (mean, rsig) [B, G]: E[x^2] - E[x]^2, not clamped."""
    xg = grouped(x, groups).float()
    n = xg.shape[2] * xg.shape[3]
    mean = xg.sum((2, 3)) / n
    var = (xg * xg).sum((2, 3)) / n - mean * mean
    return mean, torch.rsqrt(var + eps)


def _normalized(x, mean, rsig, groups: int):
    """fp32 xh = (x - mean) * rsig, [B, G, Ci/G, H*W]."""
    return ((grouped(x, groups).float() - mean[:, :, None, None])
            * rsig[:, :, None, None])


def gn_silu_z_ref(x, mean, rsig, gamma, beta, groups: int):
    """Plain version of the forward's prologue kernel: z = silu((x - mean)
    * rsig * gamma + beta) in fp32, rounded to x's dtype."""
    z = F.silu(_normalized(x, mean, rsig, groups) * per_channel(gamma, groups)
               + per_channel(beta, groups))
    return z.reshape(x.shape).to(x.dtype)


def gn_silu_conv3x3_fwd_ref(x, gamma, beta, w, groups: int, eps: float):
    """Plain version of the forward kernels: (y [B, Co, H, W] in x's dtype,
    mean [B, G], rsig [B, G]): the statistics, the prologue's z, and the
    conv of z summed in fp32."""
    mean, rsig = _group_stats(x, groups, eps)
    z = gn_silu_z_ref(x, mean, rsig, gamma, beta, groups)
    y = F.conv2d(z.float(), w.to(x.dtype).float(), padding=1)
    return y.to(x.dtype), mean, rsig


def gn_silu_conv3x3_dx_ref(x, gamma, beta, w, mean, rsig, dy, groups: int):
    """Plain version of the dx kernels: dx like x."""
    dz = F.conv_transpose2d(dy.to(x.dtype).float(), w.to(x.dtype).float(),
                            padding=1)
    xh = _normalized(x, mean, rsig, groups)
    g = per_channel(gamma, groups)
    dxh = grouped(dz, groups) * silu_grad(
        xh * g + per_channel(beta, groups)) * g
    n = xh.shape[2] * xh.shape[3]
    t1 = dxh.sum((2, 3), keepdim=True) / n
    t2 = (dxh * xh).sum((2, 3), keepdim=True) / n
    dx = rsig[:, :, None, None] * (dxh - t1 - xh * t2)
    return dx.reshape(x.shape).to(x.dtype)


def gn_silu_conv3x3_ref(x, gamma, beta, w, groups: int, eps: float):
    """The unfused composition (ineligible sites): fp32 GroupNorm, SiLU, a
    cast to x's dtype, the conv in x's dtype."""
    z = F.silu(F.group_norm(x.float(), groups, gamma.float(), beta.float(),
                            eps)).to(x.dtype)
    return F.conv2d(z, w.to(x.dtype), padding=1)


def _param_grads(x, gamma, beta, w, dy, groups: int, eps: float, need):
    """dgamma, dbeta, dw as plain recomputations (the JAX custom VJP's)."""
    xh = F.group_norm(x.float(), groups, eps=eps)
    xgn = xh * gamma.float()[:, None, None] + beta.float()[:, None, None]
    dyx = dy.to(x.dtype).float()
    # dz rounded to x's dtype, as the JAX VJP's tap-matmul conv returns it
    dz = F.conv_transpose2d(dyx, w.to(x.dtype).float(),
                            padding=1).to(x.dtype).float()
    dgn = dz * silu_grad(xgn)
    dgamma = (dgn * xh).sum((0, 2, 3)).to(gamma.dtype) if need[1] else None
    dbeta = dgn.sum((0, 2, 3)).to(beta.dtype) if need[2] else None
    dw = None
    if need[3]:
        z = F.silu(xgn).to(x.dtype).float()
        dw = torch.nn.grad.conv2d_weight(z, w.shape, dyx,
                                         padding=1).to(w.dtype)
    return dgamma, dbeta, dw


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_conv(x, w, groups: int) -> Tuple[int, ...]:
    check_cuda("gn_silu_conv3x3", x, w, dtypes=tuple(HALF_SUFFIX))
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"gn_silu_conv3x3: w {tuple(w.shape)} is not "
                         f"[Co, {ci}, 3, 3]")
    if (ci % groups or ci % CHANNEL_MULTIPLE or co % CHANNEL_MULTIPLE):
        raise ValueError(f"gn_silu_conv3x3 kernel: Ci={ci} must divide "
                         f"into {groups} groups, and Ci and Co={co} be "
                         f"multiples of {CHANNEL_MULTIPLE}")
    for t in (x, w):
        if not in_kernel_layout(t) or t.data_ptr() % 16:
            raise ValueError("gn_silu_conv3x3 kernel takes dense "
                             "channels-last, 16-byte aligned tensors")
    return b, ci, co, h, wd


def _operand(t: torch.Tensor, dtype) -> torch.Tensor:
    """`t` in the kernels' layout (dense channels-last) and `dtype`: `t`
    itself when it is, else a copy, counted in LAYOUT_COPIES. (`Tensor.to`
    with a memory format would alias a channels-last slice that is not
    dense, such as a channel slice of a concat's gradient.)"""
    out = t.to(dtype).contiguous(memory_format=torch.channels_last)
    if out is not t:
        LAYOUT_COPIES["gn_conv"] += 1
    return out


def _slot_sums(b: int, h: int, wd: int, ci: int, device) -> torch.Tensor:
    """fp32 scratch of the per-slot channel sums (csrc/gn_conv.cu)."""
    return torch.empty((2 * b * math.ceil(h * wd / SLOT) * ci,),
                       dtype=torch.float32, device=device)


def _fwd_launch(x, gamma, beta, w, groups: int, eps: float,
                plan: Optional[ConvPlan] = None):
    """The forward kernels on channels-last bf16 or fp16 x and w, with
    `plan` or the planner's (the CUDA tests force plans through here to
    reach every kernel instance): (y, mean, rsig)."""
    b, ci, co, h, wd = _check_conv(x, w, groups)
    plan = plan or plan_conv3x3(b, h, wd, ci, co)
    with span("kernel.gn_silu_conv3x3_fwd"):
        dev = x.device
        y = torch.empty((b, co, h, wd), dtype=x.dtype, device=dev,
                        memory_format=torch.channels_last)
        z = torch.empty_like(x)
        mean = torch.empty((b, groups), dtype=torch.float32, device=dev)
        rsig = torch.empty_like(mean)
        sums = _slot_sums(b, h, wd, ci, dev)
        part = (torch.empty((plan.splits * b * h * wd * co,),
                            dtype=torch.float32, device=dev)
                if plan.splits > 1 else None)
        g32 = gamma.float().contiguous()
        b32 = beta.float().contiguous()
        with torch.cuda.device(dev):
            err = getattr(kernel_library(),
                          f"gn_conv_fwd_{HALF_SUFFIX[x.dtype]}")(
                x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
                y.data_ptr(), z.data_ptr(), mean.data_ptr(), rsig.data_ptr(),
                sums.data_ptr(), None if part is None else part.data_ptr(), b,
                h, wd, ci, co, groups, eps, *plan.launch_args(), stream_of(x))
        raise_on(err, "gn_silu_conv3x3_fwd")
        LAUNCHES["gn_silu_conv3x3_fwd"] += 1
    return y, mean, rsig


def _dx_launch(x, gamma, beta, w, mean, rsig, dy, groups: int,
               plan: Optional[ConvPlan] = None):
    """The dx kernels on channels-last bf16 or fp16 x, w and dy, with
    `plan` (the dx GEMM's, fp32 out) or the planner's: dx, channels-last
    in their type."""
    b, ci, co, h, wd = _check_conv(x, w, groups)
    check_cuda("gn_silu_conv3x3", x, dy, dtypes=tuple(HALF_SUFFIX))
    if tuple(dy.shape) != (b, co, h, wd) or not in_kernel_layout(dy):
        raise ValueError(f"gn_silu_conv3x3: dy {tuple(dy.shape)} is not a "
                         f"channels-last {(b, co, h, wd)}")
    plan = plan or plan_conv3x3(b, h, wd, co, ci, f32_out=True)
    with span("kernel.gn_silu_conv3x3_dx"):
        dev = x.device
        dx = torch.empty_like(x)
        part = torch.empty((plan.splits * b * h * wd * ci,),
                           dtype=torch.float32, device=dev)
        dxh = torch.empty((b * h * wd * ci,), dtype=torch.float32, device=dev)
        sums = _slot_sums(b, h, wd, ci, dev)
        t12 = torch.empty((2 * b * groups,), dtype=torch.float32, device=dev)
        g32 = gamma.float().contiguous()
        b32 = beta.float().contiguous()
        mean, rsig = mean.contiguous(), rsig.contiguous()
        with torch.cuda.device(dev):
            err = getattr(kernel_library(),
                          f"gn_conv_dx_{HALF_SUFFIX[x.dtype]}")(
                x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
                mean.data_ptr(), rsig.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                part.data_ptr(), dxh.data_ptr(), sums.data_ptr(),
                t12.data_ptr(), b, h, wd, ci, co, groups, *plan.launch_args(),
                stream_of(x))
        raise_on(err, "gn_silu_conv3x3_dx")
        LAUNCHES["gn_silu_conv3x3_dx"] += 1
    return dx


def gn_silu_conv3x3_fwd_cuda(x, gamma, beta, w, groups: int, eps: float):
    """Forward kernels on the card: (y [B, Co, H, W] in x's dtype, bf16 or
    fp16, in channels-last memory, mean [B, G], rsig [B, G]). x and w in
    another memory format are copied to channels-last first (the fused
    U-Net holds its weights there); w is cast to x's dtype."""
    return _fwd_launch(_operand(x, x.dtype), gamma, beta,
                       _operand(w, x.dtype), groups, eps)


def gn_silu_conv3x3_dx_cuda(x, gamma, beta, w, mean, rsig, dy, groups: int):
    """dx kernels on the card: dx [B, Ci, H, W] in x's dtype, bf16 or
    fp16, in channels-last memory. x, w and dy in another memory format
    are copied first; w and dy are cast to x's dtype."""
    return _dx_launch(_operand(x, x.dtype), gamma, beta,
                      _operand(w, x.dtype), mean, rsig,
                      _operand(dy, x.dtype), groups)


def _check_general(x, w, groups: int) -> Tuple[int, ...]:
    check_cuda("gn_silu_conv3x3 general kernels", x, w,
               dtypes=tuple(ELEM_CODES))
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3) or ci % groups:
        raise ValueError(f"gn_silu_conv3x3: w {tuple(w.shape)} is not "
                         f"[Co, {ci}, 3, 3] or Ci does not divide into "
                         f"{groups} groups")
    return b, ci, co, h, wd


def gn_silu_conv3x3_fwd_general(x, gamma, beta, w, groups: int,
                                eps: float):
    """The forward's general instances on the card (fp32, fp16 or bf16,
    any Ci and Co), the GEMM planned by `plan_conv3x3_general`: (y [B, Co,
    H, W] in x's dtype, channels-last memory, mean [B, G], rsig [B, G])."""
    x = _operand(x, x.dtype)
    w = _operand(w, x.dtype)
    b, ci, co, h, wd = _check_general(x, w, groups)
    plan = plan_conv3x3_general(b, h, wd, ci, co)
    with span("kernel.gn_silu_conv3x3_fwd_general"):
        dev = x.device
        part = (torch.empty((plan.splits * b * h * wd * co,),
                            dtype=torch.float32, device=dev)
                if plan.splits > 1 else None)
        y = torch.empty((b, co, h, wd), dtype=x.dtype, device=dev,
                        memory_format=torch.channels_last)
        z = torch.empty_like(x)
        mean = torch.empty((b, groups), dtype=torch.float32, device=dev)
        rsig = torch.empty_like(mean)
        sums = _slot_sums(b, h, wd, ci, dev)
        g32 = gamma.float().contiguous()
        b32 = beta.float().contiguous()
        with torch.cuda.device(dev):
            err = kernel_library().gn_conv_fwd_general(
                elem_code(x.dtype), x.data_ptr(), g32.data_ptr(),
                b32.data_ptr(), w.data_ptr(), y.data_ptr(), z.data_ptr(),
                mean.data_ptr(), rsig.data_ptr(), sums.data_ptr(),
                None if part is None else part.data_ptr(), b, h, wd, ci, co,
                groups, eps, *plan.launch_args(), stream_of(x))
        raise_on(err, "gn_silu_conv3x3_fwd_general")
        LAUNCHES["gn_silu_conv3x3_fwd_general"] += 1
    return y, mean, rsig


def gn_silu_conv3x3_dx_general(x, gamma, beta, w, mean, rsig, dy,
                               groups: int):
    """dx's general instances on the card, the GEMM planned by
    `plan_conv3x3_general` with fp32 out: dx [B, Ci, H, W] in x's dtype,
    channels-last memory (dy cast to x's dtype)."""
    x = _operand(x, x.dtype)
    w = _operand(w, x.dtype)
    dy = _operand(dy, x.dtype)
    b, ci, co, h, wd = _check_general(x, w, groups)
    if tuple(dy.shape) != (b, co, h, wd):
        raise ValueError(f"gn_silu_conv3x3: dy {tuple(dy.shape)} is not "
                         f"{(b, co, h, wd)}")
    plan = plan_conv3x3_general(b, h, wd, co, ci, f32_out=True)
    with span("kernel.gn_silu_conv3x3_dx_general"):
        dev = x.device
        dx = torch.empty_like(x)
        part = torch.empty((plan.splits * b * h * wd * ci,),
                           dtype=torch.float32, device=dev)
        dxh = torch.empty((b * h * wd * ci,), dtype=torch.float32, device=dev)
        sums = _slot_sums(b, h, wd, ci, dev)
        t12 = torch.empty((2 * b * groups,), dtype=torch.float32, device=dev)
        g32 = gamma.float().contiguous()
        b32 = beta.float().contiguous()
        mean, rsig = mean.contiguous(), rsig.contiguous()
        with torch.cuda.device(dev):
            err = kernel_library().gn_conv_dx_general(
                elem_code(x.dtype), x.data_ptr(), g32.data_ptr(),
                b32.data_ptr(), w.data_ptr(), mean.data_ptr(),
                rsig.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                part.data_ptr(), dxh.data_ptr(), sums.data_ptr(),
                t12.data_ptr(), b, h, wd, ci, co, groups,
                *plan.launch_args(), stream_of(x))
        raise_on(err, "gn_silu_conv3x3_dx_general")
        LAUNCHES["gn_silu_conv3x3_dx_general"] += 1
    return dx


def _route(x, w) -> str:
    return gn_conv_route(x.device, x.dtype, x.shape[1], w.shape[0])


def gn_silu_conv3x3_fwd(x, gamma, beta, w, groups, eps):
    """The forward by gn_conv_route."""
    return run_route(
        _route(x, w),
        lambda: gn_silu_conv3x3_fwd_ref(x, gamma, beta, w, groups, eps),
        lambda: gn_silu_conv3x3_fwd_cuda(x, gamma, beta, w, groups, eps),
        lambda: gn_silu_conv3x3_fwd_general(x, gamma, beta, w, groups, eps))


def gn_silu_conv3x3_dx(x, gamma, beta, w, mean, rsig, dy, groups):
    """dx by gn_conv_route."""
    return run_route(
        _route(x, w),
        lambda: gn_silu_conv3x3_dx_ref(x, gamma, beta, w, mean, rsig, dy,
                                       groups),
        lambda: gn_silu_conv3x3_dx_cuda(x, gamma, beta, w, mean, rsig, dy,
                                        groups),
        lambda: gn_silu_conv3x3_dx_general(x, gamma, beta, w, mean, rsig, dy,
                                           groups))


class GNSiLUConv3x3Function(torch.autograd.Function):
    """Differentiable gn_silu_conv3x3 (the JAX package's custom VJP): the
    forward saves the group statistics, dx is the kernels', the parameter
    gradients plain recomputations."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, groups, eps):
        if _route(x, w) != "cpu":
            x = _operand(x, x.dtype)  # saved as the kernels take it
        y, mean, rsig = gn_silu_conv3x3_fwd(x, gamma, beta, w, groups, eps)
        ctx.save_for_backward(x, gamma, beta, w, mean, rsig)
        ctx.groups, ctx.eps = groups, eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, mean, rsig = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = (gn_silu_conv3x3_dx(x, gamma, beta, w, mean, rsig, dy,
                                 ctx.groups)
              if need[0] else None)
        dgamma = dbeta = dw = None
        if any(need[1:4]):
            dgamma, dbeta, dw = _param_grads(x, gamma, beta, w, dy,
                                             ctx.groups, ctx.eps, need)
        return dx, dgamma, dbeta, dw, None, None


def gn_silu_conv3x3(x, gamma, beta, w, groups: int, eps: float):
    """conv3x3(silu(groupnorm(x))) over x [B, Ci, H, W], no bias. Callers
    gate with gn_silu_conv3x3_ok."""
    return GNSiLUConv3x3Function.apply(x, gamma, beta, w, groups, eps)
