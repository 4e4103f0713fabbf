"""Fused GroupNorm + SiLU + 3x3 conv with hand-written kernels: the JAX
package's `ops/gn_conv.py` (Pallas `_gn_conv_fwd_kernel` /
`_gn_conv_bwd_kernel`).

    y = conv3x3(silu(groupnorm(x; gamma, beta)), w)    SAME, stride 1

x is NCHW [B, Ci, H, W], w PyTorch's [Co, Ci, 3, 3]; no conv bias (the
caller adds it after the op, in the compute dtype). The kernels are CUDA
C++ for Hopper (`csrc/gn_conv.cu`), in the library of `ops/groupnorm.py`.

Numerics are the TPU kernels', reproduced by the plain versions
(`gn_silu_conv3x3_fwd_ref`, `gn_silu_conv3x3_dx_ref`):
  forward: fp32 statistics E[x^2] - E[x]^2 over each group, not clamped;
           normalize, affine and SiLU in fp32, rounded to x's dtype; nine
           taps of products in x's dtype summed in fp32; the sum rounded.
  dx:      dy rounded to x's dtype; dz = fp32 sum of products with
           w[2-di, 2-dj]^T; dxh = dz * silu'(ygn) * gamma; the GroupNorm
           backward in fp32, dx = rsig * (dxh - mean_g(dxh)
           - xh * mean_g(dxh * xh)).
The parameter gradients are plain recomputations, made only when autograd
asks for them (the pipeline's weights are frozen). Sites the gate refuses
take `gn_silu_conv3x3_ref`, the unfused composition.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.ops.groupnorm import (grouped,
                                                      kernel_library,
                                                      per_channel, silu_grad)
from diffusionhandles_tpu_torch.utils.cuda_build import (check_cuda_bf16,
                                                         raise_on, stream_of)

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"gn_silu_conv3x3_fwd": 0,
                            "gn_silu_conv3x3_dx": 0}

CONV_TILE = 64   # output pixels and output channels of one CTA (gn_conv.cu)
CHANNEL_STEP = 16  # input channels per K step: both Ci and Co divide by it


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


def gn_silu_conv3x3_fwd_ref(x, gamma, beta, w, groups: int, eps: float):
    """Plain version of the forward kernel: (y [B, Co, H, W] in x's dtype,
    mean [B, G], rsig [B, G])."""
    mean, rsig = _group_stats(x, groups, eps)
    xh = _normalized(x, mean, rsig, groups)
    z = F.silu(xh * per_channel(gamma, groups)
               + per_channel(beta, groups))
    z = z.reshape(x.shape).to(x.dtype)
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
    check_cuda_bf16("gn_silu_conv3x3", x, w, aligned=True)
    b, ci, h, wd = x.shape
    co = w.shape[0]
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"gn_silu_conv3x3: w {tuple(w.shape)} is not "
                         f"[Co, {ci}, 3, 3]")
    if ci % groups or ci % CHANNEL_STEP or co % CHANNEL_STEP:
        raise ValueError(f"gn_silu_conv3x3 kernel: Ci={ci} must divide "
                         f"into {groups} groups, and Ci and Co={co} be "
                         f"multiples of {CHANNEL_STEP}")
    if (h * wd) % 8:
        raise ValueError(f"gn_silu_conv3x3 kernel: H*W={h * wd} must be a "
                         "multiple of 8")
    return b, ci, co, h, wd


def gn_silu_conv3x3_fwd_cuda(x, gamma, beta, w, groups: int, eps: float):
    """Forward kernels on the card: (y [B, Co, H, W] bf16, mean [B, G],
    rsig [B, G]). x in another memory format is copied to NCHW first."""
    x = x.contiguous()
    w = w.to(torch.bfloat16).contiguous()
    b, ci, co, h, wd = _check_conv(x, w, groups)
    lib = kernel_library()
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    y = torch.empty((b, co, h, wd), dtype=torch.bfloat16, device=x.device)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rsig = torch.empty_like(mean)
    sums = torch.empty((2, b * ci), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gn_conv_fwd_bf16(
            x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
            y.data_ptr(), mean.data_ptr(), rsig.data_ptr(), sums.data_ptr(),
            b, ci, co, h, wd, groups, eps, stream_of(x))
    raise_on(err, "gn_silu_conv3x3_fwd")
    LAUNCHES["gn_silu_conv3x3_fwd"] += 1
    return y, mean, rsig


def gn_silu_conv3x3_dx_cuda(x, gamma, beta, w, mean, rsig, dy, groups: int):
    """dx kernels on the card: dx [B, Ci, H, W] bf16."""
    x = x.contiguous()
    w = w.to(torch.bfloat16).contiguous()
    dy = dy.to(torch.bfloat16).contiguous()
    b, ci, co, h, wd = _check_conv(x, w, groups)
    check_cuda_bf16("gn_silu_conv3x3", x, dy, aligned=True)
    if tuple(dy.shape) != (b, co, h, wd):
        raise ValueError(f"gn_silu_conv3x3: dy {tuple(dy.shape)} is not "
                         f"{(b, co, h, wd)}")
    lib = kernel_library()
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    mean, rsig = mean.contiguous(), rsig.contiguous()
    mtiles = -(-h * wd // CONV_TILE)
    dx = torch.empty_like(x)
    dxh = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    part = torch.empty((2, b * mtiles * ci), dtype=torch.float32,
                       device=x.device)
    t12 = torch.empty((2, b * groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gn_conv_dx_bf16(
            x.data_ptr(), g32.data_ptr(), b32.data_ptr(), w.data_ptr(),
            mean.data_ptr(), rsig.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dxh.data_ptr(), part.data_ptr(), t12.data_ptr(), b, ci, co, h,
            wd, groups, stream_of(x))
    raise_on(err, "gn_silu_conv3x3_dx")
    LAUNCHES["gn_silu_conv3x3_dx"] += 1
    return dx


def gn_silu_conv3x3_fwd(x, gamma, beta, w, groups, eps):
    """The forward kernels for CUDA tensors; the plain version for CPU
    ones."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_fwd_ref(x, gamma, beta, w, groups, eps)
    return gn_silu_conv3x3_fwd_cuda(x, gamma, beta, w, groups, eps)


def gn_silu_conv3x3_dx(x, gamma, beta, w, mean, rsig, dy, groups):
    """The dx kernels for CUDA tensors; the plain version for CPU ones."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_dx_ref(x, gamma, beta, w, mean, rsig, dy,
                                      groups)
    return gn_silu_conv3x3_dx_cuda(x, gamma, beta, w, mean, rsig, dy, groups)


class GNSiLUConv3x3Function(torch.autograd.Function):
    """Differentiable gn_silu_conv3x3 (the JAX package's custom VJP): the
    forward saves the group statistics, dx is the kernels', the parameter
    gradients plain recomputations."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, groups, eps):
        x = x.contiguous()  # saved as the kernels take it
        y, mean, rsig = gn_silu_conv3x3_fwd(x, gamma, beta, w, groups, eps)
        ctx.save_for_backward(x, gamma, beta, w, mean, rsig)
        ctx.groups, ctx.eps = groups, eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w, mean, rsig = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = (gn_silu_conv3x3_dx(x, gamma, beta, w, mean, rsig,
                                 dy.contiguous(), ctx.groups)
              if need[0] else None)
        dgamma = dbeta = dw = None
        if any(need[1:4]):
            dgamma, dbeta, dw = _param_grads(x, gamma, beta, w, dy,
                                             ctx.groups, ctx.eps, need)
        return dx, dgamma, dbeta, dw, None, None


def gn_silu_conv3x3(x, gamma, beta, w, groups: int, eps: float):
    """conv3x3(silu(groupnorm(x))) over NCHW x, no bias. Callers gate with
    gn_silu_conv3x3_ok."""
    return GNSiLUConv3x3Function.apply(x, gamma, beta, w, groups, eps)
