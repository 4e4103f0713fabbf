"""3x3 SAME stride-1 convolution with a hand-written kernel: the JAX
package's `ops/conv.py` (Pallas `_conv3_kernel`, reached through `conv3x3`
and `UNetConfig(pallas_conv=True)`).

    y = conv3x3(x, w)        x NCHW [B, Ci, H, W], w [Co, Ci, 3, 3]

No bias: the caller adds it after the op, in the compute dtype. The kernel
is CUDA C++ for Hopper (`csrc/conv.cu`, the implicit-GEMM mainloop of
`csrc/conv3x3_gemm.cuh` that the fused GroupNorm conv shares), built at
first use (`utils/cuda_build.py`).

Numerics are the TPU kernel's, reproduced by the plain versions
(`conv3x3_fwd_ref`, `conv3x3_dx_ref`): w cast to x's dtype, products of
the nine taps summed in fp32, the sum rounded once to x's dtype. dx is the
same conv of dy (cast to x's dtype) with the flipped, in/out-transposed
kernel. dw is a plain fp32 recomputation (the JAX package's `_dw_taps` is
XLA, not Pallas), made only when autograd asks for it: the pipeline's
weights are frozen. A wrapper runs the plain version only for tensors on
the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.utils.cuda_build import (check_cuda_bf16,
                                                         load_library,
                                                         raise_on, stream_of)

# Launches of each kernel wrapper since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"conv3x3_fwd": 0, "conv3x3_dx": 0}

KERNEL_SOURCES = ("conv.cu",)
CHANNEL_STEP = 16  # channels per K step of the GEMM: Ci and Co divide by it


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
    """Build (first call) and load the conv kernels."""
    global _LIB
    if _LIB is None:
        lib = load_library("conv3x3", KERNEL_SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.conv3x3_fwd_bf16, lib.conv3x3_dx_bf16):
            fn.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def _check(src, w, ci: int, co: int) -> Tuple[int, int, int]:
    check_cuda_bf16("conv3x3", src, w, aligned=True)
    if tuple(w.shape) != (co, ci, 3, 3):
        raise ValueError(f"conv3x3: w {tuple(w.shape)} is not "
                         f"[{co}, {ci}, 3, 3]")
    if ci % CHANNEL_STEP or co % CHANNEL_STEP:
        raise ValueError(f"conv3x3 kernel: Ci={ci} and Co={co} must be "
                         f"multiples of {CHANNEL_STEP}")
    b, _, h, wd = src.shape
    return b, h, wd


def conv3x3_fwd_cuda(x, w):
    """The kernel on the card: y [B, Co, H, W] bf16. x in another memory
    format is copied to NCHW first."""
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    co, ci = w.shape[:2]
    if x.dim() != 4 or x.shape[1] != ci:
        raise ValueError(f"conv3x3: x {tuple(x.shape)} is not [B, {ci}, H, W]")
    b, h, wd = _check(x, w, ci, co)
    lib = kernel_library()
    y = torch.empty((b, co, h, wd), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                   b, ci, co, h, wd, stream_of(x))
    raise_on(err, "conv3x3_fwd")
    LAUNCHES["conv3x3_fwd"] += 1
    return y


def conv3x3_dx_cuda(dy, w, dtype):
    """The dx kernel on the card: dx [B, Ci, H, W] bf16 (`dtype` must be
    bf16, x's dtype). dy in another memory format is copied to NCHW."""
    if dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 dx kernel writes bfloat16, asked {dtype}")
    dy = dy.to(dtype).contiguous()
    w = w.to(dtype).contiguous()
    co, ci = w.shape[:2]
    if dy.dim() != 4 or dy.shape[1] != co:
        raise ValueError(f"conv3x3: dy {tuple(dy.shape)} is not "
                         f"[B, {co}, H, W]")
    b, h, wd = _check(dy, w, ci, co)
    lib = kernel_library()
    dx = torch.empty((b, ci, h, wd), dtype=torch.bfloat16, device=dy.device)
    with torch.cuda.device(dy.device):
        err = lib.conv3x3_dx_bf16(dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                  b, ci, co, h, wd, stream_of(dy))
    raise_on(err, "conv3x3_dx")
    LAUNCHES["conv3x3_dx"] += 1
    return dx


def conv3x3_fwd(x, w):
    """The kernel for CUDA tensors; the plain version for CPU ones."""
    if x.device.type == "cpu":
        return conv3x3_fwd_ref(x, w)
    return conv3x3_fwd_cuda(x, w)


def conv3x3_dx(dy, w, dtype):
    """The dx kernel for CUDA tensors; the plain version for CPU ones."""
    if dy.device.type == "cpu":
        return conv3x3_dx_ref(dy, w, dtype)
    return conv3x3_dx_cuda(dy, w, dtype)


class Conv3x3Function(torch.autograd.Function):
    """Differentiable conv3x3 (the JAX package's custom VJP, conv.py:125-
    161): forward and dx are the kernel's, dw a plain recomputation made
    only when asked for."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()  # saved as the kernel takes it
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = conv3x3_dx(dy, w, x.dtype) if need[0] else None
        dw = conv3x3_dw(x, dy, w.dtype) if need[1] else None
        return dx, dw


def conv3x3(x, w):
    """3x3 SAME stride-1 conv over NCHW x, no bias. Callers gate with
    conv3x3_ok."""
    return Conv3x3Function.apply(x, w)
