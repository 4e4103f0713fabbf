"""The foreground guidance loss's weighted L1 term, with a hand-written
kernel pair (`csrc/fg_loss.cu`) for it and its gradient.

    S[c] = sum over live slots s of w_s * |f1[c, s] - f2[c, k_s]|

f2 is the current feature map [C, H, W] (fp32, the one input that takes a
gradient); f1 the orig features at the slots, channel-major [C, N] in the
slot order of `guidance.fg_slot_order`, which sorts the live slots by
transformed cell once per edit and gives each slot's cell k_s and weight
w_s and each cell's run of slots. The backward writes each element of
grad_f2 once, summing its cell's run in that order, so it is the same bits
run to run, and neither kernel synchronises with the host or allocates by
the data, so both can be captured in a CUDA graph.

This module holds the card's route only: `guidance.foreground_loss_apply`
takes it on a CUDA device (`utils.cuda_build.route`) and computes the same
term with plain PyTorch indexing on the CPU. The launches are counted in
LAUNCHES and each runs inside a `kernel.<LAUNCHES key>` span.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from diffusionhandles_tpu_torch.utils.cuda_build import (check_cuda,
                                                         load_library,
                                                         raise_on, stream_of)
from diffusionhandles_tpu_torch.utils.profiling import span

# Launches of each kernel since the last reset_launch_counts().
LAUNCHES: Dict[str, int] = {"fg_l1_fwd": 0, "fg_l1_bwd": 0}
# the span of each launch, by its LAUNCHES key
_SPANS = {n: "kernel." + n for n in LAUNCHES}

KERNEL_SOURCES = ("fg_loss.cu",)

_LIB = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_library() -> ctypes.CDLL:
    """Build (first call) and load the kernel pair."""
    global _LIB
    if _LIB is None:
        lib = load_library("fg_loss", KERNEL_SOURCES)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fg_l1_fwd.argtypes = [ptr] * 5 + [i32] * 3 + [ptr] * 2
        lib.fg_l1_bwd.argtypes = [ptr] * 5 + [i32] * 3 + [ptr] * 2
        lib.fg_l1_fwd.restype = lib.fg_l1_bwd.restype = i32
        _LIB = lib
    return _LIB


def _check(f1, f2, cells, weights, offsets) -> None:
    check_cuda("fg_l1", f1, f2, weights, dtypes=(torch.float32,))
    check_cuda("fg_l1", cells, offsets, dtypes=(torch.int32,))
    if cells.device != f2.device:
        raise ValueError("fg_l1: all tensors must be on one device")
    c, n = f1.shape
    hw = f2[0].numel()
    if (f2.shape[0] != c or cells.shape != (n,) or weights.shape != (n,)
            or offsets.shape != (hw + 1,)):
        raise ValueError(
            f"fg_l1: f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}, cells "
            f"{tuple(cells.shape)}, weights {tuple(weights.shape)}, offsets "
            f"{tuple(offsets.shape)} do not agree")
    if not all(t.is_contiguous() for t in (f1, f2, cells, weights, offsets)):
        raise ValueError("fg_l1 takes contiguous tensors")


def fg_l1_fwd_cuda(f1, f2, cells, weights, offsets) -> torch.Tensor:
    """S [C] fp32 (module docstring), one launch."""
    _check(f1, f2, cells, weights, offsets)
    c, n = f1.shape
    with span(_SPANS["fg_l1_fwd"]):
        out = torch.empty(c, dtype=torch.float32, device=f2.device)
        err = kernel_library().fg_l1_fwd(
            f1.data_ptr(), f2.data_ptr(), cells.data_ptr(),
            weights.data_ptr(), offsets.data_ptr(), c, f2[0].numel(), n,
            out.data_ptr(), stream_of(f2))
        raise_on(err, "fg_l1_fwd")
        LAUNCHES["fg_l1_fwd"] += 1
    return out


def fg_l1_bwd_cuda(f1, f2, weights, offsets, g) -> torch.Tensor:
    """grad_f2 [C, H, W] fp32 for the gradient g [C] of S, one launch."""
    g = g.float().contiguous()
    c, n = f1.shape
    if g.shape != (c,) or g.device != f2.device:
        raise ValueError(f"fg_l1_bwd: g {tuple(g.shape)} on {g.device}, "
                         f"expected ({c},) on {f2.device}")
    with span(_SPANS["fg_l1_bwd"]):
        grad = torch.empty_like(f2)
        err = kernel_library().fg_l1_bwd(
            f1.data_ptr(), f2.data_ptr(), weights.data_ptr(),
            offsets.data_ptr(), g.data_ptr(), c, f2[0].numel(), n,
            grad.data_ptr(), stream_of(f2))
        raise_on(err, "fg_l1_bwd")
        LAUNCHES["fg_l1_bwd"] += 1
    return grad


class FgL1Function(torch.autograd.Function):
    """S of f2 (module docstring) with the kernel pair; only f2 takes a
    gradient."""

    @staticmethod
    def forward(ctx, f2, f1, cells, weights, offsets):
        ctx.save_for_backward(f2, f1, weights, offsets)
        return fg_l1_fwd_cuda(f1, f2, cells, weights, offsets)

    @staticmethod
    def backward(ctx, g):
        f2, f1, weights, offsets = ctx.saved_tensors
        return fg_l1_bwd_cuda(f1, f2, weights, offsets, g), None, None, \
            None, None


def fg_l1(f2, f1, cells, weights, offsets) -> torch.Tensor:
    """S [C] of f2 [C, H, W] against f1 [C, N] in slot order, on the card
    (module docstring): cells [N] and offsets [H*W + 1] int32, weights [N]
    fp32. A strided f2 (a channels-last activation's) is copied dense."""
    return FgL1Function.apply(f2.contiguous(), f1, cells, weights, offsets)
