"""The reference computed at a stated precision: every matmul and
convolution input (and weight) of a module rounded to a lower type, with
float32 accumulation, as tensor cores compute. The gradient passes the
rounding straight through."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

FP8_MAX = 448.0


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


@contextlib.contextmanager
def rounded_inputs(module: nn.Module, rounding):
    """Within the block, every nn.Linear and nn.Conv2d of `module` takes
    its input through `rounding`."""
    handles = [m.register_forward_pre_hook(
        lambda _m, args: (rounding(args[0]),) + tuple(args[1:]))
        for m in module.modules() if isinstance(m, (nn.Linear, nn.Conv2d))]
    try:
        yield module
    finally:
        for h in handles:
            h.remove()


def round_weights_(module: nn.Module, rounding) -> nn.Module:
    """Round every nn.Linear and nn.Conv2d weight of `module` in place."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.weight.copy_(rounding(m.weight))
    return module
