"""Where the port's entry points run: the GPU unless the caller asks for
another device."""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; with None, the CUDA device.

    Raises RuntimeError when no device is given and CUDA is not available:
    an entry point never falls back to the CPU on its own. Pass
    device="cpu" to run there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")


def host_array(x) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextlib.contextmanager
def deterministic_cudnn():
    """Restrict cuDNN to its deterministic algorithms inside the block (a
    transposed convolution's default backward-data algorithm sums with
    atomics, so two calls on the same input may differ in the last bits);
    the other cuDNN settings stay as they are."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev
