"""Image resizing with exact `F.interpolate(antialias=False)` semantics
(align_corners=False, and True for the method 'bilinear_ac'), as separable
resampling matrices.

The counterpart of the JAX package's `ops/resize.py`: the same dense
[out, in] matrices (built on the host in float64, stored float32) applied
as two fp32 matmuls, so both packages resample with identical weights.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel, a=-0.75 as used by PyTorch."""
    x = np.abs(x)
    w = np.zeros_like(x)
    m1 = x <= 1.0
    m2 = (x > 1.0) & (x < 2.0)
    w[m1] = ((a + 2.0) * x[m1] - (a + 3.0)) * x[m1] * x[m1] + 1.0
    w[m2] = (((x[m2] - 5.0) * x[m2] + 8.0) * x[m2] - 4.0) * a
    return w


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Dense [out_size, in_size] resampling matrix, torch semantics
    (half-pixel centers, or corner-aligned for 'bilinear_ac'; out-of-range
    taps clamp to the border)."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    if method == "bilinear_ac":
        # align_corners=True: src = i * (in - 1) / (out - 1) (the
        # MiDaS/ZoeDepth convention)
        src = dst * ((in_size - 1) / max(out_size - 1, 1))
    else:
        src = (dst + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    if method in ("bilinear", "bilinear_ac"):
        offsets = np.array([0, 1])
        weights = np.stack([1.0 - t, t], axis=-1)
    elif method == "bicubic":
        offsets = np.array([-1, 0, 1, 2])
        weights = np.stack(
            [_cubic_weight(t + 1.0), _cubic_weight(t),
             _cubic_weight(1.0 - t), _cubic_weight(2.0 - t)], axis=-1)
    else:
        raise ValueError(f"Unknown resize method '{method}'")
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for k, off in enumerate(offsets):
        idx = np.clip(i0 + off, 0, in_size - 1)
        np.add.at(mat, (np.arange(out_size), idx), weights[:, k])
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def _matrix_on(in_size: int, out_size: int, method: str,
               device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(in_size, out_size, method)).to(
        device)


def resize_hw(x: torch.Tensor, size, method: str = "bilinear",
              h_axis: int = -2, w_axis: int = -1) -> torch.Tensor:
    """Resize the (h_axis, w_axis) dims of `x` to `size = (H_out, W_out)`,
    in fp32, returned in x's dtype."""
    h_out, w_out = size
    h_axis %= x.ndim
    w_axis %= x.ndim
    h_in, w_in = x.shape[h_axis], x.shape[w_axis]
    if (h_in, w_in) == (h_out, w_out):
        return x
    xf = x.float()
    if h_in != h_out:
        mh = _matrix_on(h_in, h_out, method, x.device)
        xf = torch.movedim(torch.tensordot(mh, xf, dims=([1], [h_axis])), 0,
                           h_axis)
    if w_in != w_out:
        mw = _matrix_on(w_in, w_out, method, x.device)
        xf = torch.movedim(torch.tensordot(xf, mw, dims=([w_axis], [1])), -1,
                           w_axis)
    return xf.to(x.dtype)


def resize_nhwc(x: torch.Tensor, size, method: str = "bilinear"
                ) -> torch.Tensor:
    """Resize [N, H, W, C] images."""
    return resize_hw(x, size, method=method, h_axis=1, w_axis=2)


def resize_nchw(x: torch.Tensor, size, method: str = "bilinear"
                ) -> torch.Tensor:
    """Resize [N, C, H, W] images."""
    return resize_hw(x, size, method=method, h_axis=2, w_axis=3)
