"""Binary morphology as counting convolutions.

The counterpart of the JAX package's `ops/morphology.py`, with its border
semantics: cv2 dilate pads with 0 and cv2 erode with 1 (cv2's default
border), scipy's erosion with the default cross pads with 0. Anchors are
cv2's (k // 2, k // 2), also for even kernels.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.utils.profiling import span


@functools.lru_cache(maxsize=64)
def ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize)) by
    OpenCV's own fill rule (no OpenCV needed): row i spans columns
    c - dx .. c + dx with r = c = ksize // 2 and
    dx = round(c * sqrt((r^2 - (i - r)^2) / r^2)), clipped to the kernel.
    (The JAX package's no-OpenCV fallback centres at (ksize - 1) / 2 and
    differs for even sizes, e.g. ksize 2.)"""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    se = np.zeros((ksize, ksize), np.float32)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            se[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1.0
    return se


def cross_kernel() -> np.ndarray:
    """scipy's default 3x3 connectivity-1 structure."""
    return np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.float32)


def _count_conv(mask: torch.Tensor, se: np.ndarray, pad_value: float):
    """Correlate a binary [H, W] mask with `se`, anchored at (k//2, k//2)."""
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    padded = F.pad(mask.float()[None, None],
                   (ax, kw - 1 - ax, ay, kh - 1 - ay), value=pad_value)
    with span("sync.structuring_element"):
        weight = torch.from_numpy(se).to(mask.device)[None, None]
    return F.conv2d(padded, weight)[0, 0]


def dilate(mask, se: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """Binary dilation (cv2: a plain correlation, outside = 0)."""
    se = np.asarray(se, np.float32)
    m = mask
    for _ in range(iterations):
        m = _count_conv(m, se, 0.0) > 0.5
    return m


def erode(mask, se: np.ndarray, iterations: int = 1,
          border_value: float = 1.0) -> torch.Tensor:
    """Binary erosion; border_value 1 is cv2's, 0 scipy's."""
    se = np.asarray(se, np.float32)
    total = float(se.sum())
    m = mask
    for _ in range(iterations):
        m = _count_conv(m, se, border_value) > total - 0.5
    return m


def close(mask, se: np.ndarray) -> torch.Tensor:
    """cv2 MORPH_CLOSE: dilate then erode."""
    return erode(dilate(mask, se), se)


def open_(mask, se: np.ndarray) -> torch.Tensor:
    """cv2 MORPH_OPEN: erode then dilate."""
    return dilate(erode(mask, se), se)


def binary_dilation_iter(mask, iterations: int) -> torch.Tensor:
    """scipy.ndimage.binary_dilation(mask, iterations=n), cross structure."""
    if iterations <= 0:
        return mask > 0.5
    return dilate(mask, cross_kernel(), iterations=iterations)


def binary_erosion_iter(mask, iterations: int) -> torch.Tensor:
    """scipy.ndimage.binary_erosion(mask, iterations=n), cross structure,
    border_value=0 (reference: guided_stable_diffuser.py:538-539)."""
    if iterations <= 0:
        return mask > 0.5
    return erode(mask, cross_kernel(), iterations=iterations,
                 border_value=0.0)
