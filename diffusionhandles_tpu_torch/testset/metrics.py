"""Image quality metrics for reconstruction and edit evaluation.

The counterpart of the JAX package's `testset/metrics.py` (the reference
computes no numeric metrics; its galleries are reviewed by eye): PSNR, and
mean SSIM with an 11x11 Gaussian window per channel, in float64 on the
host (scipy.ndimage).
"""

from __future__ import annotations

import numpy as np


def psnr(a, b, data_range: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def _gaussian(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(a, b, data_range: float = 1.0, k1: float = 0.01,
         k2: float = 0.03) -> float:
    """Mean SSIM (Wang et al. 2004; 11x11 Gaussian window, per channel).
    [H, W], [C, H, W] or [H, W, C] with C 1 or 3. The window is applied as
    its two 1-D factors (the JAX package convolves with their outer
    product: the same sums, ~1e-16 apart, at a fraction of the cost)."""
    from scipy.ndimage import correlate1d

    g = _gaussian()
    r = len(g) // 2

    def window(x):  # the 'valid' part of the separable Gaussian filter
        x = correlate1d(x, g, axis=1, mode="constant")[:, r:-r]
        return correlate1d(x, g, axis=0, mode="constant")[r:-r]

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[None], b[None]
    if a.shape[-1] in (1, 3) and a.ndim == 3:  # HWC -> CHW
        a, b = np.moveaxis(a, -1, 0), np.moveaxis(b, -1, 0)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    vals = []
    for ca, cb in zip(a, b):
        mu_a = window(ca)
        mu_b = window(cb)
        va = window(ca * ca) - mu_a ** 2
        vb = window(cb * cb) - mu_b ** 2
        cov = window(ca * cb) - mu_a * mu_b
        s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
            (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
