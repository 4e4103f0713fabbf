"""Masked 5-point-stencil Poisson/Laplace solves by conjugate gradients.

The counterpart of the JAX package's `ops/poisson.py` (reference: scipy
sparse solves in diffhandles/depth_transform.py:535-587 and utils.py:49-102):
for each masked pixel p, 4 u_p - sum of masked neighbours = sum of known
in-bounds neighbours + g_p. The CG loop is a Python loop with the JAX
while_loop's exact stopping rule (iteration cap, relative residual).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.utils.profiling import span


def _neighbor_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of the 4 neighbours of an [H, W] array, zero outside."""
    p = F.pad(x[None, None], (1, 1, 1, 1))[0, 0]
    return p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2]


def laplacian_zero_pad(x: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.convolve(x, [[0,1,0],[1,-4,1],[0,1,0]], 'constant')."""
    return _neighbor_sum(x) - 4.0 * x


def masked_poisson_cg(image, mask, rhs_extra: Optional[torch.Tensor] = None,
                      maxiter: int = 2000, tol: float = 1e-6
                      ) -> torch.Tensor:
    """Solve the masked system for the pixels where `mask` is set; returns
    `image` with those pixels replaced by the solution."""
    image = image.float()
    m = mask.float()
    known = image * (1.0 - m)

    def matvec(x):
        return m * (4.0 * x - _neighbor_sum(m * x))

    b = m * _neighbor_sum(known)
    if rhs_extra is not None:
        b = b + m * rhs_extra.float()
    x = torch.zeros_like(image)
    r = b - matvec(x)
    p = r
    rs = torch.dot(r.flatten(), r.flatten())
    thresh = tol * rs
    for _ in range(maxiter):
        with span("sync.poisson_residual"):
            done = not bool(rs > thresh)
        if done:
            break
        ap = matvec(p)
        alpha = rs / (torch.dot(p.flatten(), ap.flatten()) + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r.flatten(), r.flatten())
        beta = rs_new / (rs + 1e-30)
        p = r + beta * p
        rs = rs_new
    return known + m * x


def poisson_solve(image, mask, maxiter: int = 2000) -> torch.Tensor:
    """Laplace-inpaint the `mask` pixels of `image`."""
    return masked_poisson_cg(image, mask, None, maxiter=maxiter)


def solve_laplacian_depth(fg_depth, bg_depth, mask,
                          maxiter: int = 2000) -> torch.Tensor:
    """Infill the `mask` hole of `fg_depth` so its Laplacian matches the
    background depth's (reference: diffhandles/utils.py:49-102, whose
    b -= lap_bg makes the right-hand side g = -lap(bg))."""
    g = -laplacian_zero_pad(bg_depth.float())
    return masked_poisson_cg(fg_depth, mask, g, maxiter=maxiter)


def harmonize_depth(fg_depth, bg_depth, fg_mask, dilate_iters: int = 15,
                    maxiter: int = 2000) -> torch.Tensor:
    """set_foreground's solve: dilate the fg mask `dilate_iters` times
    (scipy cross) and infill that hole of `fg_depth` so its Laplacian
    matches the background depth's (reference: diffusion_handles.py:90-111).
    """
    from diffusionhandles_tpu_torch.ops.morphology import \
        binary_dilation_iter
    return solve_laplacian_depth(
        fg_depth, bg_depth, binary_dilation_iter(fg_mask, dilate_iters),
        maxiter=maxiter)
