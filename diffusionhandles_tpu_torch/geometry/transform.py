"""3D rigid transform of the foreground depth surface, point-cloud mode.

The counterpart of the pc path of the JAX package's
`geometry/transform.py` (reference: diffhandles/depth_transform.py:
198-363): lift -> Rodrigues rotation about the foreground centroid +
translation -> z-buffer splat -> disparity normalisation -> morphological
mask cleanup -> Poisson inpaint, followed by on-device correspondence
binning. Mesh mode is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.geometry.depth import (depth_to_world_coords,
                                                       normalize_depth,
                                                       points_to_depth)
from diffusionhandles_tpu_torch.ops.morphology import (close, ellipse_kernel,
                                                       open_)
from diffusionhandles_tpu_torch.ops.poisson import poisson_solve
from diffusionhandles_tpu_torch.utils.device import resolve_device


def rodrigues_rotate(points, rot_axis, rot_angle_deg: float):
    """Rotate [N, 3] points about the origin (reference:
    depth_transform.py:446-454)."""
    axis = torch.as_tensor(rot_axis, dtype=torch.float32,
                           device=points.device)
    axis = axis / torch.linalg.norm(axis)
    angle = torch.tensor(np.float32(rot_angle_deg), dtype=torch.float32) * (
        math.pi / 180.0)
    c, s = torch.cos(angle).to(points.device), torch.sin(angle).to(
        points.device)
    term1 = points * c
    term2 = torch.linalg.cross(axis.expand_as(points), points) * s
    term3 = axis * (points * axis).sum(-1, keepdim=True) * (1 - c)
    return term1 + term2 + term3


def transform_point_cloud(points, rot_axis, rot_angle_deg, translation,
                          mask):
    """Rotate ALL [H, W, 3] points about the centroid of the MASKED points
    (reference: depth_transform.py:461-533). Returns the transformed points
    and the mask flattened to bool [H*W]."""
    h, w = points.shape[:2]
    m = mask.reshape(h, w).float()
    flat = points.reshape(-1, 3)
    mf = m.reshape(-1, 1)
    centroid = (flat * mf).sum(0) / torch.clamp(mf.sum(), min=1e-12)
    out = rodrigues_rotate(flat - centroid, rot_axis, rot_angle_deg)
    out = out + centroid + torch.as_tensor(translation, dtype=torch.float32,
                                           device=points.device)
    return out.reshape(h, w, 3), m.reshape(-1) > 0.5


def _transform_depth_pc_device(depth, bg_depth, fg, intrinsics, rot_axis,
                               rot_angle, translation, img_res: int,
                               use_input_depth_normalization: bool):
    """Lift -> rigid transform -> splat -> normalize -> morphology ->
    Poisson inpaint. Returns (inpainted disparity [H, W], u, v, visible,
    cleaned mask)."""
    bg_pts = depth_to_world_coords(bg_depth, intrinsics)
    pts = depth_to_world_coords(depth, intrinsics)
    pts_t, fg_flat = transform_point_cloud(pts, rot_axis, rot_angle,
                                           translation, fg > 0.5)
    # all background points (raster order) then the transformed foreground
    # slots: index order keeps the reference's first-wins tie behaviour
    n = img_res * img_res
    points = torch.cat([bg_pts.reshape(-1, 3), pts_t.reshape(-1, 3)], 0)
    zeros = torch.zeros(n, dtype=torch.bool, device=depth.device)
    point_mask = torch.cat([zeros, fg_flat], 0)
    valid = torch.cat([~zeros, fg_flat], 0)
    splat = points_to_depth(points, intrinsics, (img_res, img_res),
                            point_mask=point_mask, valid=valid)

    bounds = (normalize_depth(1.0 / depth, return_bounds=True)[1]
              if use_input_depth_normalization else None)
    rendered_disparity = normalize_depth(
        1.0 / splat.depth_map[None, None], bounds=bounds)[0, 0]

    close_k = ellipse_kernel(max(1, img_res // 50))
    open_k = ellipse_kernel(max(1, img_res // 250))
    target_mask = splat.depth_mask
    cleaned = open_(close(target_mask, close_k), open_k)
    inpaint_mask = target_mask ^ cleaned
    inpainted = poisson_solve(rendered_disparity, inpaint_mask)
    return inpainted, splat.u, splat.v, splat.visible, cleaned


def transform_depth_pc_processed(depth, bg_depth, fg_mask, intrinsics,
                                 rot_angle: Optional[float] = None,
                                 rot_axis=None, translation=None,
                                 use_input_depth_normalization=False,
                                 bg_erosion: int = 0, max_corr: int = 16384,
                                 latent_res: int = 64, device=None):
    """Point-cloud depth transform with the correspondence binning on
    `device` (default: the GPU).

    depth, bg_depth, fg_mask: [1, 1, H, W] (numpy or tensors). Returns
    (edited disparity [1, 1, H, W] fp32 tensor, ProcessedCorrespondences)."""
    from diffusionhandles_tpu_torch.guidance import \
        process_correspondences_device

    device = resolve_device(device)
    hw = (np.shape(depth)[-2], np.shape(depth)[-1])
    depth, bg_depth, fg = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in (depth, bg_depth, fg_mask))
    depth = depth.reshape(1, 1, *hw)
    bg_depth = bg_depth.reshape(1, 1, *hw)
    fg = fg.reshape(hw)
    if hw[0] != hw[1]:
        raise RuntimeError(f"Expected fg_mask to be square, got {hw[0]} x "
                           f"{hw[1]}.")
    img_res = hw[-1]
    n = img_res * img_res
    if not bool((fg > 0.5).any()):
        # no foreground: the disparity is the input's, and no point binds
        none = torch.zeros(n, dtype=torch.long, device=device)
        pc = process_correspondences_device(
            none, none, none.bool(), torch.zeros(hw, dtype=torch.bool,
                                                 device=device),
            fg, img_res=img_res, bg_erosion=bg_erosion, max_corr=max_corr,
            latent_res=latent_res)
        return normalize_depth(1.0 / depth), pc

    rot_axis = (np.array([0.0, 1.0, 0.0], np.float32) if rot_axis is None
                else np.asarray(rot_axis, np.float32))
    translation = (np.zeros(3, np.float32) if translation is None
                   else np.asarray(translation, np.float32))
    rot_angle = 0.0 if rot_angle is None else float(rot_angle)
    intr = torch.as_tensor(np.asarray(intrinsics, np.float32), device=device)
    inpainted, u, v, visible, cleaned = _transform_depth_pc_device(
        depth, bg_depth, fg, intr, rot_axis, rot_angle, translation,
        img_res, use_input_depth_normalization)
    pc = process_correspondences_device(
        u[n:], v[n:], visible[n:], cleaned, fg, img_res=img_res,
        bg_erosion=bg_erosion, max_corr=max_corr, latent_res=latent_res)
    return inpainted[None, None].float(), pc
