"""3D rigid transform of the foreground depth surface.

The counterpart of the JAX package's `geometry/transform.py` (reference:
diffhandles/depth_transform.py:73-363). Point-cloud mode: lift ->
Rodrigues rotation about the foreground centroid + translation -> z-buffer
splat -> disparity normalisation -> morphological mask cleanup -> Poisson
inpaint, followed either by on-device correspondence binning
(`transform_depth_pc_processed`, the facade's path) or by packing the
[N, 4] image-pixel correspondences on the host (`transform_depth_pc`).
`transform_depth` dispatches on the mode; mesh mode lives in
`geometry/mesh_transform.py`.
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
from diffusionhandles_tpu_torch.utils.correspondences import \
    pack_correspondences
from diffusionhandles_tpu_torch.utils.device import resolve_device
from diffusionhandles_tpu_torch.utils.profiling import span


def rodrigues_rotate(points, rot_axis, rot_angle_deg: float):
    """Rotate [N, 3] points about the origin (reference:
    depth_transform.py:446-454)."""
    with span("sync.rotation_axis"):
        axis = torch.as_tensor(rot_axis, dtype=torch.float32,
                               device=points.device)
    axis = axis / torch.linalg.norm(axis)
    angle = torch.tensor(np.float32(rot_angle_deg), dtype=torch.float32) * (
        math.pi / 180.0)
    with span("sync.rotation_angle"):
        c = torch.cos(angle).to(points.device)
    with span("sync.rotation_angle"):
        s = torch.sin(angle).to(points.device)
    term1 = points * c
    term2 = torch.linalg.cross(axis.expand_as(points), points) * s
    term3 = axis * (points * axis).sum(-1, keepdim=True) * (1 - c)
    return term1 + term2 + term3


def transform_points(points, rot_angle=None, rot_axis=None,
                     translation=None):
    """Rigid transform of [N, 3] points about their centroid (reference:
    depth_transform.py:439-459)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    rot_axis = [0.0, 1.0, 0.0] if rot_axis is None else rot_axis
    rot_angle = 0.0 if rot_angle is None else rot_angle
    translation = (torch.zeros(3) if translation is None
                   else torch.as_tensor(translation, dtype=torch.float32))
    centroid = points.mean(0, keepdim=True)
    out = rodrigues_rotate(points - centroid, rot_axis, rot_angle)
    return out + centroid + translation.to(points.device)[None]


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
    with span("sync.translation"):
        t = torch.as_tensor(translation, dtype=torch.float32,
                            device=points.device)
    out = out + centroid + t
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


def _edit_inputs(depth, bg_depth, fg_mask, rot_angle, rot_axis,
                 translation, device):
    """The inputs as fp32 tensors on `device` (depth and bg_depth
    [1, 1, H, W], fg [H, W]) and the transform with its defaults."""
    hw = (np.shape(depth)[-2], np.shape(depth)[-1])
    moved = []
    for a in (depth, bg_depth, fg_mask):
        with span("sync.edit_inputs"):
            moved.append(torch.as_tensor(a, dtype=torch.float32,
                                         device=device))
    depth, bg_depth, fg = moved
    rot_axis = (np.array([0.0, 1.0, 0.0], np.float32) if rot_axis is None
                else np.asarray(rot_axis, np.float32))
    translation = (np.zeros(3, np.float32) if translation is None
                   else np.asarray(translation, np.float32))
    rot_angle = 0.0 if rot_angle is None else float(rot_angle)
    return (depth.reshape(1, 1, *hw), bg_depth.reshape(1, 1, *hw),
            fg.reshape(hw), rot_angle, rot_axis, translation)


def _check_square(hw) -> int:
    if hw[0] != hw[1]:
        raise RuntimeError(f"Expected fg_mask to be square, got {hw[0]} x "
                           f"{hw[1]}.")
    return hw[-1]


def _empty_result(depth, use_input_depth_normalization):
    """No foreground (reference: depth_transform.py:203-216): the edited
    disparity is the input's, whose own bounds are the input's, so both
    values of the flag give it; no correspondence."""
    del use_input_depth_normalization
    return normalize_depth(1.0 / depth), np.zeros((0, 4), np.int64)


def transform_depth(depth, bg_depth, fg_mask, intrinsics,
                    rot_angle: Optional[float] = None, rot_axis=None,
                    translation=None, use_input_depth_normalization=False,
                    depth_transform_mode: str = "pc", device=None):
    """Transform the foreground in `depth_transform_mode` ('pc' or 'mesh')
    on `device` (default: the GPU) (reference: depth_transform.py:73-89).

    Returns (edited disparity [1, 1, H, W] fp32 tensor, correspondences
    [N, 4] int64 numpy of (orig_x, orig_y, trans_x, trans_y))."""
    if depth_transform_mode == "pc":
        return transform_depth_pc(
            depth, bg_depth, fg_mask, intrinsics, rot_angle, rot_axis,
            translation, use_input_depth_normalization, device=device)
    if depth_transform_mode == "mesh":
        from diffusionhandles_tpu_torch.geometry.mesh_transform import \
            transform_depth_mesh
        return transform_depth_mesh(
            depth, bg_depth, fg_mask, intrinsics, rot_angle, rot_axis,
            translation, use_input_depth_normalization, device=device)
    raise ValueError(f"Unknown depth transform mode '{depth_transform_mode}'.")


def transform_depth_pc(depth, bg_depth, fg_mask, intrinsics,
                       rot_angle: Optional[float] = None, rot_axis=None,
                       translation=None, use_input_depth_normalization=False,
                       device=None):
    """Point-cloud depth transform on `device` (default: the GPU)
    (reference: depth_transform.py:198-363).

    depth, bg_depth, fg_mask: [1, 1, H, W]. Returns (edited disparity
    [1, 1, H, W] fp32 tensor, correspondences [N, 4] int64 numpy): one row
    per foreground pixel, in raster order, whose point is visible and lands
    inside the cleaned target mask."""
    device = resolve_device(device)
    depth, bg_depth, fg, rot_angle, rot_axis, translation = _edit_inputs(
        depth, bg_depth, fg_mask, rot_angle, rot_axis, translation, device)
    with span("sync.foreground_any"):
        no_fg = not bool((fg > 0.5).any())
    if no_fg:
        return _empty_result(depth, use_input_depth_normalization)
    img_res = _check_square(fg.shape)
    with span("sync.intrinsics"):
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                               device=device)
    inpainted, u, v, visible, cleaned = _transform_depth_pc_device(
        depth, bg_depth, fg, intr, rot_axis, rot_angle, translation,
        img_res, use_input_depth_normalization)
    n = img_res * img_res
    fg_idx = torch.nonzero(fg.reshape(-1) > 0.5)[:, 0]
    u, v, visible = u[n:][fg_idx], v[n:][fg_idx], visible[n:][fg_idx]
    keep = visible & cleaned[v, u]
    src = fg_idx[keep]
    corr = pack_correspondences(*(a.cpu().numpy() for a in (
        src % img_res, src // img_res, u[keep], v[keep])))
    return inpainted[None, None].float(), corr


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
    depth, bg_depth, fg, rot_angle, rot_axis, translation = _edit_inputs(
        depth, bg_depth, fg_mask, rot_angle, rot_axis, translation, device)
    img_res = _check_square(fg.shape)
    n = img_res * img_res
    with span("sync.foreground_any"):
        no_fg = not bool((fg > 0.5).any())
    if no_fg:
        # no foreground: the disparity is the input's, and no point binds
        none = torch.zeros(n, dtype=torch.long, device=device)
        pc = process_correspondences_device(
            none, none, none.bool(), torch.zeros_like(fg, dtype=torch.bool),
            fg, img_res=img_res, bg_erosion=bg_erosion, max_corr=max_corr,
            latent_res=latent_res)
        return normalize_depth(1.0 / depth), pc

    with span("sync.intrinsics"):
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                               device=device)
    inpainted, u, v, visible, cleaned = _transform_depth_pc_device(
        depth, bg_depth, fg, intr, rot_axis, rot_angle, translation,
        img_res, use_input_depth_normalization)
    pc = process_correspondences_device(
        u[n:], v[n:], visible[n:], cleaned, fg, img_res=img_res,
        bg_erosion=bg_erosion, max_corr=max_corr, latent_res=latent_res)
    return inpainted[None, None].float(), pc
