"""Mesh-mode depth transform (reference: depth_transform.py:91-195).

The counterpart of the JAX package's `geometry/mesh_transform.py`: a
full-grid background depth mesh and a masked foreground depth mesh, the
foreground's vertices rigidly transformed, both rasterized together (the
mesh connectivity stretches triangles across disocclusions, so this path
needs no Poisson inpaint), and the correspondences read out of the
interpolated per-vertex color (u, v source coordinates + fg flag).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.geometry.depth import normalize_depth
from diffusionhandles_tpu_torch.geometry.mesh import Mesh, depth_to_mesh
from diffusionhandles_tpu_torch.geometry.transform import (_edit_inputs,
                                                           _empty_result,
                                                           transform_points)
from diffusionhandles_tpu_torch.ops.rasterize import (interpolate_attribute,
                                                      project_verts,
                                                      rasterize)
from diffusionhandles_tpu_torch.utils.correspondences import \
    pack_correspondences
from diffusionhandles_tpu_torch.utils.device import resolve_device


def merge_meshes(*meshes: Mesh) -> Mesh:
    """One mesh of all vertices and faces (face indices offset), with the
    vertex attributes every mesh has."""
    verts = torch.cat([m.verts for m in meshes], 0).float()
    offsets = np.cumsum([0] + [len(m.verts) for m in meshes[:-1]])
    faces = torch.cat([m.faces + int(off) for m, off in zip(meshes, offsets)],
                      0)
    merged = Mesh(verts=verts, faces=faces)
    keys = (set.intersection(*[set(m.vert_attributes) for m in meshes])
            if meshes else set())
    for k in sorted(keys):
        merged.add_vert_attribute(k, torch.cat(
            [m.vert_attributes[k] for m in meshes], 0))
    return merged


def render_depth_meshes(mesh: Mesh, intrinsics, height: int, width: int,
                        cull_backfaces: bool = True):
    """Rasterize a merged depth mesh with the full intrinsics; returns
    (zbuf [H, W], color [H, W, 3], covered mask [H, W])."""
    verts_px = project_verts(mesh.verts, intrinsics, height, width)
    raster = rasterize(verts_px, mesh.faces, height, width,
                       cull_backfaces=cull_backfaces)
    color = interpolate_attribute(raster, mesh.faces,
                                  mesh.vert_attributes["color"])
    return raster.zbuf, color, raster.face_id >= 0


def transform_depth_mesh(depth, bg_depth, fg_mask, intrinsics,
                         rot_angle: Optional[float] = None, rot_axis=None,
                         translation=None,
                         use_input_depth_normalization=False, device=None):
    """Mesh-mode transform on `device` (default: the GPU).

    depth, bg_depth, fg_mask: [1, 1, H, W]. Returns (edited disparity
    [1, 1, H, W] fp32 tensor, correspondences [N, 4] int64 numpy): one row
    per rendered foreground pixel, in raster order, from the source pixel
    its interpolated (u, v) rounds to."""
    device = resolve_device(device)
    depth, bg_depth, fg, rot_angle, rot_axis, translation = _edit_inputs(
        depth, bg_depth, fg_mask, rot_angle, rot_axis, translation, device)
    if not bool((fg > 0.5).any()):
        return _empty_result(depth, use_input_depth_normalization)
    h, w = fg.shape

    bg_mesh = depth_to_mesh(bg_depth, intrinsics, device=device)
    fg_mesh = depth_to_mesh(depth, intrinsics, mask=fg > 0.5, device=device)
    fg_mesh.verts = transform_points(fg_mesh.verts, rot_angle, rot_axis,
                                     translation)
    merged = merge_meshes(bg_mesh, fg_mesh)
    zbuf, color, _ = render_depth_meshes(merged, intrinsics, h, w)

    yy, xx = torch.nonzero(color[..., 2] > 0.5, as_tuple=True)
    src_x = torch.round(color[yy, xx, 0] * (w - 1)).long()
    src_y = torch.round(color[yy, xx, 1] * (h - 1)).long()
    corr = pack_correspondences(*(a.cpu().numpy()
                                  for a in (src_x, src_y, xx, yy)))

    bounds = (normalize_depth(1.0 / depth, return_bounds=True)[1]
              if use_input_depth_normalization else None)
    # empty pixels (no mesh coverage): depth inf -> disparity 0
    return normalize_depth(1.0 / zbuf[None, None], bounds=bounds), corr
