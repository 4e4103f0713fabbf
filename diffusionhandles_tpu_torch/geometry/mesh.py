"""Triangle mesh container and depth-map meshing.

The counterpart of the JAX package's `geometry/mesh.py` (reference:
diffhandles/mesh.py and depth_transform.py:30-71): a plain dataclass of
tensors on one device. `depth_to_mesh` lifts the pixel grid to world
space, two CCW triangles per quad of adjacent in-mask pixels, with a
per-vertex 'color' attribute (u, v image coordinates + foreground flag)
that carries correspondences through the renderer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from diffusionhandles_tpu_torch.geometry.depth import depth_to_world_coords
from diffusionhandles_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class Mesh:
    """verts [V, 3] fp32; faces [F, 3] int64; named attributes."""

    verts: torch.Tensor
    faces: torch.Tensor
    vert_attributes: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    face_attributes: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def add_vert_attribute(self, name: str, values) -> None:
        values = torch.as_tensor(values, device=self.verts.device)
        if values.shape[0] != self.verts.shape[0]:
            raise ValueError(
                f"attribute '{name}' has {values.shape[0]} entries for "
                f"{self.verts.shape[0]} vertices")
        self.vert_attributes[name] = values

    def add_face_attribute(self, name: str, values) -> None:
        values = torch.as_tensor(values, device=self.faces.device)
        if values.shape[0] != self.faces.shape[0]:
            raise ValueError(
                f"attribute '{name}' has {values.shape[0]} entries for "
                f"{self.faces.shape[0]} faces")
        self.face_attributes[name] = values

    def bounds(self):
        return self.verts.amin(0), self.verts.amax(0)

    def normalized(self) -> "Mesh":
        """Scaled and translated into the unit cube about the origin."""
        lo, hi = self.bounds()
        scale = float((hi - lo).max()) or 1.0
        return dataclasses.replace(self,
                                   verts=(self.verts - (lo + hi) / 2) / scale)


def depth_to_mesh(depth, intrinsics, extrinsics_R=None, extrinsics_t=None,
                  mask=None, device=None) -> Mesh:
    """Lift a depth map ([H, W] or [1, 1, H, W]) to a pixel-grid triangle
    mesh on `device` (default: the GPU) (reference:
    depth_transform.py:30-71).

    Vertices are the (masked) pixels' world positions in raster order;
    faces are two CCW triangles per quad of in-mask pixels (upper-left,
    lower-right); 'color' is (u, v in [0, 1], 1 if a mask was given
    else 0)."""
    device = resolve_device(device)
    depth = torch.as_tensor(depth, dtype=torch.float32, device=device)
    h, w = depth.shape[-2:]
    verts_grid = depth_to_world_coords(depth, intrinsics, extrinsics_R,
                                       extrinsics_t)
    mask2d = (torch.ones((h, w), dtype=torch.bool, device=device)
              if mask is None else torch.as_tensor(
                  mask, device=device).reshape(h, w) > 0.5)
    verts = verts_grid[mask2d]
    # numpy's float32 linspace (computed in float64), as the JAX package
    # builds it on the host
    uu = torch.from_numpy(np.linspace(0, 1, w, dtype=np.float32)).to(device)
    vv = torch.from_numpy(np.linspace(0, 1, h, dtype=np.float32)).to(device)
    img_coords = torch.stack([uu.expand(h, w), vv[:, None].expand(h, w)],
                             dim=-1)[mask2d]

    vertex_idx = torch.cumsum(mask2d.reshape(-1), 0).reshape(h, w) - 1
    vertex_idx = torch.where(mask2d, vertex_idx, -1)
    tris_ul = torch.stack([vertex_idx[1:, :-1].reshape(-1),
                           vertex_idx[:-1, 1:].reshape(-1),
                           vertex_idx[:-1, :-1].reshape(-1)], dim=-1)
    tris_lr = torch.stack([vertex_idx[1:, :-1].reshape(-1),
                           vertex_idx[1:, 1:].reshape(-1),
                           vertex_idx[:-1, 1:].reshape(-1)], dim=-1)
    faces = torch.stack([tris_ul, tris_lr], dim=1).reshape(-1, 3)
    faces = faces[faces.amin(-1) >= 0]

    mesh = Mesh(verts=verts, faces=faces)
    fg_flag = 0.0 if mask is None else 1.0
    mesh.add_vert_attribute("color", torch.cat(
        [img_coords, torch.full_like(img_coords[:, :1], fg_flag)], dim=-1))
    return mesh
