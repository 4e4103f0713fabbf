"""Multi-output deferred-shading renderer.

The counterpart of the JAX package's `geometry/renderer.py` (reference:
diffhandles/renderer.py, the Camera / Renderer interfaces, and
diffhandles/pytorch3d_renderer.py, MultioutputMeshRenderer with its shader
zoo). Rasterize once (`ops/rasterize.py`, on the mesh's device), then
derive any number of named outputs from the fragment buffer:

  'depth'              z-buffer (DepthShader, reference :362-397)
  'mask'               coverage
  'world_position'     barycentric-interpolated vertex positions
  'camera_position'    positions in the camera frame (extrinsics applied)
  'world_normal'       per-face normals
  'vertex_normal'      smooth vertex normals, interpolated
  'flat_vertex_color'  the 'color' vertex attribute, interpolated
                       (FlatVertexAttributeShader, reference :487-537)
  'uv_texture'         a 2D texture sampled at interpolated per-vertex UVs
                       (FlatTextureShader, reference :453-485)
  'global_volume_texture' a 3D texture sampled at world positions
                       (FlatGlobalVolumeTextureShader, reference :400-450)
  'face_id'            the winning face's index (int32)
  'alpha'              coverage: binary (hard blend), or soft over the
                       faces_per_pixel fragments (sigmoid_alpha_blend,
                       reference :341-358; softmax per PyTorch3D's
                       softmax_rgb_blend)

Each step keeps the JAX package's precision and place: the camera
transform, the normals and the texture lookups run in numpy on the host,
as there; projection, rasterization, blending and interpolation in fp32
torch on the mesh's device. `render()` returns numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from diffusionhandles_tpu_torch.geometry.mesh import Mesh
from diffusionhandles_tpu_torch.geometry.mesh_transform import merge_meshes
from diffusionhandles_tpu_torch.ops.rasterize import (
    RasterOut, interpolate_attribute, interpolate_attribute_k, project_verts,
    rasterize, rasterize_k, sigmoid_alpha_blend, softmax_blend_weights)
from diffusionhandles_tpu_torch.utils.device import host_array


@dataclasses.dataclass
class Camera:
    """Pinhole camera (reference: renderer.py:9-13)."""

    intrinsics: np.ndarray
    extrinsics_R: Optional[np.ndarray] = None
    extrinsics_t: Optional[np.ndarray] = None


class Renderer:
    """Abstract renderer (reference: renderer.py:20-61)."""

    def update_scene(self, scene_elements: dict) -> None:
        raise NotImplementedError

    def set_output_layers(self, output_names: Sequence[str]) -> None:
        raise NotImplementedError

    def render(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError


@dataclasses.dataclass
class RasterRendererArgs:
    """(reference: PyTorch3DRendererArgs, pytorch3d_renderer.py:31-53).

    blend_type 'hard' (the top-1 fragment), 'sigmoid' (PyTorch3D
    sigmoid_alpha_blend: channels from the closest fragment, a soft
    coverage as the 'alpha' layer) or 'softmax' (PyTorch3D
    softmax_rgb_blend: channels are the gamma-weighted softmax over the
    faces_per_pixel fragments plus a background term). blend_gamma weights
    depth in the softmax; blend_znear / blend_zfar normalize its z
    (PyTorch3D's defaults). blur_radius is in NDC^2 units like
    PyTorch3D's."""

    output_res: Tuple[int, int] = (512, 512)
    cull_backfaces: bool = False
    z_near: float = 0.1
    faces_per_pixel: int = 1
    blur_radius: float = 0.0
    blend_type: str = "hard"
    blend_sigma: float = 1e-4
    blend_gamma: float = 1e-4
    blend_znear: float = 1.0
    blend_zfar: float = 100.0
    background_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)


class RasterRenderer(Renderer):
    """The rasterizing renderer (replaces PyTorch3DRenderer); it runs on
    the device of the scene's meshes."""

    def __init__(self, output_names: Sequence[str],
                 args: Optional[RasterRendererArgs] = None):
        self.output_names = list(output_names)
        self.args = args or RasterRendererArgs()
        self._mesh: Optional[Mesh] = None
        self._camera: Optional[Camera] = None

    def update_scene(self, scene_elements: dict) -> None:
        """Scene dict: meshes, cameras, optional uv_textures (a list of
        [Ht, Wt, C]) and global_volume_texture ([D, H, W, C], with
        global_volume_texture_bounds (lo, hi)) (reference:
        pytorch3d_renderer.py's scene dict, :570-576)."""
        meshes = scene_elements.get("meshes", [])
        if not meshes:
            raise ValueError("scene needs at least one mesh")
        self._mesh = meshes[0] if len(meshes) == 1 else merge_meshes(*meshes)
        cameras = scene_elements.get("cameras", [])
        if not cameras:
            raise ValueError("scene needs a camera")
        self._camera = cameras[0]
        self._uv_texture = None
        uv_textures = scene_elements.get("uv_textures")
        if uv_textures:
            self._uv_texture = host_array(uv_textures[0]).astype(np.float32)
        self._volume_texture = scene_elements.get("global_volume_texture")
        self._volume_bounds = scene_elements.get(
            "global_volume_texture_bounds")

    def set_output_layers(self, output_names: Sequence[str]) -> None:
        self.output_names = list(output_names)

    def render(self) -> Dict[str, np.ndarray]:
        mesh, cam = self._mesh, self._camera
        if mesh is None or cam is None:
            raise RuntimeError("update_scene must be called before render")
        if self.args.blend_type not in ("hard", "sigmoid", "softmax"):
            raise ValueError(
                f"Unsupported blend type: {self.args.blend_type}")
        h, w = self.args.output_res
        dev = mesh.verts.device
        verts = host_array(mesh.verts).astype(np.float32)
        if cam.extrinsics_R is not None or cam.extrinsics_t is not None:
            R = (host_array(cam.extrinsics_R).astype(np.float32)
                 if cam.extrinsics_R is not None
                 else np.eye(3, dtype=np.float32))
            t = (host_array(cam.extrinsics_t).astype(np.float32)
                 if cam.extrinsics_t is not None
                 else np.zeros(3, np.float32))
            cam_verts = (R @ verts.T).T + t
        else:
            cam_verts = verts
        verts_px = project_verts(torch.from_numpy(cam_verts).to(dev),
                                 host_array(cam.intrinsics).astype(np.float32),
                                 h, w)
        faces = mesh.faces.to(dev).long()
        soft = (self.args.blend_type in ("sigmoid", "softmax")
                or self.args.faces_per_pixel > 1
                or self.args.blur_radius > 0)
        kraster = None
        if soft:
            kraster = rasterize_k(
                verts_px, faces, h, w,
                faces_per_pixel=self.args.faces_per_pixel,
                blur_radius=self.args.blur_radius,
                cull_backfaces=self.args.cull_backfaces,
                z_near=self.args.z_near)
            # the closest fragment drives the channel shaders (PyTorch3D's
            # sigmoid_alpha_blend keeps its values)
            raster = RasterOut(face_id=kraster.face_id[0],
                               bary=kraster.bary[0], zbuf=kraster.zbuf[0])
        else:
            raster = rasterize(verts_px, faces, h, w,
                               cull_backfaces=self.args.cull_backfaces,
                               z_near=self.args.z_near)

        host_faces = host_array(faces)
        out: Dict[str, np.ndarray] = {}
        covered = host_array(raster.face_id) >= 0
        softmax_w = None
        if self.args.blend_type == "softmax":
            softmax_w = softmax_blend_weights(
                kraster, sigma=self.args.blend_sigma,
                gamma=self.args.blend_gamma, znear=self.args.blend_znear,
                zfar=self.args.blend_zfar)

        def blend_attr(vert_attr, background=None):
            """A per-vertex attribute, softmax-weighted over the K
            fragments (plus the background term) or the winner's."""
            if softmax_w is not None:
                wk, w_bg, _ = softmax_w
                attr_k = interpolate_attribute_k(kraster, faces, vert_attr)
                img = (wk[..., None] * attr_k).sum(0)
                if background is not None:
                    img = img + w_bg[..., None] * torch.as_tensor(
                        background, dtype=torch.float32, device=dev)
                return host_array(img)
            img = host_array(interpolate_attribute(raster, faces, vert_attr))
            if background is not None:
                img[~covered] = np.asarray(background, np.float32)
            return img

        for name in self.output_names:
            if name == "alpha":
                # hard blend: binary coverage (hard_rgb_blend's alpha);
                # sigmoid / softmax: soft coverage over the K fragments
                if self.args.blend_type == "sigmoid":
                    out[name] = host_array(sigmoid_alpha_blend(
                        kraster, self.args.blend_sigma))
                elif softmax_w is not None:
                    out[name] = host_array(softmax_w[2])
                else:
                    out[name] = covered.astype(np.float32)
            elif name == "depth":
                out[name] = host_array(raster.zbuf)
            elif name == "mask":
                out[name] = covered
            elif name == "face_id":
                out[name] = host_array(raster.face_id).astype(np.int32)
            elif name == "world_position":
                out[name] = blend_attr(verts)
            elif name == "camera_position":
                out[name] = blend_attr(cam_verts)
            elif name == "world_normal":
                fn = _face_normals(verts, host_faces)
                if softmax_w is not None:
                    fid_k = host_array(kraster.face_id)
                    fn_k = np.where(fid_k[..., None] >= 0,
                                    fn[np.maximum(fid_k, 0)], 0.0)
                    out[name] = host_array((softmax_w[0][..., None]
                                       * torch.from_numpy(fn_k).float().to(
                                           dev)).sum(0))
                else:
                    img = fn[np.maximum(host_array(raster.face_id), 0)]
                    img[~covered] = 0
                    out[name] = img
            elif name == "vertex_normal":
                out[name] = blend_attr(_vertex_normals(verts, host_faces))
            elif name == "flat_vertex_color":
                color = mesh.vert_attributes.get("color")
                if color is None:
                    raise ValueError("mesh has no 'color' attribute")
                color = host_array(color).astype(np.float32)
                bg = np.asarray(self.args.background_color, np.float32)
                has_bg = color.shape[-1] == bg.shape[0]
                out[name] = blend_attr(color, bg if has_bg else None)
            elif name == "uv_texture":
                uv = mesh.vert_attributes.get("uv")
                if uv is None or self._uv_texture is None:
                    raise ValueError(
                        "'uv_texture' needs a mesh 'uv' attribute and a "
                        "scene uv_textures entry")
                out[name] = self._sample_layer(
                    host_array(uv).astype(np.float32), raster, kraster,
                    softmax_w, faces, covered,
                    lambda q: _sample_texture2d(self._uv_texture, q))
            elif name == "global_volume_texture":
                if self._volume_texture is None:
                    raise ValueError(
                        "'global_volume_texture' needs a scene "
                        "global_volume_texture entry")
                vol = host_array(self._volume_texture).astype(np.float32)
                bounds = (None if self._volume_bounds is None else
                          [host_array(b) for b in self._volume_bounds])
                out[name] = self._sample_layer(
                    verts, raster, kraster, softmax_w, faces, covered,
                    lambda q: _sample_volume(vol, q, bounds))
            else:
                raise ValueError(f"unknown output layer '{name}'")
        return out

    @staticmethod
    def _sample_layer(vert_attr, raster, kraster, softmax_w, faces, covered,
                      sample_fn):
        """A texture-style output: interpolate a per-vertex lookup
        coordinate, sample it on the host with `sample_fn`, and (softmax)
        blend over the fragment levels in fp32."""
        if softmax_w is not None:
            coords_k = host_array(interpolate_attribute_k(kraster, faces,
                                                     vert_attr))
            sampled = np.stack([sample_fn(c) for c in coords_k])
            sampled = np.where(host_array(kraster.face_id)[..., None] >= 0,
                               sampled, 0.0)
            # the weighted samples in the texture's precision on the host,
            # summed in fp32, as the JAX package does
            wk = softmax_w[0]
            weighted = host_array(wk)[..., None] * sampled
            return host_array(torch.from_numpy(weighted).float().to(
                wk.device).sum(0))
        img = sample_fn(host_array(interpolate_attribute(raster, faces,
                                                    vert_attr)))
        img[~covered] = 0
        return img


def _sample_texture2d(tex: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Bilinear texture sampling; uv in [0, 1]^2 ([H, W, 2] -> [H, W, C])."""
    th, tw = tex.shape[:2]
    u = np.clip(uv[..., 0], 0, 1) * (tw - 1)
    v = np.clip(uv[..., 1], 0, 1) * (th - 1)
    u0 = np.floor(u).astype(int)
    v0 = np.floor(v).astype(int)
    u1 = np.minimum(u0 + 1, tw - 1)
    v1 = np.minimum(v0 + 1, th - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return ((tex[v0, u0] * (1 - fu) + tex[v0, u1] * fu) * (1 - fv)
            + (tex[v1, u0] * (1 - fu) + tex[v1, u1] * fu) * fv)


def _sample_volume(vol: np.ndarray, pos: np.ndarray, bounds) -> np.ndarray:
    """Nearest-neighbour 3D texture sampling at world positions, in
    float64 as the JAX package does. vol [D, H, W, C]; bounds (lo[3],
    hi[3]), default the unit cube about the origin."""
    if bounds is None:
        lo = np.array([-0.5, -0.5, -0.5])
        hi = np.array([0.5, 0.5, 0.5])
    else:
        lo, hi = np.asarray(bounds[0], float), np.asarray(bounds[1], float)
    t = (pos - lo) / np.maximum(hi - lo, 1e-12)
    t = np.clip(t, 0, 1)
    d, h, w = vol.shape[:3]
    zi = np.clip((t[..., 2] * (d - 1)).round().astype(int), 0, d - 1)
    yi = np.clip((t[..., 1] * (h - 1)).round().astype(int), 0, h - 1)
    xi = np.clip((t[..., 0] * (w - 1)).round().astype(int), 0, w - 1)
    return vol[zi, yi, xi]


def _face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    return n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12)


def _vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    return vn / (np.linalg.norm(vn, axis=-1, keepdims=True) + 1e-12)
