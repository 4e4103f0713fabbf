"""Hard (top-1) triangle rasterization as torch scatter ops.

The counterpart of the hard half of the JAX package's `ops/rasterize.py`
(reference: diffhandles/pytorch3d_renderer.py, used by
depth_transform.py:149-166 for mesh-mode depth transforms): a z-buffer
with barycentric attribute interpolation, backface culling and a z-near
clip. The JAX package has no Pallas kernel here (XLA scatter-min), and
neither has this port: the passes are torch ops on the mesh's device.

Depth-surface meshes have pixel-scale triangles, so each face is sampled on
a fixed FOOT x FOOT pixel window anchored at its screen bbox; the window's
candidates resolve per pixel by a two-pass scatter-min (min z, then the
lowest candidate index among those at that z, index = offset * F + face:
the JAX package's concatenation order). Faces whose bbox exceeds the window
(depth-edge slivers) go through an exact full-image pass in chunks of
faces: each chunk takes its first minimum along the chunk, then merges into
the running buffer with a strict '<', which is the JAX package's sequential
scan over the big faces. The two passes merge on strictly smaller z, or
equal z and a lower face id.

All 3x3 products are elementwise, so no matmul setting (TF32) changes
them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_INF = float("inf")
# candidates (faces x window offsets) of one scatter group in the small
# pass, and pixels x faces of one chunk in the big pass: ~2**23 elements
# keep each pass's temporaries to a few hundred MB
GROUP_ELEMENTS = 1 << 23


class RasterOut(NamedTuple):
    """face_id [H, W] int64 (-1 = background); bary [H, W, 3] fp32; zbuf
    [H, W] fp32 (inf where empty)."""

    face_id: torch.Tensor
    bary: torch.Tensor
    zbuf: torch.Tensor


def project_verts(verts, intrinsics, height: int, width: int
                  ) -> torch.Tensor:
    """PyTorch3D-frame verts [V, 3] -> [V, 3] continuous pixel coords
    (u, v) and view z, as the pc path's splat projects (the frame flips x
    and y, the full 3x3 intrinsics apply, and NDC maps to pixels by
    c = x * 0.5 * (max(H, W) - 1) + (dim - 1) / 2). `intrinsics`: a 3x3
    matrix or a scalar focal length (diag(f, f, 1))."""
    verts = torch.as_tensor(verts, dtype=torch.float32)
    k = torch.as_tensor(intrinsics, dtype=torch.float32).to(verts.device)
    if k.ndim == 0:
        k = torch.diag(torch.stack([k, k, torch.ones_like(k)]))
    z = verts[:, 2]
    pts = verts * torch.tensor([-1.0, -1.0, 1.0], device=verts.device)
    proj = [pts[:, 0] * k[i, 0] + pts[:, 1] * k[i, 1] + pts[:, 2] * k[i, 2]
            for i in range(3)]
    m = max(height, width) - 1
    u = proj[0] / proj[2] * 0.5 * m + (width - 1) / 2.0
    v = proj[1] / proj[2] * 0.5 * m + (height - 1) / 2.0
    return torch.stack([u, v, z], dim=-1)


def _winner_scatter(lin_idx, z, cand_valid, num_pixels: int,
                    num_cand: int):
    """Exact first-wins min-z winner per pixel (two-pass scatter-min) of
    one candidate list: (zmin [P], lowest index attaining it [P], num_cand
    where none)."""
    z = torch.where(cand_valid, z, _INF)
    zmin = torch.full((num_pixels,), _INF, device=z.device).scatter_reduce(
        0, lin_idx, z, reduce="amin")
    idx = torch.arange(num_cand, device=z.device)
    cand = torch.where(cand_valid & (z == zmin[lin_idx]), idx, num_cand)
    winner = torch.full((num_pixels,), num_cand, dtype=torch.long,
                        device=z.device).scatter_reduce(
        0, lin_idx, cand, reduce="amin")
    return zmin, winner


def _face_setup(verts_px, faces, cull_backfaces: bool, z_near: float,
                eps: float):
    """Per-face corners (u, v, z each [3][...]), signed area and the
    cull / near-clip test."""
    tri = verts_px[faces]                                   # [F, 3, 3]
    u = [tri[:, i, 0] for i in range(3)]
    v = [tri[:, i, 1] for i in range(3)]
    z = [tri[:, i, 2] for i in range(3)]
    area = (u[1] - u[0]) * (v[2] - v[0]) - (u[2] - u[0]) * (v[1] - v[0])
    valid = area.abs() > eps
    if cull_backfaces:
        # depth_to_mesh's CCW faces project to negative area (y down)
        valid = valid & (area < 0)
    valid = valid & (torch.minimum(torch.minimum(z[0], z[1]), z[2])
                     > z_near)
    return u, v, z, area, valid


def _bary_z(u, v, z, area, pu, pv):
    """Barycentrics (w0, w1, w2) of pixel (pu, pv) and the interpolated
    z, in the JAX package's operation order."""
    w0 = ((u[1] - pu) * (v[2] - pv) - (u[2] - pu) * (v[1] - pv)) / area
    w1 = ((u[2] - pu) * (v[0] - pv) - (u[0] - pu) * (v[2] - pv)) / area
    w2 = 1.0 - w0 - w1
    covered = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
    return covered, w0 * z[0] + w1 * z[1] + w2 * z[2]


def _rasterize_small(verts_px, faces, face_enabled, height: int, width: int,
                     foot: int = 8, cull_backfaces: bool = True,
                     z_near: float = 0.1, eps: float = 1e-8):
    """The window pass: every enabled face sampled on a foot x foot window
    anchored at its bbox min. Returns flat (zbuf, face_id). The window's
    offsets stream in groups; the two scatter passes each run over all
    groups (the second recomputes the same z bit for bit)."""
    num_faces = faces.shape[0]
    u, v, z, area, valid = _face_setup(verts_px, faces, cull_backfaces,
                                       z_near, eps)
    valid = valid & face_enabled
    bb_min_u = torch.floor(torch.minimum(torch.minimum(u[0], u[1]), u[2]))
    bb_min_v = torch.floor(torch.minimum(torch.minimum(v[0], v[1]), v[2]))
    bb_max_u = torch.ceil(torch.maximum(torch.maximum(u[0], u[1]), u[2]))
    bb_max_v = torch.ceil(torch.maximum(torch.maximum(v[0], v[1]), v[2]))
    bb_min_u, bb_min_v, bb_max_u, bb_max_v = (
        a.to(torch.int32) for a in (bb_min_u, bb_min_v, bb_max_u, bb_max_v))
    offsets = [(i, j) for i in range(foot) for j in range(foot)]
    group = max(1, min(len(offsets), GROUP_ELEMENTS // max(num_faces, 1)))
    num_px = height * width
    num_cand = num_faces * len(offsets)
    dev = verts_px.device
    face_ids = torch.arange(num_faces, device=dev)

    def samples(start):
        """(pixel index, z, ok, candidate index) of the offsets
        [start, start + group), each [g * F], offset-major."""
        offs = torch.tensor(offsets[start:start + group], dtype=torch.int32,
                            device=dev)
        pu = bb_min_u + offs[:, 1:2]
        pv = bb_min_v + offs[:, 0:1]
        inside = (pu >= 0) & (pu < width) & (pv >= 0) & (pv < height)
        in_bbox = (pu <= bb_max_u) & (pv <= bb_max_v)
        covered, zc = _bary_z(u, v, z, area, pu.float(), pv.float())
        ok = valid & inside & in_bbox & covered
        lin = (pv.clamp(0, height - 1) * width
               + pu.clamp(0, width - 1)).long()
        cand = (torch.arange(start, start + offs.shape[0], device=dev)[:, None]
                * num_faces + face_ids)
        return lin.reshape(-1), zc.reshape(-1), ok.reshape(-1), \
            cand.reshape(-1)

    zmin = torch.full((num_px,), _INF, device=dev)
    for start in range(0, len(offsets), group):
        lin, zc, ok, _ = samples(start)
        zmin.scatter_reduce_(0, lin, torch.where(ok, zc, _INF),
                             reduce="amin")
    winner = torch.full((num_px,), num_cand, dtype=torch.long, device=dev)
    for start in range(0, len(offsets), group):
        lin, zc, ok, cand = samples(start)
        hit = ok & (torch.where(ok, zc, _INF) == zmin[lin])
        winner.scatter_reduce_(0, lin, torch.where(hit, cand, num_cand),
                               reduce="amin")
    face_of_winner = torch.where(winner < num_cand, winner % num_faces, -1)
    return zmin, face_of_winner


def _rasterize_big(verts_px, faces, big_idx, height: int, width: int,
                   cull_backfaces: bool = True, z_near: float = 0.1,
                   eps: float = 1e-8):
    """The exact full-image pass over the big faces `big_idx` (ascending),
    in chunks: a chunk's first minimum along its faces merges into the
    running buffer on a strict '<', so the lowest face index wins a tie,
    as in a sequential scan. Returns flat (zbuf, face_id)."""
    dev = verts_px.device
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    zbuf = torch.full((height, width), _INF, device=dev)
    fid = torch.full((height, width), -1, dtype=torch.long, device=dev)
    chunk = max(1, GROUP_ELEMENTS // (height * width))
    for start in range(0, big_idx.numel(), chunk):
        idx = big_idx[start:start + chunk]
        c = idx.numel()
        u, v, z, area, ok = _face_setup(verts_px, faces[idx],
                                        cull_backfaces, z_near, eps)
        safe_area = torch.where(area.abs() > eps, area, 1.0)
        u, v, z = ([a[:, None, None] for a in corners] for corners in
                   (u, v, z))
        covered, zc = _bary_z(u, v, z, safe_area[:, None, None], px, py)
        covered = covered & ok[:, None, None]
        zc = torch.where(covered, zc, _INF)
        zmin = zc.amin(0)
        order = torch.arange(c, device=dev)[:, None, None]
        first = torch.where(covered & (zc == zmin), order, c).amin(0)
        better = (first < c) & (zmin < zbuf)
        zbuf = torch.where(better, zmin, zbuf)
        fid = torch.where(better, idx[first.clamp(max=c - 1)], fid)
    return zbuf.reshape(-1), fid.reshape(-1)


def big_faces(verts_px, faces, foot: int = 8) -> torch.Tensor:
    """Indices (ascending) of the faces whose screen bbox exceeds the
    small pass's foot x foot window."""
    tri = verts_px[faces]
    du = tri[..., 0].amax(1) - tri[..., 0].amin(1)
    dv = tri[..., 1].amax(1) - tri[..., 1].amin(1)
    return torch.nonzero(torch.maximum(du, dv) > foot - 1)[:, 0]


def rasterize(verts_px, faces, height: int, width: int, foot: int = 8,
              cull_backfaces: bool = True, z_near: float = 0.1
              ) -> RasterOut:
    """Rasterize triangles to a top-1 z-buffer.

    verts_px: [V, 3] (u, v, z) from project_verts; faces: [F, 3]; foot:
    the window of the small pass (larger faces take the exact pass)."""
    verts_px = torch.as_tensor(verts_px, dtype=torch.float32)
    dev = verts_px.device
    faces = torch.as_tensor(faces, device=dev).long()
    big_idx = big_faces(verts_px, faces, foot)
    small_enabled = torch.ones(faces.shape[0], dtype=torch.bool, device=dev)
    small_enabled[big_idx] = False
    z_small, fid_small = _rasterize_small(
        verts_px, faces, small_enabled, height, width, foot=foot,
        cull_backfaces=cull_backfaces, z_near=z_near)
    if big_idx.numel():
        z_big, fid_big = _rasterize_big(
            verts_px, faces, big_idx, height, width,
            cull_backfaces=cull_backfaces, z_near=z_near)
        take_big = ((z_big < z_small)
                    | ((z_big == z_small) & (fid_big < fid_small)))
        take_big = take_big & (fid_big >= 0)
        zmin = torch.where(take_big, z_big, z_small)
        face_id = torch.where(take_big, fid_big, fid_small)
    else:
        zmin, face_id = z_small, fid_small
    zbuf = zmin.reshape(height, width)
    face_id = face_id.reshape(height, width)

    # barycentrics of the winning face at each pixel
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    tri = verts_px[faces][face_id.clamp(min=0)]             # [H, W, 3, 3]
    fu = [tri[..., i, 0] for i in range(3)]
    fv = [tri[..., i, 1] for i in range(3)]
    farea = (fu[1] - fu[0]) * (fv[2] - fv[0]) - (fu[2] - fu[0]) * (
        fv[1] - fv[0])
    farea = torch.where(farea.abs() > 1e-12, farea, 1.0)
    w0 = ((fu[1] - px) * (fv[2] - py) - (fu[2] - px) * (fv[1] - py)) / farea
    w1 = ((fu[2] - px) * (fv[0] - py) - (fu[0] - px) * (fv[2] - py)) / farea
    w2 = 1.0 - w0 - w1
    bary = torch.stack([w0, w1, w2], dim=-1)
    bary = torch.where(face_id[..., None] >= 0, bary, 0.0)
    return RasterOut(face_id=face_id, bary=bary, zbuf=zbuf)


def interpolate_attribute(raster: RasterOut, faces, vert_attr
                          ) -> torch.Tensor:
    """Barycentric interpolation of a per-vertex attribute [V, C] to the
    image [H, W, C] (0 where no face)."""
    dev = raster.face_id.device
    faces = torch.as_tensor(faces, device=dev).long()
    vert_attr = torch.as_tensor(vert_attr, dtype=torch.float32, device=dev)
    tri_attr = vert_attr[faces[raster.face_id.clamp(min=0)]]  # [H,W,3,C]
    b = raster.bary[..., None]
    out = (b[..., 0, :] * tri_attr[..., 0, :] + b[..., 1, :]
           * tri_attr[..., 1, :] + b[..., 2, :] * tri_attr[..., 2, :])
    return torch.where(raster.face_id[..., None] >= 0, out, 0.0)
