"""Triangle rasterization as torch scatter ops: a hard top-1 z-buffer and
a top-K fragment buffer with soft blending.

The counterpart of the JAX package's `ops/rasterize.py` (reference:
diffhandles/pytorch3d_renderer.py, used by depth_transform.py:149-166 for
mesh-mode depth transforms and by the demo's rgb preview): barycentric
attribute interpolation, backface culling, a z-near clip, PyTorch3D's
faces_per_pixel, blur radius, sigmoid and softmax blending. The JAX
package has no Pallas kernel here (XLA scatter-min and sort), and neither
has this port: the passes are torch ops on the mesh's device.

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

The top-K buffer ranks fragments by (z, candidate index) level by level in
the window pass, and by (z, face id) in the big-face pass, whose chunks
merge into the running K-buffer by a lexicographic sort (a stable sort on
the face id, then a stable sort on z: the JAX package's two-key sort, with
ties in a defined order that `torch.topk` does not promise).

All 3x3 products are elementwise, so no matmul setting (TF32) changes
them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


# ---------------------------------------------------------------------------
# Top-K fragments and soft blending
# ---------------------------------------------------------------------------

# the face id of an empty K-buffer slot: above every real face, so that a
# two-key sort puts it last
_BIG_FID = 2 ** 30


class KRasterOut(NamedTuple):
    """Top-K fragments per pixel, sorted by ascending z (ties: lowest face
    index). face_id [K, H, W] int64 (-1 = empty); bary [K, H, W, 3];
    zbuf [K, H, W] (inf where empty); dists [K, H, W] signed squared
    distance to the face's edges in NDC^2 (PyTorch3D convention: negative
    inside the face, inf where empty)."""

    face_id: torch.Tensor
    bary: torch.Tensor
    zbuf: torch.Tensor
    dists: torch.Tensor


def _point_edge_dist2(pu, pv, au, av, bu, bv):
    """Squared distance from point (pu, pv) to segment (a, b)."""
    eu, ev = bu - au, bv - av
    t = ((pu - au) * eu + (pv - av) * ev) / torch.clamp(eu * eu + ev * ev,
                                                         min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    du = pu - (au + t * eu)
    dv = pv - (av + t * ev)
    return du * du + dv * dv


def _face_fragment(u, v, z, pu, pv, ndc_scale2: float):
    """Fragment quantities of faces with corners (u, v, z each [3][...])
    at pixels (pu, pv), broadcast: (z from the barycentrics clipped to
    the face (PyTorch3D clip_barycentric_coords), the inside test, the
    signed squared edge distance in NDC^2, the clipped barycentrics)."""
    area = (u[1] - u[0]) * (v[2] - v[0]) - (u[2] - u[0]) * (v[1] - v[0])
    safe_area = torch.where(area.abs() > 1e-12, area, 1.0)
    w0 = ((u[1] - pu) * (v[2] - pv) - (u[2] - pu) * (v[1] - pv)) / safe_area
    w1 = ((u[2] - pu) * (v[0] - pv) - (u[0] - pu) * (v[2] - pv)) / safe_area
    w2 = 1.0 - w0 - w1
    covered = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
    c0, c1, c2 = (torch.clamp(w, min=0.0) for w in (w0, w1, w2))
    s = torch.clamp(c0 + c1 + c2, min=1e-12)
    c0, c1, c2 = c0 / s, c1 / s, c2 / s
    zc = c0 * z[0] + c1 * z[1] + c2 * z[2]
    d2 = torch.minimum(
        torch.minimum(_point_edge_dist2(pu, pv, u[0], v[0], u[1], v[1]),
                      _point_edge_dist2(pu, pv, u[1], v[1], u[2], v[2])),
        _point_edge_dist2(pu, pv, u[2], v[2], u[0], v[0])) * ndc_scale2
    d2 = torch.where(covered, -d2, d2)
    return zc, covered, d2, (c0, c1, c2)


def _sort2(z, fid, k: int):
    """The first k of (z, fid) along dim 0, ordered by z then fid."""
    fid, order = torch.sort(fid, dim=0, stable=True)
    z = z.gather(0, order)
    z, order = torch.sort(z, dim=0, stable=True)
    return z[:k], fid.gather(0, order)[:k]


def _rasterize_small_k(verts_px, faces, face_enabled, height: int,
                       width: int, foot: int, k: int, blur_px2: float = 0.0,
                       cull_backfaces: bool = True, z_near: float = 0.1,
                       eps: float = 1e-8):
    """The window pass at K levels: (z [k, H*W], face id [k, H*W], _BIG_FID
    where empty), each level ascending by (z, candidate index). The
    window's offsets stream in groups; only the candidates that hit a
    pixel are kept, and every level reads them (a scatter-min is exact in
    any order)."""
    num_faces = faces.shape[0]
    u, v, z, _, valid = _face_setup(verts_px, faces, cull_backfaces, z_near,
                                    eps)
    valid = valid & face_enabled
    pad = int(np.ceil(np.sqrt(blur_px2))) if blur_px2 > 0 else 0
    ndc_scale2 = (2.0 / (max(height, width) - 1)) ** 2
    blur_ndc2 = blur_px2 * ndc_scale2
    bb = [torch.floor(torch.minimum(torch.minimum(c[0], c[1]), c[2]))
          for c in (u, v)]
    bb_min_u, bb_min_v = (a.to(torch.int32) - pad for a in bb)
    bb = [torch.ceil(torch.maximum(torch.maximum(c[0], c[1]), c[2]))
          for c in (u, v)]
    bb_max_u, bb_max_v = (a.to(torch.int32) + pad for a in bb)
    offsets = [(i, j) for i in range(foot) for j in range(foot)]
    group = max(1, min(len(offsets), GROUP_ELEMENTS // max(num_faces, 1)))
    num_px = height * width
    num_cand = num_faces * len(offsets)
    dev = verts_px.device
    face_ids = torch.arange(num_faces, device=dev)

    lins, zs, cands = [], [], []
    for start in range(0, len(offsets), group):
        offs = torch.tensor(offsets[start:start + group], dtype=torch.int32,
                            device=dev)
        pu = bb_min_u + offs[:, 1:2]
        pv = bb_min_v + offs[:, 0:1]
        inside = (pu >= 0) & (pu < width) & (pv >= 0) & (pv < height)
        in_bbox = (pu <= bb_max_u) & (pv <= bb_max_v)
        zc, covered, d2, _ = _face_fragment(u, v, z, pu.float(), pv.float(),
                                            ndc_scale2)
        hit = valid & inside & in_bbox & (covered | (d2 < blur_ndc2))
        lin = pv.clamp(0, height - 1) * width + pu.clamp(0, width - 1)
        cand = (torch.arange(start, start + offs.shape[0], device=dev)[:, None]
                * num_faces + face_ids)
        lins.append(lin[hit].long())
        zs.append(zc[hit])
        cands.append(cand[hit])
    lin, zc, cand = torch.cat(lins), torch.cat(zs), torch.cat(cands)

    levels_z, levels_fid = [], []
    zprev = torch.full((num_px,), -_INF, device=dev)
    wprev = torch.full((num_px,), -1, dtype=torch.long, device=dev)
    for _ in range(k):
        zp, wp = zprev[lin], wprev[lin]
        eligible = (zc > zp) | ((zc == zp) & (cand > wp))
        zk = torch.where(eligible, zc, _INF)
        zmin = torch.full((num_px,), _INF, device=dev).scatter_reduce(
            0, lin, zk, reduce="amin")
        hit = (zk < _INF) & (zk == zmin[lin])
        winner = torch.full((num_px,), num_cand, dtype=torch.long,
                            device=dev).scatter_reduce(
            0, lin, torch.where(hit, cand, num_cand), reduce="amin")
        levels_z.append(zmin)
        levels_fid.append(torch.where(winner < num_cand, winner % num_faces,
                                      _BIG_FID))
        zprev, wprev = zmin, winner
    return torch.stack(levels_z), torch.stack(levels_fid)


def _big_face_chunks(verts_px, faces, big_idx, height: int, width: int,
                     pad: int):
    """Chunks of the big faces for the K pass, each with the pixel box
    (u0, v0, u1, v1, inclusive) that holds every pixel its faces can
    reach: the union of their bboxes, widened by the blur `pad` and cut
    to the image. Faces go in order of their box's corner, so a chunk's
    faces lie near each other, and a chunk grows while its faces times
    its box stay within GROUP_ELEMENTS. Faces whose box misses the image
    are dropped."""
    tri = verts_px[faces[big_idx]][..., :2]                   # [n, 3, 2]
    lo = torch.floor(tri.amin(1)).long() - pad
    hi = torch.ceil(tri.amax(1)).long() + pad
    boxes = torch.cat([lo.clamp(min=0), torch.minimum(
        hi, torch.tensor([width - 1, height - 1], device=hi.device))],
        1).cpu().numpy()
    chunks, members, box = [], [], None
    for i in np.lexsort((boxes[:, 0], boxes[:, 1])):
        b = boxes[i]
        if b[2] < b[0] or b[3] < b[1]:
            continue
        grown = b if box is None else np.concatenate(
            [np.minimum(box[:2], b[:2]), np.maximum(box[2:], b[2:])])
        area = int((grown[2] - grown[0] + 1) * (grown[3] - grown[1] + 1))
        if members and (len(members) + 1) * area > GROUP_ELEMENTS:
            chunks.append((members, box))
            members, grown = [], b
        members.append(i)
        box = grown
    if members:
        chunks.append((members, box))
    return chunks


def _rasterize_big_k(verts_px, faces, big_idx, height: int, width: int,
                     k: int, blur_px2: float = 0.0,
                     cull_backfaces: bool = True, z_near: float = 0.1,
                     eps: float = 1e-8):
    """The exact pass over the big faces `big_idx` at K levels, chunk by
    chunk (`_big_face_chunks`), each chunk's fragments merged into the
    running K-buffer by (z, face id) at the pixels it hits: the JAX
    package's scan of two-key sorted inserts over the full image, whose
    top K does not depend on the order of the inserts, and to which a
    pixel no face reaches adds nothing."""
    dev = verts_px.device
    ndc_scale2 = (2.0 / (max(height, width) - 1)) ** 2
    blur_ndc2 = blur_px2 * ndc_scale2
    pad = int(np.ceil(np.sqrt(blur_px2))) if blur_px2 > 0 else 0
    zbuf = torch.full((k, height * width), _INF, device=dev)
    fid = torch.full((k, height * width), _BIG_FID, dtype=torch.long,
                     device=dev)
    for members, (u0, v0, u1, v1) in _big_face_chunks(
            verts_px, faces, big_idx, height, width, pad):
        idx = big_idx[torch.as_tensor(members, device=dev)]
        rows = torch.arange(v0, v1 + 1, device=dev)
        cols = torch.arange(u0, u1 + 1, device=dev)
        lin = (rows[:, None] * width + cols).reshape(-1)
        py, px = torch.meshgrid(rows.float(), cols.float(), indexing="ij")
        u, v, z, _, ok = _face_setup(verts_px, faces[idx], cull_backfaces,
                                     z_near, eps)
        u, v, z = ([a[:, None] for a in corners] for corners in (u, v, z))
        zc, covered, d2, _ = _face_fragment(u, v, z, px.reshape(1, -1),
                                            py.reshape(1, -1), ndc_scale2)
        hit = ok[:, None] & (covered | (d2 < blur_ndc2))
        reached = torch.nonzero(hit.any(0))[:, 0]
        if not reached.numel():
            continue
        at, hit = lin[reached], hit[:, reached]
        zs, fs = _sort2(
            torch.cat([zbuf[:, at], torch.where(hit, zc[:, reached], _INF)]),
            torch.cat([fid[:, at], torch.where(hit, idx[:, None],
                                               _BIG_FID)]), k)
        zbuf[:, at] = zs
        fid[:, at] = fs
    return zbuf, fid


def rasterize_k(verts_px, faces, height: int, width: int,
                faces_per_pixel: int = 1, foot: int = 8,
                blur_radius: float = 0.0, cull_backfaces: bool = True,
                z_near: float = 0.1) -> KRasterOut:
    """Rasterize to the top-K fragments per pixel (PyTorch3D
    faces_per_pixel semantics, reference: pytorch3d_renderer.py:31-53).

    blur_radius is in NDC^2 units (PyTorch3D's convention): a face whose
    signed squared edge distance at a pixel is below it also gives a
    fragment, with clipped barycentrics. Fragments are sorted by
    ascending z."""
    verts_px = torch.as_tensor(verts_px, dtype=torch.float32)
    dev = verts_px.device
    faces = torch.as_tensor(faces, device=dev).long()
    k = int(faces_per_pixel)
    ndc_scale2 = (2.0 / (max(height, width) - 1)) ** 2
    blur_px2 = float(blur_radius) / ndc_scale2 if blur_radius > 0 else 0.0
    pad = int(np.ceil(np.sqrt(blur_px2))) if blur_px2 > 0 else 0

    tri = verts_px[faces]
    du = tri[..., 0].amax(1) - tri[..., 0].amin(1) + 2 * pad
    dv = tri[..., 1].amax(1) - tri[..., 1].amin(1) + 2 * pad
    is_big = torch.maximum(du, dv) > foot - 1
    z_lv, fid_lv = _rasterize_small_k(
        verts_px, faces, ~is_big, height, width, foot=foot, k=k,
        blur_px2=blur_px2, cull_backfaces=cull_backfaces, z_near=z_near)
    big_idx = torch.nonzero(is_big)[:, 0]
    if big_idx.numel():
        z_big, fid_big = _rasterize_big_k(
            verts_px, faces, big_idx, height, width, k=k, blur_px2=blur_px2,
            cull_backfaces=cull_backfaces, z_near=z_near)
        z_lv, fid_lv = _sort2(torch.cat([z_lv, z_big]),
                              torch.cat([fid_lv, fid_big]), k)

    face_id = torch.where(z_lv < _INF, fid_lv, -1).reshape(k, height, width)
    zbuf = z_lv.reshape(k, height, width)

    # each level's fragment quantities, recomputed from its winning face
    py, px = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    tri_lv = tri[face_id.clamp(min=0)]                    # [K, H, W, 3, 3]
    u, v, z = ([tri_lv[..., i, c] for i in range(3)] for c in range(3))
    _, _, d2, bary = _face_fragment(u, v, z, px, py, ndc_scale2)
    empty = face_id < 0
    bary = torch.where(empty[..., None], 0.0, torch.stack(bary, dim=-1))
    d2 = torch.where(empty, _INF, d2)
    return KRasterOut(face_id=face_id, bary=bary, zbuf=zbuf, dists=d2)


def sigmoid_alpha_blend(kraster: KRasterOut, sigma: float = 1e-4
                        ) -> torch.Tensor:
    """Soft coverage alpha [H, W] (PyTorch3D sigmoid_alpha_blend: the
    channels stay the closest fragment's; only alpha is soft)."""
    prob = torch.sigmoid(-kraster.dists / sigma)
    prob = torch.where(kraster.face_id >= 0, prob, 0.0)
    return 1.0 - torch.prod(1.0 - prob, dim=0)


def softmax_blend_weights(kraster: KRasterOut, sigma: float = 1e-4,
                          gamma: float = 1e-4, znear: float = 1.0,
                          zfar: float = 100.0, eps: float = 1e-10):
    """PyTorch3D softmax (gamma) blending weights, the weight math of
    softmax_rgb_blend: coverage probability sigmoid(-dist / sigma), depth
    weight exp(z_inv / gamma) against the running max, and a background
    weight exp((eps - z_inv_max) / gamma). Elementwise fp32.

    Returns (weights [K, H, W], bg_weight [H, W], alpha [H, W]) with
    weights.sum(0) + bg_weight == 1; a channel blends as
    (weights[..., None] * attr_k).sum(0) + bg_weight[..., None] *
    background."""
    mask = kraster.face_id >= 0
    prob = torch.where(mask, torch.sigmoid(-kraster.dists / sigma), 0.0)
    alpha = 1.0 - torch.prod(1.0 - prob, dim=0)
    z_inv = torch.where(mask, (zfar - kraster.zbuf) / (zfar - znear), 0.0)
    z_inv_max = torch.clamp(z_inv.amax(0), min=eps)
    weights_num = prob * torch.exp((z_inv - z_inv_max) / gamma)
    delta = torch.exp((eps - z_inv_max) / gamma)
    denom = weights_num.sum(0) + delta
    return weights_num / denom, delta / denom, alpha


def interpolate_attribute_k(kraster: KRasterOut, faces, vert_attr
                            ) -> torch.Tensor:
    """Barycentric interpolation of a per-vertex attribute [V, C] at every
    fragment level: [K, H, W, C] (0 where the level is empty)."""
    dev = kraster.face_id.device
    faces = torch.as_tensor(faces, device=dev).long()
    vert_attr = torch.as_tensor(vert_attr, dtype=torch.float32, device=dev)
    tri_attr = vert_attr[faces[kraster.face_id.clamp(min=0)]]
    b = kraster.bary[..., None]                          # [K, H, W, 3, 1]
    out = (b[..., 0, :] * tri_attr[..., 0, :] + b[..., 1, :]
           * tri_attr[..., 1, :] + b[..., 2, :] * tri_attr[..., 2, :])
    return torch.where((kraster.face_id >= 0)[..., None], out, 0.0)
