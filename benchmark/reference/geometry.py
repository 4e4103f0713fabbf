"""Plain PyTorch reference of the point-cloud depth transform.

The published algorithm (DiffusionHandles' depth_transform.py, point-cloud
mode): lift the depth map to 3D points through pinhole intrinsics, rotate
the foreground points about their centroid (Rodrigues) and translate them,
z-buffer splat background then foreground points (a tie goes to the
earlier point), normalise the disparity to [0, 255], clean the foreground
mask with an elliptic close then open (OpenCV's border rules), and
Laplace-inpaint the pixels the cleanup changed by conjugate gradients.
Returns the edited disparity and the [N, 4] correspondences (orig x, orig
y, new x, new y) of the visible foreground pixels inside the cleaned mask.

`dtype` is the precision of the lift, the transform, the projection and
the normalisation: float32 as published, or a lower one for the check's
control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def pinhole_intrinsics(fov_deg: float = 55.0) -> np.ndarray:
    """Intrinsics of a [-1, 1]^2 image plane with the given field of
    view."""
    f = 1.0 / np.tan(0.5 * fov_deg * (np.pi / 180.0))
    return np.array([[f, 0.0, 0.0], [0.0, f, 0.0], [0.0, 0.0, 1.0]],
                    dtype=np.float32)


def normalize_disparity(depth, bounds=None):
    """255 * (d - min) / (max - min) over the whole map."""
    if bounds is None:
        bounds = (depth.amin(), depth.amax())
    lo, hi = bounds
    return 255.0 * (depth - lo) / (hi - lo)


def _lift(depth, k_inv, dtype):
    """[H, W] depth -> [H, W, 3] points, x and y flipped (camera frame)."""
    h, w = depth.shape
    nw = (w - 1) / (max(w, h) - 1)
    nh = (h - 1) / (max(w, h) - 1)
    dev = depth.device
    x = torch.linspace(-nw, nw, w, dtype=torch.float32, device=dev)
    y = torch.linspace(-nh, nh, h, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    coord = torch.stack([xx, yy, torch.ones_like(xx)], -1).to(dtype)
    ray = (coord[..., 0:1] * k_inv[:, 0] + coord[..., 1:2] * k_inv[:, 1]
           + coord[..., 2:3] * k_inv[:, 2])
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=dtype, device=dev)
    return depth[..., None] * ray * flip


def _rotate(points, axis, angle_deg: float):
    axis = axis / torch.linalg.norm(axis)
    a = math.radians(angle_deg)
    c = torch.tensor(math.cos(a), dtype=points.dtype, device=points.device)
    s = torch.tensor(math.sin(a), dtype=points.dtype, device=points.device)
    return (points * c + torch.linalg.cross(axis.expand_as(points), points)
            * s + axis * (points * axis).sum(-1, keepdim=True) * (1 - c))


def _splat(points, intrinsics, res: int, point_mask, valid):
    """Project and z-buffer [N, 3] points onto a res x res grid. Returns
    (min z per pixel, foreground winner mask [res, res], u, v, visible)."""
    n = points.shape[0]
    dev = points.device
    flip = torch.tensor([-1.0, -1.0, 1.0], dtype=points.dtype, device=dev)
    pts = points * flip
    proj = pts @ intrinsics.to(points.dtype).T
    m = res - 1
    u = proj[:, 0] / proj[:, 2] * 0.5 * m + m / 2.0
    v = proj[:, 1] / proj[:, 2] * 0.5 * m + m / 2.0
    u = torch.round(torch.clamp(u.float(), 0, m)).long()
    v = torch.round(torch.clamp(v.float(), 0, m)).long()
    z = torch.where(valid, pts[:, 2].float(),
                    torch.full((n,), torch.inf, device=dev))
    lin = v * res + u
    zmin = torch.full((res * res,), torch.inf, device=dev).scatter_reduce(
        0, lin, z, reduce="amin")
    idx = torch.arange(n, device=dev)
    cand = torch.where(valid & (z == zmin[lin]), idx,
                       torch.full_like(idx, n))
    winner = torch.full((res * res,), n, dtype=torch.long,
                        device=dev).scatter_reduce(0, lin, cand,
                                                   reduce="amin")
    has = winner < n
    fg_win = (has & point_mask[torch.where(has, winner, 0)]).reshape(res,
                                                                     res)
    visible = (winner[lin] == idx) & point_mask
    return zmin.reshape(res, res), fg_win, u, v, visible


def ellipse(ksize: int) -> torch.Tensor:
    """OpenCV's MORPH_ELLIPSE structuring element of size ksize."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    se = np.zeros((ksize, ksize), np.float32)
    for i in range(ksize):
        dy = i - r
        if abs(dy) <= r:
            dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
            se[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1.0
    return torch.from_numpy(se)


def _hits(mask, se, pad_value: float):
    kh, kw = se.shape
    ay, ax = kh // 2, kw // 2
    padded = F.pad(mask.float()[None, None],
                   (ax, kw - 1 - ax, ay, kh - 1 - ay), value=pad_value)
    return F.conv2d(padded, se.to(mask.device)[None, None])[0, 0]


def dilate(mask, se):
    return _hits(mask, se, 0.0) > 0.5


def erode(mask, se):
    return _hits(mask, se, 1.0) > float(se.sum()) - 0.5


def laplace_inpaint(image, mask, maxiter: int = 2000, tol: float = 1e-6):
    """Replace the masked pixels by the solution of the 5-point Laplace
    equation with the other pixels fixed (zero outside the image), by
    conjugate gradients to a relative squared residual of `tol`."""
    image = image.float()
    m = mask.float()
    known = image * (1.0 - m)

    def nsum(x):
        p = F.pad(x[None, None], (1, 1, 1, 1))[0, 0]
        return p[2:, 1:-1] + p[:-2, 1:-1] + p[1:-1, 2:] + p[1:-1, :-2]

    def matvec(x):
        return m * (4.0 * x - nsum(m * x))

    b = m * nsum(known)
    x = torch.zeros_like(image)
    r = b.clone()
    p = r
    rs = torch.dot(r.flatten(), r.flatten())
    thresh = tol * rs
    for _ in range(maxiter):
        if not bool(rs > thresh):
            break
        ap = matvec(p)
        alpha = rs / (torch.dot(p.flatten(), ap.flatten()) + 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r.flatten(), r.flatten())
        p = r + rs_new / (rs + 1e-30) * p
        rs = rs_new
    return known + m * x


def transform_depth_pc(depth, bg_depth, fg_mask, rot_angle: float,
                       rot_axis, translation, device,
                       dtype=torch.float32):
    """depth, bg_depth, fg_mask: [1, 1, H, W] numpy (H == W). Returns
    (edited disparity [1, 1, H, W] float32 tensor, correspondences [N, 4]
    int64 numpy)."""
    res = int(np.shape(depth)[-1])
    intr = torch.as_tensor(pinhole_intrinsics(), device=device)
    k_inv = torch.linalg.inv(intr.cpu()).to(device).to(dtype)
    d = torch.as_tensor(np.asarray(depth, np.float32).reshape(res, res),
                        device=device)
    bg = torch.as_tensor(np.asarray(bg_depth, np.float32).reshape(res, res),
                         device=device)
    fg = torch.as_tensor(np.asarray(fg_mask, np.float32).reshape(res, res),
                         device=device) > 0.5
    bg_pts = _lift(bg.to(dtype), k_inv, dtype).reshape(-1, 3)
    pts = _lift(d.to(dtype), k_inv, dtype).reshape(-1, 3)
    fg_flat = fg.reshape(-1)
    w = fg_flat.to(dtype)[:, None]
    centroid = (pts * w).sum(0) / torch.clamp(w.sum(), min=1e-12)
    axis = torch.as_tensor(np.asarray(rot_axis, np.float32), device=device)
    moved = (_rotate(pts - centroid, axis.to(dtype), float(rot_angle))
             + centroid + torch.as_tensor(np.asarray(translation,
                                                     np.float32),
                                          device=device).to(dtype))
    n = res * res
    points = torch.cat([bg_pts, moved])
    zeros = torch.zeros(n, dtype=torch.bool, device=device)
    zmin, fg_win, u, v, visible = _splat(points, intr, res,
                                         torch.cat([zeros, fg_flat]),
                                         torch.cat([~zeros, fg_flat]))
    disparity = normalize_disparity(1.0 / zmin)
    cleaned = erode(dilate(fg_win, ellipse(max(1, res // 50))),
                    ellipse(max(1, res // 50)))
    cleaned = dilate(erode(cleaned, ellipse(max(1, res // 250))),
                     ellipse(max(1, res // 250)))
    inpainted = laplace_inpaint(disparity, fg_win ^ cleaned)
    src = torch.nonzero(fg_flat)[:, 0]
    u, v, vis = u[n:][src], v[n:][src], visible[n:][src]
    keep = vis & cleaned[v, u]
    src = src[keep]
    corr = torch.stack([src % res, src // res, u[keep], v[keep]], -1)
    return inpainted[None, None].float(), corr.cpu().numpy().astype(np.int64)


def depth_transform(mode: str):
    """The reference's depth transform of a configuration's
    `depth_transform_mode`: `transform_depth_<mode>` of this module or of
    `reference/depth_<mode>.py`, with transform_depth_pc's arguments and
    returns. Raises ValueError where the reference has none."""
    import importlib
    fn = globals().get(f"transform_depth_{mode}")
    if fn is None:
        try:
            mod = importlib.import_module(f"benchmark.reference.depth_{mode}")
        except ModuleNotFoundError:
            mod = None
        fn = getattr(mod, f"transform_depth_{mode}", None)
    if fn is None:
        raise ValueError(f"the reference has no depth transform {mode!r}")
    return fn
