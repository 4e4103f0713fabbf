"""Depth <-> 3D lifting and z-buffer splatting.

The counterpart of the JAX package's `geometry/depth.py` (reference:
diffhandles/depth_transform.py). The reference's sequential z-buffer loop
becomes a two-pass scatter-min whose result is the loop's final state:
    winner(p)  = lowest-index point attaining the min z at pixel p
    depth(p)   = that min z (inf where no point lands)
    visible    = {i : winner(p_i) == i and point_mask[i]}
    depth_mask = point_mask[winner(p)]
The second pass takes the min of point INDICES among the points attaining
the min z, so a tie goes to the first point whatever order the scatter
visits them in (the reference's strict '<' keeps the earliest arrival).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from diffusionhandles_tpu_torch.utils.profiling import span


def normalize_depth(depth: torch.Tensor, bounds=None,
                    return_bounds: bool = False):
    """Normalize a 4D depth to [0, 255] per batch element
    (reference: depth_transform.py:15-28)."""
    depth = depth.float()
    if depth.ndim != 4:
        raise RuntimeError(
            f"Expected depth to have 4 dimensions, got {depth.ndim}")
    if bounds is None:
        flat = depth.reshape(depth.shape[0], -1)
        max_d = flat.amax(dim=-1)[:, None, None, None]
        min_d = flat.amin(dim=-1)[:, None, None, None]
    else:
        min_d, max_d = bounds
    out = 255.0 * (depth - min_d) / (max_d - min_d)
    if return_bounds:
        return out, (min_d, max_d)
    return out


def image_plane_coords(height: int, width: int, device=None) -> torch.Tensor:
    """Normalized [-1,1]^2 pixel-center grid with z = 1, [H, W, 3]."""
    nw = (width - 1) / (max(width, height) - 1)
    nh = (height - 1) / (max(width, height) - 1)
    x = torch.linspace(-nw, nw, width, dtype=torch.float32, device=device)
    y = torch.linspace(-nh, nh, height, dtype=torch.float32, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)


def depth_to_world_coords(depth: torch.Tensor, intrinsics,
                          extrinsics_R=None, extrinsics_t=None
                          ) -> torch.Tensor:
    """[..., H, W] depth -> [H, W, 3] points in the PyTorch3D-style frame
    (M = diag(-1, -1, 1)) (reference: depth_transform.py:589-641), then
    into the world frame when extrinsics are given.

    The 3x3 products are written out elementwise, so no matmul setting
    (TF32) touches them, and the inverse is taken on the host: the card
    and the CPU lift a depth map to the same bits."""
    depth = depth.float()
    depth = depth.reshape(depth.shape[-2], depth.shape[-1])
    h, w = depth.shape
    if h < 2 or w < 2:
        raise RuntimeError(
            f"Expected depth to have at least 2 pixels per dim, got {h}x{w}")
    dev = depth.device
    with span("sync.intrinsics_to_host"):
        k = torch.as_tensor(intrinsics, dtype=torch.float32).cpu()
    k_inv = torch.linalg.inv(k)
    with span("sync.intrinsics_inverse"):
        k_inv = k_inv.to(dev)
    coord = image_plane_coords(h, w, dev)
    pts = depth[..., None] * _mat3_apply(k_inv, coord)
    with span("sync.axis_flip"):
        flip = torch.tensor([-1.0, -1.0, 1.0], device=dev)
    pts = pts * flip
    if extrinsics_R is not None or extrinsics_t is not None:
        rot = (torch.eye(3) if extrinsics_R is None else torch.as_tensor(
            extrinsics_R, dtype=torch.float32)).to(dev)
        t = (torch.zeros(3) if extrinsics_t is None else torch.as_tensor(
            extrinsics_t, dtype=torch.float32)).to(dev)
        pts = _mat3_apply(rot.T, pts - t)
    return pts


def _mat3_apply(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """m @ x over the last axis of x ([..., 3]), as elementwise products
    summed in index order."""
    return (x[..., 0:1] * m[:, 0] + x[..., 1:2] * m[:, 1]
            + x[..., 2:3] * m[:, 2])


class SplatResult(NamedTuple):
    """depth_map [H, W] (inf where empty), depth_mask [H, W] bool,
    winner [H, W] int64 (-1 where empty), u, v [N] int64 pixel coords,
    visible [N] bool."""

    depth_map: torch.Tensor
    depth_mask: torch.Tensor
    winner: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    visible: torch.Tensor


def points_to_depth(points: torch.Tensor, intrinsics: torch.Tensor,
                    output_size: Tuple[int, int], extrinsics_R=None,
                    extrinsics_t=None, point_mask=None,
                    valid=None) -> SplatResult:
    """Project and z-buffer splat [N, 3] points
    (reference: depth_transform.py:643-747, vectorized). `point_mask` marks
    foreground points, `valid` = False entries are ignored.

    With extrinsics, the points are world points and are first taken into
    the camera frame by the inverse of depth_to_world_coords' lift,
    cam = R @ world + t (the reference applies its lift transform both
    ways, which breaks the round trip; as the JAX package, this does not)."""
    h, w = output_size
    points = torch.as_tensor(points).float()
    dev = points.device
    n = points.shape[0]
    if extrinsics_R is not None or extrinsics_t is not None:
        rot = (torch.eye(3) if extrinsics_R is None else torch.as_tensor(
            extrinsics_R, dtype=torch.float32)).to(dev)
        t = (torch.zeros(3) if extrinsics_t is None else torch.as_tensor(
            extrinsics_t, dtype=torch.float32)).to(dev)
        points = _mat3_apply(rot, points) + t
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32,
                                 device=dev)
    point_mask = (torch.zeros(n, dtype=torch.bool, device=dev)
                  if point_mask is None else point_mask.bool())
    valid = (torch.ones(n, dtype=torch.bool, device=dev)
             if valid is None else valid.bool())
    with span("sync.axis_flip"):
        flip = torch.tensor([-1.0, -1.0, 1.0], device=dev)
    pts = points * flip
    proj = torch.einsum("ij,nj->ni", intrinsics.float(), pts)
    u = proj[:, 0] / proj[:, 2]
    v = proj[:, 1] / proj[:, 2]
    m = max(h, w) - 1
    u = u * 0.5 * m + (w - 1) / 2.0
    v = v * 0.5 * m + (h - 1) / 2.0
    u = torch.round(torch.clamp(u, 0, w - 1)).long()
    v = torch.round(torch.clamp(v, 0, h - 1)).long()
    z = torch.where(valid, pts[:, 2], torch.full_like(pts[:, 2], torch.inf))

    lin = v * w + u
    # pass 1: min z per pixel
    zmin = torch.full((h * w,), torch.inf, device=dev).scatter_reduce(
        0, lin, z, reduce="amin")
    # pass 2: min index among the points attaining it (first wins a tie)
    idx = torch.arange(n, device=dev)
    cand = torch.where(valid & (z == zmin[lin]), idx,
                       torch.full_like(idx, n))
    winner = torch.full((h * w,), n, dtype=torch.long,
                        device=dev).scatter_reduce(0, lin, cand,
                                                   reduce="amin")
    has_winner = winner < n
    winner_safe = torch.where(has_winner, winner, torch.zeros_like(winner))
    depth_mask = (has_winner & point_mask[winner_safe]).reshape(h, w)
    winner_out = torch.where(has_winner, winner,
                             torch.full_like(winner, -1)).reshape(h, w)
    visible = (winner[lin] == idx) & point_mask
    return SplatResult(zmin.reshape(h, w), depth_mask, winner_out, u, v,
                       visible)
