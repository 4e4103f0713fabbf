"""Guidance energies and weight schedules for guided denoising.

The counterpart of the JAX package's `guidance.py` (reference:
diffhandles/losses.py and guided_stable_diffuser.py:335-373, 490-665).
Correspondences are fixed-size weighted slots on the latent grid, binned
either on the host from packed [N, 4] rows (`process_correspondences`) or
on the device from the splat (`process_correspondences_device`);
background masks are dense [L, L] grids. Activation maps here are a single
image's [C, H, W] (this package is NCHW; the JAX package's are [H, W, C]).
Each loss is split into a latent-independent precompute (run once per
denoising step) and the apply half that the guidance gradient differentiates.
On a CUDA device the foreground term's L1 and its gradient run as a kernel
pair (`ops/fg_loss.py`) over the live slots sorted by transformed cell
(`fg_slot_order`, built once per edit); on the CPU they are plain PyTorch
indexing.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from diffusionhandles_tpu_torch.ops.fg_loss import fg_l1
from diffusionhandles_tpu_torch.ops.resize import resize_hw
from diffusionhandles_tpu_torch.utils.cuda_build import route
from diffusionhandles_tpu_torch.utils.device import resolve_device
from diffusionhandles_tpu_torch.utils.profiling import span

EPS = 1e-10  # reference: losses.py:75

# Foreground-term applications by route since the process started (tracing
# off too): "kernel" the card's kernel pair, "plain" the CPU's indexing.
FG_LOSS_CALLS = {"kernel": 0, "plain": 0}


class ProcessedCorrespondences(NamedTuple):
    """corr_*: [max_corr] (orig, trans) latent-cell pairs with multiplicity
    weights (weight 0 = empty slot); bg_mask_*: [L, L] float {0, 1} grids
    of cells not covered by the orig / trans foreground (and both)."""

    corr_ox: torch.Tensor
    corr_oy: torch.Tensor
    corr_tx: torch.Tensor
    corr_ty: torch.Tensor
    corr_w: torch.Tensor
    bg_mask_orig: torch.Tensor
    bg_mask_trans: torch.Tensor
    bg_mask_both: torch.Tensor


def process_correspondences(correspondences, img_res: int,
                            bg_erosion: int = 0, max_corr: int = 16384,
                            latent_res: int = 64, device=None
                            ) -> ProcessedCorrespondences:
    """Bin packed [N, 4] (orig_x, orig_y, trans_x, trans_y) image-pixel
    correspondences onto the latent grid on the host, then place the
    fixed-size result on `device` (default: the GPU) (reference:
    guided_stable_diffuser.py:490-584).

    Rows whose transformed pixel lies outside the image are dropped;
    duplicated (orig-cell, trans-cell) pairs merge into multiplicity
    weights. With more than max_corr distinct pairs the highest-count ones
    are kept, with a warning."""
    device = resolve_device(device)
    correspondences = np.asarray(correspondences).reshape(-1, 4)
    ox, oy, tx, ty = (correspondences[:, 0], correspondences[:, 1],
                      correspondences[:, 2], correspondences[:, 3])
    visible = (tx >= 0) & (tx < img_res) & (ty >= 0) & (ty < img_res)
    ox, oy, tx, ty = ox[visible], oy[visible], tx[visible], ty[visible]
    scale = img_res // latent_res
    ox, oy, tx, ty = ox // scale, oy // scale, tx // scale, ty // scale

    key = ((oy * latent_res + ox) * latent_res + ty) * latent_res + tx
    uniq, counts = np.unique(key, return_counts=True)
    if len(uniq) > max_corr:
        order = np.argsort(-counts)[:max_corr]
        warnings.warn(
            f"truncating {len(uniq)} correspondence pairs to {max_corr} "
            f"(dropped weight "
            f"{counts.sum() - counts[order].sum()}/{counts.sum()})")
        uniq, counts = uniq[order], counts[order]
    fields = (uniq // (latent_res ** 3), (uniq // (latent_res ** 2))
              % latent_res, (uniq // latent_res) % latent_res,
              uniq % latent_res)
    slots = np.zeros((5, max_corr), np.int64)
    for row, a in zip(slots, fields + (counts,)):
        row[:len(a)] = a
    uoy, uox, uty, utx, w = slots

    bg_orig = np.ones((latent_res, latent_res), bool)
    bg_trans = np.ones((latent_res, latent_res), bool)
    if len(ox):
        bg_orig[oy, ox] = False
        bg_trans[ty, tx] = False
    if bg_erosion > 0:
        import scipy.ndimage
        bg_orig = scipy.ndimage.binary_erosion(bg_orig,
                                               iterations=bg_erosion)
        bg_trans = scipy.ndimage.binary_erosion(bg_trans,
                                                iterations=bg_erosion)

    def on(a, dtype=torch.long):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return ProcessedCorrespondences(
        corr_ox=on(uox), corr_oy=on(uoy), corr_tx=on(utx), corr_ty=on(uty),
        corr_w=on(w, torch.float32),
        bg_mask_orig=on(bg_orig, torch.float32),
        bg_mask_trans=on(bg_trans, torch.float32),
        bg_mask_both=on(bg_orig & bg_trans, torch.float32))


def _erode_cross(mask: torch.Tensor) -> torch.Tensor:
    """One binary erosion with the 3x3 cross and a zero border (scipy's
    binary_erosion defaults)."""
    p = F.pad(mask[None, None], (1, 1, 1, 1))[0, 0]
    return (mask * p[:-2, 1:-1] * p[2:, 1:-1] * p[1:-1, :-2]
            * p[1:-1, 2:])


def process_correspondences_device(u, v, visible, cleaned, fg,
                                   img_res: int, bg_erosion: int = 0,
                                   max_corr: int = 16384,
                                   latent_res: int = 64
                                   ) -> ProcessedCorrespondences:
    """Bin the splat's foreground correspondences onto the latent grid and
    build the background masks, without leaving the device
    (reference: depth_transform.py:299-336 + guided_stable_diffuser.py:
    490-584).

    u, v, visible: [img_res^2] — the winning pixel and visibility of each
    foreground-slot point, raster order over original pixels; cleaned:
    [img_res, img_res] bool target mask; fg: foreground mask (> 0.5).
    With more than max_corr distinct pairs the lowest keys are kept (as in
    the JAX package)."""
    L = latent_res
    dev = u.device
    n = img_res * img_res
    idx = torch.arange(n, device=dev)
    oy, ox = idx // img_res, idx % img_res
    fg_flat = fg.reshape(-1).float() > 0.5
    u = u.long()
    v = v.long()
    keep = fg_flat & visible.bool() & cleaned.reshape(-1)[v * img_res + u]
    scale = img_res // latent_res
    oxl, oyl = ox // scale, oy // scale
    txl, tyl = u // scale, v // scale
    key = ((oyl * L + oxl) * L + tyl) * L + txl
    sentinel = L ** 4
    key = torch.where(keep, key, torch.full_like(key, sentinel))
    with span("sync.correspondence_unique"):
        uniq, counts = torch.unique(key, return_counts=True)
    # the fixed-size unique of the JAX package: max_corr + 1 sorted slots,
    # padded with the sentinel
    size = max_corr + 1
    uniq = F.pad(uniq[:size], (0, max(0, size - uniq.numel())),
                 value=sentinel)[:max_corr]
    counts = F.pad(counts[:size], (0, max(0, size - counts.numel())))[
        :max_corr]
    live = uniq != sentinel
    w = torch.where(live, counts, torch.zeros_like(counts)).float()
    uniq = torch.where(live, uniq, torch.zeros_like(uniq))
    utx = uniq % L
    uty = (uniq // L) % L
    uox = (uniq // (L * L)) % L
    uoy = uniq // (L ** 3)

    km = torch.where(keep, 0.0, 1.0)
    ones = torch.ones(L * L, device=dev)
    bg_orig = ones.scatter_reduce(0, oyl * L + oxl, km,
                                  reduce="amin").reshape(L, L)
    bg_trans = ones.scatter_reduce(0, tyl * L + txl, km,
                                   reduce="amin").reshape(L, L)
    for _ in range(bg_erosion):
        bg_orig = _erode_cross(bg_orig)
        bg_trans = _erode_cross(bg_trans)
    return ProcessedCorrespondences(
        corr_ox=uox, corr_oy=uoy, corr_tx=utx, corr_ty=uty, corr_w=w,
        bg_mask_orig=bg_orig, bg_mask_trans=bg_trans,
        bg_mask_both=bg_orig * bg_trans)


def _avg_pool_same(x: torch.Tensor, patch_size: int) -> torch.Tensor:
    """AvgPool2d(patch, stride 1, padding patch//2, count_include_pad) on
    [C, H, W] (reference: losses.py:64)."""
    if patch_size == 1:
        return x
    pad = patch_size // 2
    rest = patch_size - 1 - pad
    padded = F.pad(x[None], (pad, rest, pad, rest))
    return F.avg_pool2d(padded, patch_size, stride=1)[0]


def _to_chw(activation: torch.Tensor, size) -> torch.Tensor:
    """Bilinear-resize a [C, H, W] map to `size`, fp32 (reference:
    losses.py:8-9,23-24)."""
    return resize_hw(activation.float(), size, "bilinear")


def _scatter_max_grid(iy, ix, values, size) -> torch.Tensor:
    h, w = size
    grid = torch.zeros(h * w, device=values.device)
    return grid.scatter_reduce(0, iy * w + ix, values,
                               reduce="amax").reshape(h, w)


class FgSlotOrder(NamedTuple):
    """The live correspondence slots sorted stably by transformed cell, for
    the foreground term's kernel pair; every field has a fixed size.

    slots: [max_corr] int64, the live slots' indices by cell, then the empty
    ones; cells, weights: [max_corr] int32 / fp32, each sorted slot's
    transformed cell ty * W + tx and weight (0 for an empty slot); offsets:
    [H*W + 1] int32, cell k's run of sorted slots at [offsets[k],
    offsets[k + 1]), offsets[H*W] the live count."""

    slots: torch.Tensor
    cells: torch.Tensor
    weights: torch.Tensor
    offsets: torch.Tensor


def fg_slot_order(pc: ProcessedCorrespondences, activations_size
                  ) -> FgSlotOrder:
    """The slot order of `pc` on an activations grid of `activations_size`
    (H, W), on pc's device with no host sync: once per edit, where the
    correspondences are settled."""
    h, w = activations_size
    live = pc.corr_w > 0
    cell = pc.corr_ty * w + pc.corr_tx
    key = torch.where(live, cell, torch.full_like(cell, h * w))
    key, slots = torch.sort(key, stable=True)
    bounds = torch.arange(h * w + 1, device=key.device, dtype=key.dtype)
    offsets = torch.searchsorted(key, bounds).int()
    live = key < h * w
    return FgSlotOrder(
        slots=slots, cells=torch.where(live, key, 0).int(),
        weights=torch.where(live, pc.corr_w[slots], 0.0),
        offsets=offsets)


def foreground_orig_precompute(activations_orig, pc: ProcessedCorrespondences,
                               patch_size: int, activations_size,
                               order: Optional[FgSlotOrder] = None):
    """Latent-independent half of the foreground loss: the pooled ORIG
    features at the orig cells, the w2 scatter grid and its pooling
    denominator. On the CPU the features are [max_corr, C] in pc's slot
    order and `order` is not read; on a CUDA device they are [C, max_corr]
    in `order` (`fg_slot_order`, built here when not passed), which ends
    the tuple."""
    f_orig = _to_chw(activations_orig, activations_size)
    valid = (pc.corr_w > 0).float()
    w1 = _scatter_max_grid(pc.corr_oy, pc.corr_ox, valid, activations_size)
    w2 = _scatter_max_grid(pc.corr_ty, pc.corr_tx, valid, activations_size)
    f1 = _avg_pool_same(w1[None] * f_orig, patch_size) / (
        _avg_pool_same(w1[None], patch_size) + EPS)
    w2_den = _avg_pool_same(w2[None], patch_size)
    if route(f1.device, True) == "cpu":
        return f1[:, pc.corr_oy, pc.corr_ox].T, w2, w2_den
    if order is None:
        order = fg_slot_order(pc, activations_size)
    f1_slots = f1[:, pc.corr_oy[order.slots], pc.corr_ox[order.slots]]
    return f1_slots.contiguous(), w2, w2_den, order


def foreground_loss_apply(pre, activations, pc: ProcessedCorrespondences,
                          patch_size: int, activations_size):
    """Weighted local-average L1 between the orig features at the orig
    cells and the current features at the transformed cells (`pre` from
    `foreground_orig_precompute` on the same device)."""
    f1_gathered, w2, w2_den = pre[:3]
    f_cur = _to_chw(activations, activations_size)
    f2 = _avg_pool_same(w2[None] * f_cur, patch_size) / (w2_den + EPS)
    total = pc.corr_w.sum()
    if route(f2.device, True) == "cpu":
        FG_LOSS_CALLS["plain"] += 1
        d = (f1_gathered - f2[:, pc.corr_ty, pc.corr_tx].T).abs()
        per_channel = (d * pc.corr_w[:, None]).sum(0) / (total + EPS)
    else:
        FG_LOSS_CALLS["kernel"] += 1
        order = pre[3]
        per_channel = fg_l1(f2, f1_gathered, order.cells, order.weights,
                            order.offsets) / (total + EPS)
    return per_channel.mean()


def foreground_loss(activations, activations_orig,
                    pc: ProcessedCorrespondences, patch_size: int,
                    activations_size, order: Optional[FgSlotOrder] = None):
    """Weighted local-average L1 between the orig features at the orig
    cells and the current features at the transformed cells (reference:
    losses.py:4-17,51-84); activations [C, H, W]."""
    pre = foreground_orig_precompute(activations_orig, pc, patch_size,
                                     activations_size, order)
    return foreground_loss_apply(pre, activations, pc, patch_size,
                                 activations_size)


def background_orig_precompute(activations_orig,
                               pc: ProcessedCorrespondences,
                               patch_size: int, activations_size,
                               loss_type: str = "global_avg"):
    """Latent-independent half of the background loss."""
    f_orig = _to_chw(activations_orig, activations_size)
    if loss_type == "global_avg":
        m1 = pc.bg_mask_orig[None]
        return ((f_orig * m1).sum((1, 2)) / (m1.sum() + EPS),)
    if loss_type == "local_avg":
        m = pc.bg_mask_both[None]
        m_den = _avg_pool_same(m, patch_size)
        return (_avg_pool_same(m * f_orig, patch_size) / (m_den + EPS),
                m_den)
    raise ValueError(f"Unknown background loss type: {loss_type}")


def background_loss_apply(pre, activations, pc: ProcessedCorrespondences,
                          patch_size: int, activations_size,
                          loss_type: str = "global_avg"):
    """Background preservation loss, current side (reference:
    losses.py:19-49)."""
    f_cur = _to_chw(activations, activations_size)
    if loss_type == "global_avg":
        (mean1,) = pre
        m2 = pc.bg_mask_trans[None]
        mean2 = (f_cur * m2).sum((1, 2)) / (m2.sum() + EPS)
        return (mean1 - mean2).abs().mean()
    if loss_type == "local_avg":
        f1, m_den = pre
        m = pc.bg_mask_both[None]
        f2 = _avg_pool_same(m * f_cur, patch_size) / (m_den + EPS)
        d = (f1 - f2).abs() * m
        return (d.sum((1, 2)) / (m.sum() + EPS)).mean()
    raise ValueError(f"Unknown background loss type: {loss_type}")


def background_loss(activations, activations_orig,
                    pc: ProcessedCorrespondences, patch_size: int,
                    activations_size, loss_type: str = "global_avg"):
    """Background preservation loss (reference: losses.py:19-49)."""
    pre = background_orig_precompute(activations_orig, pc, patch_size,
                                     activations_size, loss_type)
    return background_loss_apply(pre, activations, pc, patch_size,
                                 activations_size, loss_type)


def build_guidance_weight_schedule(fg_weight: float, bg_weight: float,
                                   guidance_max_step: int, num_steps: int,
                                   num_optsteps: int,
                                   schedule_type: str = "constant"):
    """fg/bg guidance weights as float32 [num_steps, num_optsteps, 3]
    arrays: falloff x cyclic layer weights x per-iteration weights
    (reference: guided_stable_diffuser.py:335-373, 622-665), zero from
    guidance_max_step on."""
    fg_weight = fg_weight * 30.0
    bg_weight = bg_weight * 30.0
    gms = guidance_max_step
    if schedule_type == "constant":
        fg_fall = np.full(gms, fg_weight)
        bg_fall = np.full(gms, bg_weight)
    elif schedule_type == "linear":
        fg_fall = np.linspace(fg_weight, 0.0, gms)
        bg_fall = np.linspace(bg_weight, 0.0, gms)
    elif schedule_type == "quadratic":
        fg_fall = np.linspace(np.sqrt(fg_weight), 0.0, gms) ** 2
        bg_fall = np.linspace(np.sqrt(bg_weight), 0.0, gms) ** 2
    else:
        raise ValueError(f"Unknown guidance schedule type: {schedule_type}")
    cyc_fg = np.array([[0.0, 0.0, 7.5], [0.0, 5.0, 0.0], [0.0, 5.0, 7.5]])
    cyc_bg = np.array([[0.0, 0.0, 1.5], [0.0, 1.5, 0.0], [0.0, 1.5, 1.5]])
    opt_fg = np.array([[2.5] * 3, [1.25] * 3, [1.25] * 3])
    opt_bg = np.array([[1.25] * 3, [2.5] * 3, [1.25] * 3])
    if num_optsteps > 3:
        extra = num_optsteps - 3
        opt_fg = np.concatenate([opt_fg, np.tile([[2.5] * 3], (extra, 1))])
        opt_bg = np.concatenate([opt_bg, np.tile([[2.5] * 3], (extra, 1))])
    opt_fg = opt_fg[:num_optsteps]
    opt_bg = opt_bg[:num_optsteps]
    fg = np.zeros((num_steps, num_optsteps, 3), np.float32)
    bg = np.zeros((num_steps, num_optsteps, 3), np.float32)
    for t in range(min(gms, num_steps)):
        dfg = cyc_fg[t % 3] * fg_fall[t]
        dbg = cyc_bg[t % 3] * bg_fall[t]
        for it in range(num_optsteps):
            fg[t, it] = dfg * opt_fg[it]
            bg[t, it] = dbg * opt_bg[it]
    return fg, bg
