"""Plain PyTorch reference of the DiffusionHandles algorithm's pieces.

A clean-room implementation of the published algorithm (diffusers'
DDIMScheduler at the reference's settings, the inverter's closed-form
steps, the activation losses, the correspondence binning and the guidance
weight schedule), independent of the measured program, plus the single
steps that the benchmark's check replays from the program's recorded
state (`guidance_update`, `cfg_update`, `null_text_step`): each is one
step of the published loop, written with plain torch autograd and
`torch.optim.Adam`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F


class RefDDIMSchedule:
    """diffusers DDIMScheduler numerics at the reference settings
    (scaled_linear 0.00085..0.012, leading spacing, eta=0,
    set_alpha_to_one=False, epsilon prediction; reference:
    guided_stable_diffuser.py:31-32) + the inverter's closed-form
    prev/next steps (stable_null_inverter.py:25-43)."""

    def __init__(self, num_inference_steps: int,
                 num_train_timesteps: int = 1000):
        betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5,
                               num_train_timesteps,
                               dtype=torch.float64) ** 2
        self.alphas_cumprod = torch.cumprod(1.0 - betas, dim=0).float()
        self.final_alpha_cumprod = self.alphas_cumprod[0]
        self.ratio = num_train_timesteps // num_inference_steps
        self.timesteps = (np.arange(num_inference_steps)
                          * self.ratio).round()[::-1].astype(np.int64)
        self.num_inference_steps = num_inference_steps

    def _alpha(self, t: int):
        if t >= 0:
            return self.alphas_cumprod[t]
        return self.final_alpha_cumprod

    def step(self, eps, t: int, sample):
        """x_t -> x_{t-ratio} (DDIMScheduler.step, eta=0 == prev_step)."""
        a_t = self._alpha(t)
        a_prev = self._alpha(t - self.ratio)
        x0 = (sample - (1 - a_t) ** 0.5 * eps) / a_t ** 0.5
        return a_prev ** 0.5 * x0 + (1 - a_prev) ** 0.5 * eps

    def next_step(self, eps, t: int, sample):
        """Inversion step (stable_null_inverter.py:35-43): current alpha
        at t-ratio (final for <0), next alpha at t."""
        a_cur = self._alpha(t - self.ratio)
        a_next = self._alpha(t)
        x0 = (sample - (1 - a_cur) ** 0.5 * eps) / a_cur ** 0.5
        return a_next ** 0.5 * x0 + (1 - a_next) ** 0.5 * eps


# ---------------------------------------------------------------------------
# Losses (reference: diffhandles/losses.py, literal semantics)
# ---------------------------------------------------------------------------

def _local_average_feat_l1(f1, f2, x1, y1, x2, y2, patch_size):
    w1 = torch.zeros((f1.shape[-2], f1.shape[-1]), dtype=f1.dtype,
                     device=f1.device)
    w2 = torch.zeros((f2.shape[-2], f2.shape[-1]), dtype=f2.dtype,
                     device=f2.device)
    w1[y1, x1] = 1
    w2[y2, x2] = 1
    pool = torch.nn.AvgPool2d(patch_size, stride=1, padding=patch_size // 2)
    eps = 1e-10
    f1a = pool(w1[None, None] * f1[None]) / (pool(w1[None, None]) + eps)
    f2a = pool(w2[None, None] * f2[None]) / (pool(w2[None, None]) + eps)
    loss = (f1a[0, :, y1, x1] - f2a[0, :, y2, x2]).abs()
    return loss.mean(dim=-1).mean()


def _average_feat_l1(f1, f2, x1, y1, x2, y2):
    return (f1[..., y1, x1].mean(dim=-1)
            - f2[..., y2, x2].mean(dim=-1)).abs().mean()


def process_correspondences(correspondences, img_res: int,
                                   latent_res: int, bg_erosion: int = 0):
    """reference guided_stable_diffuser.py:490-584 (with the reference's
    hardcoded 64 generalized to latent_res)."""
    corr = np.asarray(correspondences).reshape(-1, 4)
    keep = ((corr[:, 2] >= 0) & (corr[:, 2] < img_res)
            & (corr[:, 3] >= 0) & (corr[:, 3] < img_res))
    ox, oy, tx, ty = [corr[keep, i].astype(np.int64) for i in range(4)]
    scale = img_res // latent_res
    ox, oy, tx, ty = ox // scale, oy // scale, tx // scale, ty // scale

    bg_mask_orig = np.ones((latent_res, latent_res), np.bool_)
    if len(ox):
        bg_mask_orig[oy, ox] = False
    bg_mask_trans = np.ones((latent_res, latent_res), np.bool_)
    if len(tx):
        bg_mask_trans[ty, tx] = False
    if bg_erosion > 0:
        import scipy.ndimage
        bg_mask_orig = scipy.ndimage.binary_erosion(
            bg_mask_orig, iterations=bg_erosion)
        bg_mask_trans = scipy.ndimage.binary_erosion(
            bg_mask_trans, iterations=bg_erosion)
    bg_y, bg_x = np.nonzero(bg_mask_orig & bg_mask_trans)
    bg_y_orig, bg_x_orig = np.nonzero(bg_mask_orig)
    bg_y_trans, bg_x_trans = np.nonzero(bg_mask_trans)
    return dict(original_x=ox, original_y=oy, transformed_x=tx,
                transformed_y=ty, background_x=bg_x, background_y=bg_y,
                background_x_orig=bg_x_orig, background_y_orig=bg_y_orig,
                background_x_trans=bg_x_trans, background_y_trans=bg_y_trans)


def foreground_loss(acts, acts_orig, pc, patch_size, act_size):
    """acts/acts_orig: [C, H, W]."""
    f_orig = F.interpolate(acts_orig[None], act_size, mode="bilinear")[0]
    f_cur = F.interpolate(acts[None], act_size, mode="bilinear")[0]
    return _local_average_feat_l1(
        f_orig, f_cur, pc["original_x"], pc["original_y"],
        pc["transformed_x"], pc["transformed_y"], patch_size)


def background_loss(acts, acts_orig, pc, patch_size, act_size,
                           loss_type):
    f_orig = F.interpolate(acts_orig[None], act_size, mode="bilinear")[0]
    f_cur = F.interpolate(acts[None], act_size, mode="bilinear")[0]
    if loss_type == "global_avg":
        return _average_feat_l1(
            f_orig, f_cur, pc["background_x_orig"], pc["background_y_orig"],
            pc["background_x_trans"], pc["background_y_trans"])
    if loss_type == "local_avg":
        return _local_average_feat_l1(
            f_orig, f_cur, pc["background_x"], pc["background_y"],
            pc["background_x"], pc["background_y"], patch_size)
    raise ValueError(loss_type)


class RefWeightSchedule:
    """reference StepGuidanceWeightSchedule (:622-665) built exactly as
    guided_inference builds it (:335-373)."""

    def __init__(self, fg_weight, bg_weight, guidance_max_step,
                 schedule_type):
        fg_weight = fg_weight * 30
        bg_weight = bg_weight * 30
        gms = guidance_max_step
        if schedule_type == "constant":
            fg_fall = np.linspace(fg_weight, fg_weight, gms)
            bg_fall = np.linspace(bg_weight, bg_weight, gms)
        elif schedule_type == "linear":
            fg_fall = np.linspace(fg_weight, 0.0, gms)
            bg_fall = np.linspace(bg_weight, 0.0, gms)
        elif schedule_type == "quadratic":
            fg_fall = np.linspace(np.sqrt(fg_weight), 0.0, gms) ** 2
            bg_fall = np.linspace(np.sqrt(bg_weight), 0.0, gms) ** 2
        else:
            raise ValueError(schedule_type)
        den = []
        for t_idx in range(gms):
            if t_idx % 3 == 0:
                fgw, bgw = [0.0, 0.0, 7.5], [0.0, 0.0, 1.5]
            elif t_idx % 3 == 1:
                fgw, bgw = [0.0, 5.0, 0.0], [0.0, 1.5, 0.0]
            else:
                fgw, bgw = [0.0, 5.0, 7.5], [0.0, 1.5, 1.5]
            den.append((t_idx, (np.array(fgw) * fg_fall[t_idx]).tolist(),
                        (np.array(bgw) * bg_fall[t_idx]).tolist()))
        den.append((gms, [0.0] * 3, [0.0] * 3))
        opt = [(0, [2.5] * 3, [1.25] * 3), (1, [1.25] * 3, [2.5] * 3),
               (2, [1.25] * 3, [1.25] * 3), (3, [2.5] * 3, [2.5] * 3)]
        self.den = den
        self.opt = opt

    def __call__(self, denoising_step, optimization_step):
        for step, fgw, bgw in reversed(self.den):
            if denoising_step >= step:
                dfg, dbg = fgw, bgw
                break
        for step, fgw, bgw in reversed(self.opt):
            if optimization_step >= step:
                ofg, obg = fgw, bgw
                break
        return ([d * o for d, o in zip(dfg, ofg)],
                [d * o for d, o in zip(dbg, obg)])


# ---------------------------------------------------------------------------
# Prompt ids and the seeded start
# ---------------------------------------------------------------------------

def hash_token_ids(text: str, vocab_size: int, max_length: int = 77):
    """The offline stand-in tokenizer of random-weight runs: each word of
    the lower-cased, whitespace-collapsed prompt maps to 1 + the first four
    little-endian bytes of its SHA-256 modulo vocab_size - 3, between a
    begin id (vocab_size - 2) and an end id (vocab_size - 1), padded with
    0 to max_length."""
    words = " ".join(text.split()).lower().split(" ")
    ids = [1 + int.from_bytes(hashlib.sha256(w.encode()).digest()[:4],
                              "little") % (vocab_size - 3)
           for w in words if w]
    ids = ([vocab_size - 2] + ids)[:max_length - 1] + [vocab_size - 1]
    return ids + [0] * (max_length - len(ids))


def seeded_start_latents(sched: RefDDIMSchedule, shape, seed: int,
                         device) -> torch.Tensor:
    """Zeros noised to the first timestep with noise from a seeded CPU
    generator (the published pipeline's start of a generation)."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    noise = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    a = sched.alphas_cumprod[int(sched.timesteps[0])]
    return ((1 - a) ** 0.5 * noise).to(device)


def init_depth(depth, latent_res: int):
    """[B,1,H,W] disparity -> [B,1,h,w] bicubic, normalized to [-1,1] per
    image."""
    d = F.interpolate(depth.float(), size=(latent_res, latent_res),
                      mode="bicubic", align_corners=False)
    dmin = d.amin(dim=[1, 2, 3], keepdim=True)
    dmax = d.amax(dim=[1, 2, 3], keepdim=True)
    return 2.0 * (d - dmin) / (dmax - dmin) - 1.0


# ---------------------------------------------------------------------------
# Single steps of the published loops
# ---------------------------------------------------------------------------

def unet_input(latents, depth64):
    return torch.cat([latents, depth64.expand(latents.shape[0], -1, -1,
                                              -1)], dim=1)


def _t(t: int, device) -> torch.Tensor:
    return torch.tensor(int(t), device=device)


def cfg_update(unet, sched: RefDDIMSchedule, latents, depth64, t: int,
               uncond, cond, guidance_scale: float):
    """One classifier-free-guidance DDIM step of latents [B,4,h,w] (depth64
    [B,1,h,w]; uncond, cond [1,77,D]) with one batch-2B pass, context
    [uncond x B, cond x B]. Returns (next latents, the cond rows'
    activations)."""
    b = latents.shape[0]
    with torch.no_grad():
        lat2 = torch.cat([latents, latents]).float()
        ctx = torch.cat([uncond.expand(b, -1, -1), cond.expand(b, -1, -1)])
        eps, acts = unet(unet_input(lat2, torch.cat([depth64, depth64])),
                         _t(t, latents.device), ctx)
        eps_u, eps_c = eps[:b], eps[b:]
        out = sched.step(eps_u + guidance_scale * (eps_c - eps_u), int(t),
                         latents.float())
    return out, [a[b:] for a in acts]


def guidance_energy(acts, acts_orig_t, pcs, fgw, bgw, conf: dict):
    """The summed per-row guidance energies of activations acts (3 of
    [B,C,H,W]) against the recorded ones acts_orig_t (3 of [C,H,W]); pcs:
    one binned correspondence dict per row."""
    act_size = tuple(acts_orig_t[2].shape[-2:])
    loss = 0.0
    for r in range(acts[0].shape[0]):
        for k in range(3):
            orig = acts_orig_t[k].float()
            loss = loss + fgw[k] * foreground_loss(
                acts[k][r], orig, pcs[r], conf["fg_patch_size"], act_size)
            loss = loss + bgw[k] * background_loss(
                acts[k][r], orig, pcs[r], conf["bg_patch_size"], act_size,
                conf["bg_loss_type"])
    return loss


def guidance_update(unet, latents, depth64, t: int, cond, acts_orig_t,
                    pcs, fgw, bgw, conf: dict, acts_at=None):
    """One guidance iteration on latents [B,4,h,w]: latents - lr * the
    gradient of the energy (`guidance_energy`). With `acts_at` (3 of
    [B,C,H,W]) the energy's gradient is taken at those activations and
    carried to the latents through this U-Net's forward at `latents`;
    without, at this forward's own. Returns (the updated latents, this
    forward's activations)."""
    b = latents.shape[0]
    lat = latents.detach().float().requires_grad_(True)
    with torch.enable_grad():
        _, acts = unet(unet_input(lat, depth64), _t(t, lat.device),
                       cond.expand(b, -1, -1))
        at = [a.detach().float().to(lat.device).requires_grad_(True)
              for a in (acts if acts_at is None else acts_at)]
        loss = guidance_energy(at, acts_orig_t, pcs, fgw, bgw, conf)
        if not isinstance(loss, torch.Tensor) or not loss.requires_grad:
            return lat.detach(), [a.detach() for a in acts]
        cot = torch.autograd.grad(loss, at, allow_unused=True)
        cot = [torch.zeros_like(a) if c is None else c
               for a, c in zip(at, cot)]
        (grad,) = torch.autograd.grad(acts, [lat], grad_outputs=cot)
    return ((lat - conf["guidance_lr"] * grad).detach(),
            [a.detach() for a in acts])


def ddim_inversion_update(unet, sched: RefDDIMSchedule, latent, depth64,
                          t: int, cond):
    """One DDIM inversion step at timestep t, driven by the cond eps."""
    with torch.no_grad():
        eps, _ = unet(unet_input(latent.float(), depth64),
                      _t(t, latent.device), cond)
        return sched.next_step(eps, int(t), latent.float())


def null_text_step(unet, sched: RefDDIMSchedule, step: int, latent_cur,
                   latent_prev, depth64, uncond, cond,
                   guidance_scale: float, num_inner_steps: int = 5,
                   epsilon: float = 1e-5):
    """Null-text optimisation at denoising step `step`: a fresh Adam on the
    uncond embedding, lr 1e-2 * (1 - step / 100), up to num_inner_steps
    iterations that stop once a loss fell under epsilon + step * 2e-5.
    Returns (the optimised embedding [1,77,D], inner iterations run)."""
    t = int(sched.timesteps[step])
    dev = latent_cur.device
    with torch.no_grad():
        eps_cond, _ = unet(unet_input(latent_cur, depth64), _t(t, dev), cond)
    u = uncond.detach().clone().float().requires_grad_(True)
    opt = torch.optim.Adam([u], lr=1e-2 * (1 - step / 100.0))
    j = 0
    for j in range(1, num_inner_steps + 1):
        with torch.enable_grad():
            eps_u, _ = unet(unet_input(latent_cur, depth64), _t(t, dev), u)
            eps = eps_u + guidance_scale * (eps_cond - eps_u)
            rec = sched.step(eps, t, latent_cur)
            loss = F.mse_loss(rec, latent_prev)
            opt.zero_grad()
            loss.backward()
        opt.step()
        if loss.item() < epsilon + step * 2e-5:
            break
    return u.detach(), j
