"""Batched editing: N transforms of one inverted image denoise together.

The counterpart of the JAX package's `parallel/batch.py` (no reference
counterpart: the reference loops transforms serially). The B edits share
the U-Net weights, the prompt and the recorded activations; latents,
depths and correspondences are batched. Each guidance iteration is ONE
batch-B U-Net forward + backward (the energy is the sum of the per-sample
losses, so its gradient to the batched latents is the stack of the
per-sample gradients), and each denoising step ONE batch-2B
classifier-free-guidance pass.

Over a ('data', 'model') mesh (`parallel/mesh.py`) every rank makes the
same call: rank (d, m) runs the data slice d of the transforms with the
U-Net sharded over the model axis (`parallel/sharding.py`; the VAE and the
text encoder stay replicated, as in the JAX package), and the final
latents are all-gathered over the data axis, so every rank returns every
image. A data axis that does not divide the batch raises, as the JAX
package's jit with P('data') does; `chunk` pads to a batch it divides.

Equal transforms in one batch give equal bits, as in the JAX package: at
batch > 1 the U-Net runs its convolutions image by image
(UNetConfig.conv_per_image), and the images are decoded one at a time, so
no cuDNN algorithm sums a row in an order that depends on its batch
position.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence

import numpy as np
import torch

from diffusionhandles_tpu_torch.diffuser import (GuidedStableDiffuser,
                                                 _stack_uncond)
from diffusionhandles_tpu_torch.guidance import (
    ProcessedCorrespondences, background_loss_apply,
    background_orig_precompute, build_guidance_weight_schedule,
    fg_slot_order, foreground_loss_apply, foreground_orig_precompute)
from diffusionhandles_tpu_torch.models.unet import UNet2DConditionModel
from diffusionhandles_tpu_torch.parallel.sharding import (axis_size,
                                                          gather_batch,
                                                          shard_batch,
                                                          shard_params,
                                                          shard_unet)
from diffusionhandles_tpu_torch.scheduler import ddim_step
from diffusionhandles_tpu_torch.utils.profiling import request, span


def stack_pcs(pcs: Sequence[ProcessedCorrespondences]
              ) -> ProcessedCorrespondences:
    return ProcessedCorrespondences(
        *[torch.stack([getattr(pc, f) for pc in pcs]) for f in
          ProcessedCorrespondences._fields])


def _row(pcs: ProcessedCorrespondences, b: int) -> ProcessedCorrespondences:
    return ProcessedCorrespondences(*(f[b] for f in pcs))


def _unet_copy(unet: UNet2DConditionModel, **switches
               ) -> UNet2DConditionModel:
    """A U-Net on `unet`'s config with `switches` (UNetConfig fields) set,
    holding the same weight tensors."""
    cfg = dataclasses.replace(unet.config, **switches)
    with torch.device("meta"):
        other = UNet2DConditionModel(cfg)
    other.load_state_dict(unet.state_dict(), strict=True, assign=True)
    return other.eval().requires_grad_(False)


def build_batched_guided_inference(diffuser: GuidedStableDiffuser,
                                   num_optsteps: int,
                                   guidance_max_step: int,
                                   bg_loss_type: str, fg_patch: int,
                                   bg_patch: int, mesh=None, remat=None):
    """A batched guided-denoising runner:

        run(init_latents [B, 4, h, w], depth64 [B, 1, h, w],
            uncond_seq [T, 77, D], cond [1, 77, D],
            acts_orig (3 x [T, C, H, W]), fgw, bgw, pcs (stacked))
        -> final latents [B, 4, h, w]

    At B > 1 both passes run copies of the diffuser's U-Net on the same
    weights with conv_per_image set; at B = 1 they run it as the single
    edit does.
    mesh: a ('data', 'model') DeviceMesh, or None. With one, every rank
    calls run with the whole batch: it runs its data slice (B over the
    data axis, which must divide B) on copies of the U-Net sharded over
    the model axis (where that is > 1), and returns every rank's latents.
    remat: the recompute of the GRAD-path U-Net in this runner only
    ('dots', or any other non-empty value for whole blocks); the CFG pass
    does not recompute. None reads DIFFHANDLES_BATCHED_REMAT (unset:
    off)."""
    if remat is None:
        remat = os.environ.get("DIFFHANDLES_BATCHED_REMAT") or None
    remat = ("dots" if remat == "dots" else True) if remat else False
    unet = diffuser.models.unet
    tensor_parallel = mesh is not None and axis_size(mesh, "model") > 1

    def unets(b: int):
        """(grad-path U-Net, CFG U-Net) for batch b."""
        if tensor_parallel:  # copies holding one set of this rank's shards
            local = shard_params(unet.state_dict(), mesh, "model",
                                 unet.config)
            grad = _unet_copy(unet, remat=remat, conv_per_image=b > 1)
            cfg = _unet_copy(unet, conv_per_image=b > 1)
            return (shard_unet(grad, mesh, params=local),
                    shard_unet(cfg, mesh, params=local))
        if b > 1:
            return (_unet_copy(unet, remat=remat, conv_per_image=True),
                    _unet_copy(unet, conv_per_image=True))
        return (_unet_copy(unet, remat=remat) if remat else unet), unet

    schedule = diffuser.schedule
    gs = diffuser.conf.guidance_scale
    glr = diffuser.conf.guidance_lr
    act_size = (diffuser.latent_res, diffuser.latent_res)

    def batch_energy(grad_unet, latents, depth64, cond, step_idx, fg_pre,
                     bg_pre, fgw_it, bgw_it, pcs):
        """Sum of the per-sample energies over one batch-B U-Net call."""
        b = latents.shape[0]
        ctx = cond[0].expand(b, -1, -1)
        _, acts, _ = grad_unet(diffuser.unet_in(latents, depth64),
                               diffuser.timestep(step_idx), ctx)
        loss = 0.0
        with span("guidance.energy"):
            for r in range(b):
                pc = _row(pcs, r)
                for k in range(3):
                    loss = loss + float(fgw_it[k]) * foreground_loss_apply(
                        fg_pre[r][k], acts[k][r], pc, fg_patch, act_size)
                    loss = loss + float(bgw_it[k]) * background_loss_apply(
                        bg_pre[r][k], acts[k][r], pc, bg_patch, act_size,
                        bg_loss_type)
        return loss

    def orig_precompute(acts_t, pcs, orders, b):
        """The latent-independent loss halves, per sample."""
        fg, bg = [], []
        for r in range(b):
            pc = _row(pcs, r)
            fg.append([foreground_orig_precompute(acts_t[k], pc, fg_patch,
                                                  act_size, orders[r])
                       for k in range(3)])
            bg.append([background_orig_precompute(acts_t[k], pc, bg_patch,
                                                  act_size, bg_loss_type)
                       for k in range(3)])
        return fg, bg

    @torch.no_grad()
    def cfg_batch(cfg_unet, latents, depth64, uncond_t, cond, step_idx):
        """One batch-2B CFG DDIM step: context [uncond x B, cond x B]."""
        with span("cfg.step"):
            b = latents.shape[0]
            lat2 = torch.cat([latents, latents], 0)
            d2 = torch.cat([depth64, depth64], 0) if depth64 is not None \
                else None
            ctx = torch.cat([uncond_t.expand(b, -1, -1),
                             cond[0].expand(b, -1, -1)], 0)
            eps, _, _ = cfg_unet(diffuser.unet_in(lat2, d2),
                                 diffuser.timestep(step_idx), ctx)
            noise_pred = eps[:b] + gs * (eps[b:] - eps[:b])
            return ddim_step(schedule, noise_pred, step_idx, latents)

    def run(init_latents, depth64, uncond_seq, cond, acts_orig, fgw, bgw,
            pcs):
        if mesh is not None:
            init_latents = shard_batch(init_latents, mesh)
            depth64 = (None if depth64 is None
                       else shard_batch(depth64, mesh))
            pcs = ProcessedCorrespondences(*(shard_batch(f, mesh)
                                             for f in pcs))
        latents = init_latents
        b = latents.shape[0]
        grad_unet, cfg_unet = unets(b)
        orders = [fg_slot_order(_row(pcs, r), act_size) for r in range(b)]
        for i in range(schedule.num_inference_steps):
            with span("step"):
                if i < guidance_max_step:
                    fg_pre, bg_pre = orig_precompute(
                        [a[i] for a in acts_orig], pcs, orders, b)
                    for it in range(num_optsteps):
                        with span("guidance.opt_step"):
                            lat = latents.detach().requires_grad_(True)
                            with torch.enable_grad():
                                energy = batch_energy(
                                    grad_unet, lat, depth64, cond, i, fg_pre,
                                    bg_pre, fgw[i, it], bgw[i, it], pcs)
                                with span("guidance.backward"):
                                    (grad,) = torch.autograd.grad(energy,
                                                                  lat)
                            with span("guidance.update"):
                                latents = latents - glr * grad
                latents = cfg_batch(cfg_unet, latents, depth64,
                                    uncond_seq[i], cond, i)
        return latents if mesh is None else gather_batch(latents, mesh)

    return run


def _transform_kwargs(tr: dict) -> dict:
    return dict(rot_angle=tr.get("rotation_angle"),
                rot_axis=(np.asarray(tr["rotation_axis"], np.float32)
                          if "rotation_axis" in tr else None),
                translation=(np.asarray(tr["translation"], np.float32)
                             if "translation" in tr else None))


def edit_batch(handles, depth, prompt: str, fg_mask, bg_depth,
               null_text_emb, init_noise, activations,
               transforms: List[dict], mesh=None, chunk: int = 0,
               return_disparities: bool = False):
    """Run N transforms of one inverted image as ONE batched guided
    denoising on the handles' device (over a mesh: on every rank, each
    running its share; see the module docstring).

    transforms: dicts with 'rotation_angle', 'rotation_axis',
      'translation' (the photogen transforms.json schema).
    mesh: a ('data', 'model') DeviceMesh (parallel/mesh.make_mesh) whose
      data axis divides the batch, or None.
    chunk: when nonzero, the transforms go in fixed batches of this size,
      the last padded by repeating its final transform (the padded rows are
      discarded).
    return_disparities: also return the edited disparities [N, 1, H, W].
    The guidance U-Net's recompute follows DIFFHANDLES_BATCHED_REMAT (see
    build_batched_guided_inference).

    Returns the edited images [N, 3, H, W] in [0, 1] as numpy (and the
    disparities)."""
    from diffusionhandles_tpu_torch.geometry.transform import (
        transform_depth, transform_depth_pc_processed)

    with request("edit_batch"):
        if chunk and len(transforms) != chunk:
            imgs_all, disps_all = [], []
            for i in range(0, len(transforms), chunk):
                sub = transforms[i:i + chunk]
                pad = chunk - len(sub)
                imgs, disps = edit_batch(
                    handles, depth, prompt, fg_mask, bg_depth,
                    null_text_emb, init_noise, activations,
                    sub + [sub[-1]] * pad, mesh=mesh,
                    return_disparities=True)
                imgs_all.append(imgs[:len(sub)])
                disps_all.append(disps[:len(sub)])
            imgs = np.concatenate(imgs_all)
            disps = np.concatenate(disps_all)
            return (imgs, disps) if return_disparities else imgs

        d = handles.diffuser
        if d.sdxl:
            raise NotImplementedError("batched editing runs the SD-2-depth "
                                      "family only")
        conf = d.conf
        mode = handles.conf.depth_transform_mode
        K = d.get_depth_intrinsics()
        depth_res = int(max(np.shape(depth)[-2:]))
        depth64s, pcs, disparities = [], [], []
        with span("depth_transform"):
            for tr in transforms:
                if mode == "pc":
                    edited_disparity, pc = transform_depth_pc_processed(
                        depth=depth, bg_depth=bg_depth, fg_mask=fg_mask,
                        intrinsics=K, bg_erosion=conf.bg_erosion,
                        max_corr=conf.max_correspondences,
                        latent_res=d.latent_res, device=d.device,
                        **_transform_kwargs(tr))
                else:
                    edited_disparity, corr = transform_depth(
                        depth=depth, bg_depth=bg_depth, fg_mask=fg_mask,
                        intrinsics=K, depth_transform_mode=mode,
                        device=d.device, **_transform_kwargs(tr))
                    pc = d.process_correspondences(corr, depth_res,
                                                   conf.bg_erosion)
                depth64s.append(d.init_depth(edited_disparity)[0])
                pcs.append(pc)
                disparities.append(edited_disparity)

        B = len(transforms)
        T = d.schedule.num_inference_steps
        cond = d.encode_prompt(prompt)
        uncond_seq = _stack_uncond(null_text_emb, T, d.device)
        init_lat = d._tensor(init_noise)[0].expand(B, -1, -1,
                                                   -1).contiguous()
        fgw, bgw = build_guidance_weight_schedule(
            conf.fg_weight, conf.bg_weight, conf.guidance_max_step, T,
            conf.num_optsteps, conf.guidance_schedule_type)
        acts_orig = [torch.as_tensor(a, device=d.device).to(d.act_dtype)
                     for a in activations]
        run = build_batched_guided_inference(
            d, conf.num_optsteps, conf.guidance_max_step, conf.bg_loss_type,
            conf.fg_patch_size, conf.bg_patch_size, mesh=mesh)
        latents = run(init_lat, torch.stack(depth64s) if conf.use_depth
                      else None, uncond_seq, cond, acts_orig, fgw, bgw,
                      stack_pcs(pcs))
        # one image at a time, as the single edit decodes
        images = torch.cat([d.decode_latent_image(lat[None])
                            for lat in latents])
        with span("sync.image_to_host"):
            images = images.cpu().numpy()
        if not return_disparities:
            return images
        disps = []
        for dd in disparities:
            with span("sync.disparity_to_host"):
                disps.append(dd.reshape(1, *dd.shape[-2:]).cpu().numpy())
        return images, np.stack(disps)
