"""Guided depth-to-image diffuser.

The counterpart of the JAX package's `diffuser.py` (reference:
diffhandles/guided_stable_diffuser.py). The JAX package's `lax.scan`s are
Python loops here:

* `initial_inference` (reference :155-275): one batch-2 [uncond_t, cond]
  U-Net pass per step; the cond row's decoder activations are recorded.
* `guided_inference` (reference :291-488): under `guidance_max_step`, each
  step first runs `num_optsteps` iterations of
  `latents -= guidance_lr * grad(energy)` through the U-Net (autograd on
  the latents), then the batch-2 classifier-free-guidance DDIM step. With
  `save_denoising_steps` it also decodes each step's post-opt and post-CFG
  latents.

`GuidedDiffuserConfig.remat_guidance` becomes `UNetConfig.remat`: every
pass that records a graph through the U-Net (guidance, null-text
inversion) recomputes its blocks in the backward.

Layouts are NCHW: latents [1, 4, h, w], depth [1, 1, h, w], activation
stacks [T, C, H, W] (the reference's own layout).

Two model families (`ModelPathsConfig.model_name`). SD-2-depth takes the
depth as a fifth input channel of its U-Net, one text tower, and records
three activation stacks. SDXL base 1.0 with the depth ControlNet
(`config.SDXL_DEPTH_CONTROLNET`) takes the depth as the
ControlNet's control image at image resolution, two text towers whose
penultimate states are concatenated, the pooled text vector and the size
ids as added conditions, zeros for the unconditional row's context and
pooled vector (its `force_zeros_for_empty_prompt`), and records two
stacks. `denoise` is the one call of either; the guidance losses weigh the
recorded stacks by the schedule's last weights, as many as there are.
"""

from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from diffusionhandles_tpu_torch.config import (SDXL_DEPTH_CONTROLNET,
                                               GuidedDiffuserConfig,
                                               ModelPathsConfig)
from diffusionhandles_tpu_torch.guidance import (
    ProcessedCorrespondences, background_loss_apply,
    background_orig_precompute, build_guidance_weight_schedule,
    fg_slot_order, foreground_loss_apply, foreground_orig_precompute,
    process_correspondences)
from diffusionhandles_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextModel,
                                                         tiny_clip_config)
from diffusionhandles_tpu_torch.models.tokenizer import load_tokenizer
from diffusionhandles_tpu_torch.models.unet import (UNet2DConditionModel,
                                                    UNetConfig,
                                                    tiny_unet_config)
from diffusionhandles_tpu_torch.models.vae import (AutoencoderKL, VAEConfig,
                                                   tiny_vae_config)
from diffusionhandles_tpu_torch.models.weights import load_checkpoint_into
from diffusionhandles_tpu_torch.ops.resize import resize_hw
from diffusionhandles_tpu_torch.scheduler import (add_noise, ddim_step,
                                                  make_ddim_schedule)
from diffusionhandles_tpu_torch.utils.device import resolve_device
from diffusionhandles_tpu_torch.utils.profiling import span
from diffusionhandles_tpu_torch.utils.rng import seeded_randn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass
class SDModels:
    """The component models: SD-2-depth's, or with `controlnet` SDXL's
    (its second text tower `text_encoder_2`, and `denoiser`, the
    ControlNet and U-Net called as one, made here)."""

    unet: UNet2DConditionModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    unet_config: UNetConfig
    vae_config: VAEConfig
    clip_config: CLIPTextConfig
    controlnet: Optional[nn.Module] = None
    text_encoder_2: Optional[nn.Module] = None
    clip2_config: Optional[CLIPTextConfig] = None
    denoiser: Optional[nn.Module] = None

    def __post_init__(self):
        if self.controlnet is not None and self.denoiser is None:
            from diffusionhandles_tpu_torch.models.controlnet import \
                ControlNetDenoiser
            self.denoiser = ControlNetDenoiser(self.unet, self.controlnet)

    def modules(self) -> list:
        """Every model, the denoiser last (it holds the U-Net and the
        ControlNet)."""
        return [m for m in (self.unet, self.vae, self.text_encoder,
                            self.controlnet, self.text_encoder_2,
                            self.denoiser) if m is not None]


@torch.no_grad()
def seeded_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator` with flax's default initializers:
    truncated-normal LeCun kernels, zero biases, unit norm scales,
    embeddings with std 1/sqrt(features) (positions 0.01)."""
    for name, p in module.named_parameters():
        tmp = torch.empty(p.shape, dtype=torch.float32, device=p.device)
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
            tmp.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            tmp.zero_()
        elif isinstance(owner, nn.Embedding):
            std = (0.01 if "position" in name
                   else 1.0 / math.sqrt(p.shape[-1]))
            tmp.normal_(0.0, std, generator=generator)
        else:
            fan_in = p[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(tmp, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        p.copy_(tmp)
    return module


def create_sd_models(model_paths: Optional[ModelPathsConfig] = None,
                     conf: Optional[GuidedDiffuserConfig] = None,
                     variant: str = "sd2", seed: int = 0,
                     device=None) -> SDModels:
    """The SD stack on `device` (default: the GPU), of the family that
    `model_paths.model_name` names.

    variant='sd2': the real architecture (SD-2-depth, or SDXL base 1.0 with
    the depth ControlNet); 'tiny': the miniature test architecture.
    Weights: strictly loaded from `model_paths.checkpoint_dir` (a diffusers
    layout: unet/, vae/, text_encoder/, for SDXL also text_encoder_2/ and
    controlnet/, with .safetensors or .bin files, and the CLIP tokenizer
    from tokenizer/) if given, else seeded random."""
    conf = conf or GuidedDiffuserConfig()
    device = resolve_device(device)
    ckpt_dir = model_paths.checkpoint_dir if model_paths else None
    dtype = DTYPES[conf.dtype]
    param_dtype = DTYPES[conf.param_dtype]
    if model_paths and model_paths.model_name == SDXL_DEPTH_CONTROLNET:
        return _create_sdxl_models(conf, variant, seed, device, ckpt_dir,
                                   dtype, param_dtype)
    in_ch = 5 if conf.use_depth else 4
    if variant == "tiny":
        ucfg = tiny_unet_config(in_channels=in_ch,
                                flash_attention=conf.flash_attention,
                                remat=conf.remat_guidance)
        vcfg = tiny_vae_config()
        ccfg = tiny_clip_config()
    else:
        ucfg = UNetConfig(in_channels=in_ch, dtype=dtype,
                          param_dtype=param_dtype,
                          remat=conf.remat_guidance,
                          flash_attention=conf.flash_attention)
        vcfg = VAEConfig(dtype=dtype, param_dtype=param_dtype)
        ccfg = CLIPTextConfig()  # the text encoder stays fp32
    with torch.device(device):
        unet = UNet2DConditionModel(ucfg)
        vae = AutoencoderKL(vcfg)
        clip = CLIPTextModel(ccfg)
    if ckpt_dir is None:
        gen = torch.Generator(device=device)
        seeded_init_(unet, gen.manual_seed(seed))
        seeded_init_(vae, gen.manual_seed(seed + 1))
        seeded_init_(clip, gen.manual_seed(seed + 2))
    else:
        root = pathlib.Path(ckpt_dir)
        load_checkpoint_into(unet, root / "unet", "unet")
        load_checkpoint_into(vae, root / "vae", "vae")
        load_checkpoint_into(clip, root / "text_encoder", "text_encoder")
    for m in (unet, vae, clip):
        m.eval().requires_grad_(False)
    tokenizer = load_tokenizer(ckpt_dir, max_length=77,
                               vocab_size=ccfg.vocab_size)
    return SDModels(unet, vae, clip, tokenizer, ucfg, vcfg, ccfg)


def _create_sdxl_models(conf: GuidedDiffuserConfig, variant: str, seed: int,
                        device, ckpt_dir, dtype, param_dtype) -> SDModels:
    """create_sd_models' SDXL family: the U-Net and the ControlNet in the
    config's dtypes, the VAE too (the tiny variant: fp32), the two text
    towers in fp32; the ControlNet's residuals at the model card's scale
    (controlnet.SDXL_CONDITIONING_SCALE)."""
    from diffusionhandles_tpu_torch.models.clip_text import \
        CLIPTextModelWithProjection
    from diffusionhandles_tpu_torch.models.controlnet import (
        SDXL_CONDITIONING_SCALE, ControlNetModel, sdxl_configs)
    fields = dict(flash_attention=conf.flash_attention,
                  remat=conf.remat_guidance,
                  conditioning_scale=SDXL_CONDITIONING_SCALE)
    if variant != "tiny":
        fields.update(dtype=dtype, param_dtype=param_dtype)
    ucfg, cncfg, vcfg, c1, c2 = sdxl_configs(variant == "tiny", **fields)
    with torch.device(device):
        mods = dict(unet=UNet2DConditionModel(ucfg), vae=AutoencoderKL(vcfg),
                    text_encoder=CLIPTextModel(c1),
                    text_encoder_2=CLIPTextModelWithProjection(c2),
                    controlnet=ControlNetModel(ucfg, cncfg))
    gen = torch.Generator(device=device)
    for k, (name, mod) in enumerate(mods.items()):
        if ckpt_dir is None:
            seeded_init_(mod, gen.manual_seed(seed + k))
        else:
            load_checkpoint_into(mod, pathlib.Path(ckpt_dir) / name, name)
        mod.eval().requires_grad_(False)
    tokenizer = load_tokenizer(ckpt_dir, max_length=77,
                               vocab_size=c1.vocab_size)
    return SDModels(mods["unet"], mods["vae"], mods["text_encoder"],
                    tokenizer, ucfg, vcfg, c1,
                    controlnet=mods["controlnet"],
                    text_encoder_2=mods["text_encoder_2"], clip2_config=c2)


def _stack_uncond(uncond_embeddings, num_steps: int, device) -> torch.Tensor:
    """Null-text embeddings as [T, 77, D] fp32 ([1, ...] is broadcast)."""
    u = torch.as_tensor(uncond_embeddings, dtype=torch.float32,
                        device=device)
    u = u.reshape((u.shape[0],) + tuple(u.shape[-2:]))
    if u.shape[0] == 1:
        u = u.expand((num_steps,) + tuple(u.shape[1:]))
    return u


class GuidedDiffuser:
    """Abstract diffuser interface (reference:
    diffhandles/guided_diffuser.py)."""

    def __init__(self, conf: GuidedDiffuserConfig):
        self.conf = conf

    def get_depth_intrinsics(self):
        raise NotImplementedError

    def encode_latent_image(self, image):
        raise NotImplementedError

    def decode_latent_image(self, latent_image):
        raise NotImplementedError

    def initial_inference(self, init_latents, depth, uncond_embeddings,
                          prompt):
        raise NotImplementedError

    def guided_inference(self, latents, depth, uncond_embeddings, prompt,
                         activations_orig, correspondences, **kwargs):
        raise NotImplementedError


class GuidedStableDiffuser(GuidedDiffuser):
    """The depth-conditioned SD-2 diffuser with activation-guided
    inference."""

    def __init__(self, conf: GuidedDiffuserConfig,
                 models: Optional[SDModels] = None,
                 model_paths: Optional[ModelPathsConfig] = None,
                 variant: str = "sd2", device=None):
        super().__init__(conf)
        self.device = resolve_device(device)
        self.models = models or create_sd_models(model_paths, conf, variant,
                                                 device=self.device)
        self.schedule = make_ddim_schedule(conf.num_timesteps)
        self.latent_res = self.models.unet_config.sample_size
        self.image_res = (self.latent_res
                          * self.models.vae_config.downscale_factor)
        self.act_dtype = DTYPES[conf.activation_store_dtype]
        self.sdxl = self.models.controlnet is not None
        # SDXL's size and crop ids: original size, crop's top-left corner,
        # target size (the whole image at its own resolution)
        r = float(self.image_res)
        self.time_ids = (torch.tensor([[r, r, 0.0, 0.0, r, r]],
                                      device=self.device)
                         if self.sdxl else None)
        self._prompt_cache = {}

    def get_image_shape(self):
        """(C, H, W) of an image, this package's NCHW layout (the JAX
        package gives (H, W, C))."""
        return (3, self.image_res, self.image_res)

    def get_feature_shape(self):
        """(C, h, w) of the latents, NCHW (the JAX package: (h, w, C))."""
        return (self.models.unet_config.out_channels, self.latent_res,
                self.latent_res)

    @staticmethod
    def get_depth_intrinsics() -> np.ndarray:
        """Pinhole intrinsics, fov 55 deg, [-1,1]^2 image plane
        (reference: guided_stable_diffuser.py:129-153)."""
        f = 1.0 / np.tan(0.5 * 55.0 * (np.pi / 180.0))
        return np.array([[f, 0.0, 0.0], [0.0, f, 0.0], [0.0, 0.0, 1.0]],
                        dtype=np.float32)

    def _tensor(self, x) -> torch.Tensor:
        # in the standard layout: a caller's strided array (an image read
        # as HWC and transposed) would otherwise take other conv
        # algorithms, and other bits, than the same values packed
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).contiguous()

    def init_depth(self, depth) -> torch.Tensor:
        """Disparity resized (bicubic) to the latent grid and normalized to
        [-1, 1]: [1, 1, L, L] fp32 (reference: :110-127). Accepts [H, W],
        [1, H, W] or [1, 1, H, W]."""
        depth = self._tensor(depth)
        depth = depth.reshape(depth.shape[-2:])[None, None]
        depth = resize_hw(depth, (self.latent_res, self.latent_res),
                          "bicubic")
        dmin, dmax = depth.amin(), depth.amax()
        return 2.0 * (depth - dmin) / (dmax - dmin) - 1.0

    def depth_cond(self, depth) -> torch.Tensor:
        """The depth as the denoiser takes it: SD-2's fifth channel on the
        latent grid (`init_depth`), or SDXL's control image [1, 3, H, W]
        at the image's resolution (`controlnet.control_image`)."""
        if not self.sdxl:
            return self.init_depth(depth)
        from diffusionhandles_tpu_torch.models.controlnet import \
            control_image
        depth = self._tensor(depth)
        return control_image(depth.reshape(depth.shape[-2:])[None, None],
                             self.image_res)

    def encode_prompt(self, prompt: str) -> torch.Tensor:
        """CLIP-encode a prompt -> [1, 77, D] fp32 (memoized). SDXL: the
        two towers' penultimate states concatenated; the second tower's
        pooled vector is kept for `pooled_prompt`."""
        if prompt not in self._prompt_cache:
            m = self.models
            ids = torch.tensor(m.tokenizer([prompt]), dtype=torch.long,
                               device=self.device)
            with torch.no_grad(), span("text_towers"):
                if m.text_encoder_2 is None:
                    self._prompt_cache[prompt] = (m.text_encoder(ids), None)
                else:
                    ctx2, pooled = m.text_encoder_2(ids)
                    self._prompt_cache[prompt] = (
                        torch.cat([m.text_encoder(ids), ctx2], dim=-1),
                        pooled)
        return self._prompt_cache[prompt][0]

    def pooled_prompt(self, prompt: str) -> Optional[torch.Tensor]:
        """SDXL: the prompt's pooled text vector [1, P]; None for SD-2."""
        self.encode_prompt(prompt)
        return self._prompt_cache[prompt][1]

    def uncond_embedding(self) -> torch.Tensor:
        """The unconditional row's context [1, 77, D]: the empty prompt's,
        or SDXL's zeros (its force_zeros_for_empty_prompt; the row's
        pooled vector is zeros too)."""
        if not self.sdxl:
            return self.encode_prompt("")
        return torch.zeros(1, self.models.clip_config.max_position_embeddings,
                           self.models.unet_config.cross_attention_dim,
                           device=self.device)

    def init_prompt(self, prompt: str):
        """(uncond, cond) embeddings (reference: init_prompt :93-108)."""
        return self.uncond_embedding(), self.encode_prompt(prompt)

    @torch.no_grad()
    def encode_latent_image(self, image) -> torch.Tensor:
        """[1, 3, H, W] in [0, 1] -> scaled latents [1, 4, h, w]."""
        with span("vae.encode"):
            image = self._tensor(image)
            return (self.models.vae.encode(image * 2.0 - 1.0)
                    * self.models.vae_config.scaling_factor)

    @torch.no_grad()
    def decode_latent_image(self, latents) -> torch.Tensor:
        """Scaled latents -> image [1, 3, H, W] clipped to [0, 1]."""
        with span("vae.decode"):
            z = self._tensor(latents) / self.models.vae_config.scaling_factor
            return torch.clamp(self.models.vae.decode(z) / 2.0 + 0.5, 0.0,
                               1.0)

    def seeded_init_latents(self) -> torch.Tensor:
        """Zeros noised to timesteps[0] with the seeded CPU noise
        (reference: guided_stable_diffuser.py:191-200)."""
        c = self.models.unet_config
        noise = seeded_randn((1, c.out_channels, self.latent_res,
                              self.latent_res),
                             self.conf.seed, self.conf.noise_rng,
                             device=self.device)
        return add_noise(self.schedule, torch.zeros_like(noise), noise,
                         int(self.schedule.timesteps[0]))

    def unet_in(self, latents, depth64) -> torch.Tensor:
        if not self.conf.use_depth:
            return latents
        b = latents.shape[0]
        return torch.cat([latents, depth64.expand(b, -1, -1, -1)], dim=1)

    def timestep(self, step_idx: int) -> torch.Tensor:
        with span("sync.timestep"):
            return torch.tensor(int(self.schedule.timesteps[step_idx]),
                                device=self.device)

    def denoise(self, latents, depth_cond, step_idx: int, context,
                pooled=None):
        """One denoiser call on latents [B, 4, h, w] with the rows' text
        context [B, 77, D]: SD-2's U-Net on the latents and the depth
        channel, or SDXL's ControlNet and U-Net on the latents, the control
        image, the rows' pooled vectors `pooled` [B, P] and the size ids.
        Returns (eps, activations, attn)."""
        m = self.models
        if m.denoiser is None:
            return m.unet(self.unet_in(latents, depth_cond),
                          self.timestep(step_idx), context)
        b = latents.shape[0]
        return m.denoiser(latents, self.timestep(step_idx), context,
                          depth_cond.expand(b, -1, -1, -1), pooled,
                          self.time_ids.expand(b, -1))

    def cfg_step(self, latents, depth64, uncond_t, cond, step_idx: int,
                 pooled=None):
        """One classifier-free-guidance DDIM step (batch-2 denoiser pass;
        `pooled`: SDXL's pooled vector of the cond row, the uncond row's
        being zeros). Returns (new latents, the cond row's
        activations)."""
        with span("cfg.step"):
            lat2 = torch.cat([latents, latents], dim=0)
            ctx = torch.stack([uncond_t, cond[0]], dim=0)
            if pooled is not None:
                pooled = torch.cat([torch.zeros_like(pooled), pooled])
            eps, acts, _ = self.denoise(lat2, depth64, step_idx, ctx, pooled)
            gs = self.conf.guidance_scale
            noise_pred = eps[0] + gs * (eps[1] - eps[0])
            return (ddim_step(self.schedule, noise_pred[None], step_idx,
                              latents), acts)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def initial_inference(self, init_latents, depth, uncond_embeddings,
                          prompt: str):
        """Depth-conditioned reconstruction that records the decoder
        activations of the cond row.

        Returns (activations: a stack [T, C, H, W] per recorded up block,
        final latents, uncond_seq [T, 77, D], init_latents)."""
        T = self.schedule.num_inference_steps
        depth64 = self.depth_cond(depth) if self.conf.use_depth else None
        cond = self.encode_prompt(prompt)
        pooled = self.pooled_prompt(prompt)
        if uncond_embeddings is None:
            uncond_seq = self.uncond_embedding().expand(T, -1, -1)
        else:
            uncond_seq = _stack_uncond(uncond_embeddings, T, self.device)
        if init_latents is None:
            init_latents = self.seeded_init_latents()
        init_latents = self._tensor(init_latents)
        latents = init_latents
        recorded = []
        for i in range(T):
            latents, acts = self.cfg_step(latents, depth64, uncond_seq[i],
                                          cond, i, pooled)
            recorded.append([a[1].to(self.act_dtype) for a in acts])
        stacks = [torch.stack([r[k] for r in recorded])
                  for k in range(len(recorded[0]))]
        return stacks, latents, uncond_seq, init_latents

    def guidance_energy(self, latents, depth64, cond, step_idx: int,
                        fg_pre, bg_pre, fgw, bgw,
                        pc: ProcessedCorrespondences, pooled=None):
        """The weighted fg + bg activation energy of `latents` at step
        `step_idx` (fgw, bgw: the schedule's 3 per-layer weights, of which
        the recorded stacks take the last, one each: all three in SD-2,
        whose first is zero at every step, the last two in SDXL)."""
        conf = self.conf
        size = (self.latent_res, self.latent_res)
        _, acts, _ = self.denoise(latents, depth64, step_idx, cond, pooled)
        first = len(fgw) - len(acts)
        loss = 0.0
        with span("guidance.energy"):
            for k in range(len(acts)):
                loss = loss + float(fgw[first + k]) * foreground_loss_apply(
                    fg_pre[k], acts[k][0], pc, conf.fg_patch_size, size)
                loss = loss + float(bgw[first + k]) * background_loss_apply(
                    bg_pre[k], acts[k][0], pc, conf.bg_patch_size, size,
                    conf.bg_loss_type)
        return loss

    def guided_inference(self, latents, depth, uncond_embeddings,
                         prompt: str, activations_orig: Sequence,
                         correspondences=None,
                         fg_weight: Optional[float] = None,
                         bg_weight: Optional[float] = None,
                         save_denoising_steps: bool = False,
                         processed_correspondences: Optional[
                             ProcessedCorrespondences] = None):
        """Guided denoising toward the 3D-warped activations.

        The correspondences come either processed (device binning) or as
        packed [N, 4] image-pixel rows, binned here at the depth map's
        resolution. Returns the edited image [1, 3, H, W] in [0, 1]; with
        `save_denoising_steps`, (image, {"opt": [(img_opt, img_step)] * T})
        with each step's post-opt and post-CFG decodes as numpy
        [1, H, W, 3] in [0, 1] (the JAX package's layout)."""
        conf = self.conf
        if processed_correspondences is None:
            # the correspondences live in the depth map's pixel space, which
            # need not be the model's native resolution
            depth_res = int(max(np.shape(depth)[-2:]))
            pc = self.process_correspondences(correspondences, depth_res,
                                              conf.bg_erosion)
        else:
            pc = processed_correspondences
        size = (self.latent_res, self.latent_res)
        order = fg_slot_order(pc, size)
        fg_weight = conf.fg_weight if fg_weight is None else fg_weight
        bg_weight = conf.bg_weight if bg_weight is None else bg_weight
        T = self.schedule.num_inference_steps
        depth64 = self.depth_cond(depth) if conf.use_depth else None
        cond = self.encode_prompt(prompt)
        pooled = self.pooled_prompt(prompt)
        uncond_seq = _stack_uncond(uncond_embeddings, T, self.device)
        fgw, bgw = build_guidance_weight_schedule(
            fg_weight, bg_weight, conf.guidance_max_step, T,
            conf.num_optsteps, conf.guidance_schedule_type)
        acts_orig = [torch.as_tensor(a, device=self.device).to(
            self.act_dtype) for a in activations_orig]
        latents = self._tensor(latents)
        steps = []

        for i in range(T):
            with span("step"):
                if i < conf.guidance_max_step:
                    # latent-independent halves of the losses, once per step
                    fg_pre = [foreground_orig_precompute(
                        a[i], pc, conf.fg_patch_size, size, order)
                        for a in acts_orig]
                    bg_pre = [background_orig_precompute(
                        a[i], pc, conf.bg_patch_size, size,
                        conf.bg_loss_type) for a in acts_orig]
                    for it in range(conf.num_optsteps):
                        with span("guidance.opt_step"):
                            lat = latents.detach().requires_grad_(True)
                            with torch.enable_grad():
                                energy = self.guidance_energy(
                                    lat, depth64, cond, i, fg_pre, bg_pre,
                                    fgw[i, it], bgw[i, it], pc, pooled)
                                with span("guidance.backward"):
                                    (grad,) = torch.autograd.grad(energy,
                                                                  lat)
                            with span("guidance.update"):
                                latents = latents - conf.guidance_lr * grad
                    # the step's loss halves are the edit's largest eager
                    # buffers: free them before the CFG pass and the decode
                    del fg_pre, bg_pre
                # past guidance_max_step "post opt" is the previous step's
                # latents, as the reference's empty opt loop leaves them
                post_opt = latents
                with torch.no_grad():
                    latents, _ = self.cfg_step(latents, depth64,
                                               uncond_seq[i], cond, i,
                                               pooled)
                if save_denoising_steps:
                    steps.append((self._decoded_nhwc(post_opt),
                                  self._decoded_nhwc(latents)))
        image = self.decode_latent_image(latents)
        if save_denoising_steps:
            return image, {"opt": steps}
        return image

    def _decoded_nhwc(self, latents) -> np.ndarray:
        image = self.decode_latent_image(latents).permute(0, 2, 3, 1)
        with span("sync.step_decode_to_host"):
            return image.cpu().numpy()

    def process_correspondences(self, correspondences, img_res: int,
                                bg_erosion: int = 0
                                ) -> ProcessedCorrespondences:
        """Packed [N, 4] correspondences at `img_res` binned onto this
        model's latent grid, on its device (reference:
        guided_stable_diffuser.py:490-584)."""
        return process_correspondences(
            correspondences, img_res=img_res, bg_erosion=bg_erosion,
            max_corr=self.conf.max_correspondences,
            latent_res=self.latent_res, device=self.device)
