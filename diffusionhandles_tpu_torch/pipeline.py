"""DiffusionHandles pipeline facade.

The counterpart of the JAX package's `pipeline.py` (reference:
diffhandles/diffusion_handles.py): the four-step public API
  invert_input_image -> generate_input_image -> set_foreground ->
  transform_foreground
with the same NCHW contracts ([1, 1, H, W] depths, [1, 3, H, W] images in
[0, 1], [T, C, H, W] activation stacks). Inputs may be numpy arrays or
tensors. Images and disparities come back as numpy; the null-text
embeddings, noise, activation stacks and latents stay on the device as
tensors, since the next step consumes them there.

Precision: the U-Net and VAE run in the config's `dtype` (bf16 by
default), CLIP and the geometry in fp32. On a CUDA device, set
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False` to keep the fp32 parts in full
fp32 (chip_smoke.py does); PyTorch's default lets cuDNN run fp32
convolutions in TF32.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Union

import numpy as np
import torch

from diffusionhandles_tpu_torch.config import (DiffusionHandlesConfig,
                                               config_from_dict, load_config)
from diffusionhandles_tpu_torch.diffuser import GuidedStableDiffuser, SDModels
from diffusionhandles_tpu_torch.geometry.depth import normalize_depth
from diffusionhandles_tpu_torch.geometry.transform import (
    transform_depth, transform_depth_pc_processed)
from diffusionhandles_tpu_torch.inverter import StableNullInverter
from diffusionhandles_tpu_torch.ops.poisson import harmonize_depth
from diffusionhandles_tpu_torch.utils.device import resolve_device
from diffusionhandles_tpu_torch.utils.profiling import request, span


def _same(a, b) -> bool:
    if a is b:
        return True
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    if a.shape != b.shape:
        return False
    with span("sync.same_recording"):
        return bool(torch.equal(a, b))


class DiffusionHandles:
    """Training-free 3D-aware image editing (PyTorch).

    Runs on the GPU unless `device` says otherwise. The model family is
    the config's `model_paths.model_name` (SD-2-depth, or SDXL base 1.0
    with the depth ControlNet). `models` (from
    `diffuser.create_sd_models`) replaces the seeded SD stack, e.g. with
    one built on the fused GroupNorm U-Net config."""

    def __init__(self, conf: Optional[Union[DiffusionHandlesConfig, str,
                                            dict]] = None,
                 variant: str = "sd2", device=None,
                 models: Optional[SDModels] = None):
        if conf is None or isinstance(conf, (str, pathlib.Path)):
            conf = load_config(conf)
        elif isinstance(conf, dict):
            conf = config_from_dict(conf)
        self.conf = conf
        self.device = resolve_device(device)
        self.diffuser = GuidedStableDiffuser(
            conf.guided_diffuser, models=models,
            model_paths=conf.model_paths, variant=variant,
            device=self.device)
        # the inversion rolls forward at the CFG scale the guided pass
        # replays with
        self.inverter = StableNullInverter(
            self.diffuser,
            guidance_scale=conf.guided_diffuser.guidance_scale)
        self.img_res = self.diffuser.image_res
        self._recording = None

    def to(self, device=None):
        """Move the SD models to `device` (reference:
        diffusion_handles.py:27-34); None keeps the current one. The
        handles then run there. Returns self."""
        if device is None:
            return self
        device = torch.device(device)
        d = self.diffuser
        for m in d.models.modules():
            m.to(device)
        if d.time_ids is not None:
            d.time_ids = d.time_ids.to(device)
        d.device = self.device = device
        d._prompt_cache.clear()
        self._recording = None
        return self

    def _tensor(self, x) -> torch.Tensor:
        # in the standard layout: a caller's strided array (an image read
        # as HWC and transposed) would otherwise take other conv
        # algorithms, and other bits, than the same values packed
        with span("sync.host_inputs"):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=self.device).contiguous()

    def _disparity(self, depth) -> torch.Tensor:
        return normalize_depth(1.0 / self._tensor(depth))

    def invert_input_image(self, img, depth, prompt: str):
        """Invert an input image (reference: diffusion_handles.py:36-56).

        img [1, 3, H, W] in [0, 1]; depth [1, 1, H, W] (depth, not
        disparity). Returns (null_text_emb [T, 1, 77, D],
        init_noise [1, 4, h, w]) as device tensors."""
        with request("invert"):
            fused = self.conf.guided_diffuser.fused_recording
            out = self.inverter.invert(self._tensor(img),
                                       self._disparity(depth), prompt,
                                       num_inner_steps=5,
                                       record_activations=fused,
                                       return_recon=False)
            _, init_noise, null_text_emb = out[:3]
            if fused:
                acts, final_latents = out[3]
                self._recording = {
                    "prompt": prompt, "depth": np.asarray(depth, np.float32),
                    "null": null_text_emb, "noise": init_noise,
                    "acts": acts, "latents": final_latents}
            return null_text_emb, init_noise

    def generate_input_image(self, depth, prompt: str, null_text_emb=None,
                             init_noise=None):
        """Reconstruction pass that records the guidance activations
        (reference: diffusion_handles.py:58-88). When the inputs are those
        of the last fused-recording inversion, its capture is served.

        Returns (null_text_emb [T, 1, 77, D], init_noise [1, 4, h, w],
        activations: a stack [T, C, H, W] per recorded up block, latents
        [1, 4, h, w])."""
        with request("record"):
            rec = self._recording
            if (rec is not None and self.conf.guided_diffuser.fused_recording
                    and null_text_emb is not None and init_noise is not None
                    and prompt == rec["prompt"]
                    and np.array_equal(np.asarray(depth, np.float32),
                                       rec["depth"])
                    and _same(null_text_emb, rec["null"])
                    and _same(init_noise, rec["noise"])):
                return (rec["null"], rec["noise"], list(rec["acts"]),
                        rec["latents"])
            acts, latents, uncond, init_latents = \
                self.diffuser.initial_inference(
                    init_latents=init_noise, depth=self._disparity(depth),
                    uncond_embeddings=null_text_emb, prompt=prompt)
            return uncond[:, None], init_latents, acts, latents

    def set_foreground(self, depth, fg_mask, bg_depth) -> np.ndarray:
        """Infill the foreground hole of the input depth from the bg
        depth's Laplacian inside the 15x-dilated foreground mask
        (reference: diffusion_handles.py:90-111). Returns [1, 1, H, W]."""
        hw = (np.shape(depth)[-2], np.shape(depth)[-1])
        depth2d = self._tensor(depth).reshape(hw)
        bg2d = self._tensor(bg_depth).reshape(hw)
        mask2d = self._tensor(fg_mask).reshape(hw) > 0.5
        out = harmonize_depth(depth2d, bg2d, mask2d)
        with span("sync.set_foreground_to_host"):
            return out.cpu().numpy()[None, None]

    def transform_foreground(self, depth, prompt: str, fg_mask, bg_depth,
                             null_text_emb, init_noise, activations,
                             rot_angle: Optional[float] = None,
                             rot_axis=None, translation=None,
                             fg_weight: Optional[float] = None,
                             bg_weight: Optional[float] = None,
                             use_input_depth_normalization: bool = False):
        """3D-transform the foreground and re-generate
        (reference: diffusion_handles.py:113-166).

        Returns (edited image [1, 3, H, W] in [0, 1], edited disparity
        [1, 1, H, W]) as numpy and, with save_denoising_steps, the
        per-step decodes ({"opt": [(img_opt, img_step)] * T}, numpy
        [1, H, W, 3]) as a third item."""
        with request("edit"):
            gconf = self.conf.guided_diffuser
            intrinsics = self.diffuser.get_depth_intrinsics()
            edit = dict(rot_angle=rot_angle, rot_axis=rot_axis,
                        translation=translation,
                        use_input_depth_normalization=(
                            use_input_depth_normalization))
            with span("depth_transform"):
                if self.conf.depth_transform_mode == "pc":
                    # correspondence binning on the device: no per-point
                    # host trip
                    edited_disparity, pc = transform_depth_pc_processed(
                        depth=depth, bg_depth=bg_depth, fg_mask=fg_mask,
                        intrinsics=intrinsics, bg_erosion=gconf.bg_erosion,
                        max_corr=gconf.max_correspondences,
                        latent_res=self.diffuser.latent_res,
                        device=self.device, **edit)
                    correspondences = None
                else:
                    edited_disparity, correspondences = transform_depth(
                        depth=depth, bg_depth=bg_depth, fg_mask=fg_mask,
                        intrinsics=intrinsics,
                        depth_transform_mode=self.conf.depth_transform_mode,
                        device=self.device, **edit)
                    pc = None
            results = self.diffuser.guided_inference(
                latents=init_noise, depth=edited_disparity,
                uncond_embeddings=null_text_emb, prompt=prompt,
                activations_orig=activations,
                correspondences=correspondences,
                processed_correspondences=pc, fg_weight=fg_weight,
                bg_weight=bg_weight,
                save_denoising_steps=gconf.save_denoising_steps)
            with span("sync.disparity_to_host"):
                disparity = edited_disparity.cpu().numpy()
            edited = results[0] if gconf.save_denoising_steps else results
            with span("sync.image_to_host"):
                image = edited.cpu().numpy()
            if gconf.save_denoising_steps:
                return image, disparity, results[1]
            return image, disparity
