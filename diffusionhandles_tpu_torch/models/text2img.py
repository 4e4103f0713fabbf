"""Text-to-image generation (SD-2.1 class) on the diffusion stack.

The counterpart of the JAX package's `models/text2img.py` (the role of the
reference's StableDiffusion text2img service, reference:
webapp/webapps/stablediff_text2img_webapp.py:32-60 and the abstract base
webapp/webapps/text2img_webapp.py): classifier-free-guidance DDIM over the
depth-free U-Net, the JAX package's `lax.scan` a Python loop here. Each
step is one batch-2 [uncond, cond] U-Net pass, whose self-attention takes
the flash kernel (K1, csrc/flash_fwd.cu) on the card in bf16, as the
edit's CFG step does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.config import (GuidedDiffuserConfig,
                                               ModelPathsConfig)
from diffusionhandles_tpu_torch.diffuser import GuidedStableDiffuser, SDModels
from diffusionhandles_tpu_torch.scheduler import ddim_step
from diffusionhandles_tpu_torch.utils.rng import seeded_randn


class Text2Img:
    """Service-level interface (reference: text2img_webapp.py)."""

    def generate(self, prompt: str, seed: int = 0) -> np.ndarray:
        raise NotImplementedError


class StableText2Img(Text2Img):
    """CFG DDIM text2img on `device` (default: the GPU), with
    use_depth=False (the SD-2.1 base layout)."""

    def __init__(self, conf: Optional[GuidedDiffuserConfig] = None,
                 models: Optional[SDModels] = None,
                 model_paths: Optional[ModelPathsConfig] = None,
                 variant: str = "sd2", device=None):
        conf = conf or GuidedDiffuserConfig(use_depth=False)
        self.diffuser = GuidedStableDiffuser(conf, models=models,
                                             model_paths=model_paths,
                                             variant=variant, device=device)

    @torch.no_grad()
    def generate(self, prompt: str, seed: int = 0) -> np.ndarray:
        """prompt -> image [1, 3, H, W] float32 in [0, 1]."""
        d = self.diffuser
        lat_ch = (d.models.unet_config.in_channels
                  - (1 if d.conf.use_depth else 0))
        latents = seeded_randn((1, lat_ch, d.latent_res, d.latent_res), seed,
                               d.conf.noise_rng, device=d.device)
        ctx = torch.cat([d.encode_prompt(""), d.encode_prompt(prompt)])
        gs = d.conf.guidance_scale
        for i in range(d.schedule.num_inference_steps):
            lat2 = torch.cat([latents, latents], dim=0)
            eps, _, _ = d.models.unet(d.unet_in(lat2, None), d.timestep(i),
                                      ctx)
            noise_pred = eps[0] + gs * (eps[1] - eps[0])
            latents = ddim_step(d.schedule, noise_pred[None], i, latents)
        return d.decode_latent_image(latents).cpu().numpy()
