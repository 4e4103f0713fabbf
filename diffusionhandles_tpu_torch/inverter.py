"""Null-text inversion.

The counterpart of the JAX package's `inverter.py` (reference:
diffhandles/stable_null_inverter.py):

* `ddim_loop` (reference :112-122): forward-noising steps driven by the
  cond-only eps prediction.
* `null_optimization` (reference :135-167): per timestep, a fresh Adam on
  the uncond embedding with lr 1e-2 * (1 - i/100) runs up to
  `num_inner_steps` U-Net forward+backward iterations, stopping as soon as
  the previous iteration's loss fell below epsilon + i * 2e-5 (the JAX
  while_loop's condition `j == 0 or loss >= thresh`, evaluated on the same
  float32 values); then the CFG step rolls the latent forward. With
  `record`, the conditional pass's decoder activations are captured on the
  way: that trajectory is exactly the recording reconstruction's.

In the SDXL family the cond passes take the prompt's pooled vector and the
uncond passes zeros; the null-text optimisation moves the context alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.diffuser import GuidedStableDiffuser
from diffusionhandles_tpu_torch.scheduler import ddim_next_step, ddim_step
from diffusionhandles_tpu_torch.utils.profiling import span


class NullInverter:
    """Abstract inverter (reference: diffhandles/null_inverter.py)."""

    def __init__(self, model):
        self.model = model

    def invert(self, target_img, depth, prompt, **kwargs):
        raise NotImplementedError


class StableNullInverter(NullInverter):

    def __init__(self, model: GuidedStableDiffuser,
                 num_ddim_steps: Optional[int] = None,
                 guidance_scale: float = 7.5):
        super().__init__(model)
        self.num_ddim_steps = (num_ddim_steps
                               or model.schedule.num_inference_steps)
        if self.num_ddim_steps != model.schedule.num_inference_steps:
            raise ValueError(
                f"num_ddim_steps={self.num_ddim_steps} must equal the "
                f"model schedule's num_inference_steps="
                f"{model.schedule.num_inference_steps} (configure "
                f"GuidedDiffuserConfig.num_timesteps)")
        self.guidance_scale = guidance_scale

    @torch.no_grad()
    def ddim_loop(self, latent0, depth64, cond,
                  pooled=None) -> torch.Tensor:
        """[S+1, 1, 4, h, w]: latent0 followed by the S noised latents."""
        S = self.num_ddim_steps
        traj = [latent0]
        latent = latent0
        for i in range(S):
            with span("invert.ddim_step"):
                eps = self.model.denoise(latent, depth64, S - 1 - i, cond,
                                         pooled)[0]
                latent = ddim_next_step(self.model.schedule, eps, i, latent)
            traj.append(latent)
        return torch.stack(traj)

    def null_optimization(self, latents_traj, depth64, uncond0, cond,
                          num_inner_steps: int, epsilon: float,
                          record: bool = False, verbose: bool = False,
                          pooled=None):
        """Optimize the per-step null-text embeddings (with `verbose`,
        print each timestep's inner iterations and last loss; `pooled`:
        SDXL's pooled vector of the cond row).

        Returns uncond_seq [S, 1, 77, D] and, with `record`, also the
        activation stacks [S, C, H, W] and the final latent."""
        upooled = None if pooled is None else torch.zeros_like(pooled)
        m = self.model
        S = self.num_ddim_steps
        gs = self.guidance_scale
        schedule = m.schedule
        latent_cur = latents_traj[S]
        uncond = uncond0.detach()
        uncond_seq, recorded = [], []
        for i in range(S):
            latent_prev = latents_traj[S - 1 - i]
            # float32 arithmetic of the JAX loop (lr and threshold)
            lr = float(np.float32(1e-2) * (np.float32(1.0)
                                           - np.float32(i) / np.float32(100)))
            thresh = float(np.float32(epsilon)
                           + np.float32(i) * np.float32(2e-5))
            with span("null_text.step"):
                with torch.no_grad():
                    eps_cond, cond_acts, _ = m.denoise(latent_cur, depth64,
                                                       i, cond, pooled)
                if record:
                    recorded.append([a[0].to(m.act_dtype)
                                     for a in cond_acts])

                uncond = uncond.detach().clone().requires_grad_(True)
                opt = torch.optim.Adam([uncond], lr=lr)
                j, last_loss = 0, float("inf")
                while j < num_inner_steps and (j == 0 or last_loss >= thresh):
                    with span("null_text.inner"):
                        with torch.enable_grad():
                            eps_u = m.denoise(latent_cur, depth64, i,
                                              uncond, upooled)[0]
                            eps = eps_u + gs * (eps_cond - eps_u)
                            rec = ddim_step(schedule, eps, i, latent_cur)
                            loss = torch.mean((rec - latent_prev) ** 2)
                            opt.zero_grad(set_to_none=True)
                            with span("null_text.backward"):
                                loss.backward()
                        with span("null_text.adam"):
                            opt.step()
                        # the data-dependent early stop
                        with span("sync.null_text_loss"):
                            last_loss = loss.item()
                    j += 1
                if verbose:
                    print(f"null-text step {i + 1}/{S}: {j} iterations, "
                          f"loss {last_loss:.3e}", flush=True)
                uncond = uncond.detach()
                with torch.no_grad():
                    eps_u = m.denoise(latent_cur, depth64, i, uncond,
                                      upooled)[0]
                    eps = eps_u + gs * (eps_cond - eps_u)
                    latent_cur = ddim_step(schedule, eps, i, latent_cur)
            uncond_seq.append(uncond)
        uncond_seq = torch.stack(uncond_seq)
        if not record:
            return uncond_seq
        stacks = [torch.stack([r[k] for r in recorded])
                  for k in range(len(recorded[0]))]
        return uncond_seq, stacks, latent_cur

    def invert(self, target_img, depth, prompt: str,
               num_inner_steps: int = 10, early_stop_epsilon: float = 1e-5,
               verbose: bool = False, record_activations: bool = False,
               return_recon: bool = True):
        """Invert an image [1, 3, H, W] in [0, 1] to (init noise, per-step
        null embeddings).

        Returns ((target_img, recon_img), init_noise [1, 4, h, w],
        uncond_seq [S, 1, 77, D]) and, with `record_activations`, a fourth
        element (activation stacks, final latents)."""
        m = self.model
        depth64 = m.depth_cond(depth) if m.conf.use_depth else None
        uncond, cond = m.init_prompt(prompt)
        pooled = m.pooled_prompt(prompt)
        latent0 = m.encode_latent_image(target_img)
        recon_img = m.decode_latent_image(latent0) if return_recon else None
        traj = self.ddim_loop(latent0, depth64, cond, pooled)
        out = self.null_optimization(traj, depth64, uncond, cond,
                                     num_inner_steps, early_stop_epsilon,
                                     record=record_activations,
                                     verbose=verbose, pooled=pooled)
        init_noise = traj[self.num_ddim_steps]
        if record_activations:
            uncond_seq, acts, final_latents = out
            return ((target_img, recon_img), init_noise, uncond_seq,
                    (acts, final_latents))
        return (target_img, recon_img), init_noise, out
