"""DDIM scheduler.

diffusers' DDIMScheduler as the reference configures it
(reference: diffhandles/guided_stable_diffuser.py:31-32): scaled-linear
betas 0.00085..0.012, 1000 training steps, 'leading' spacing,
set_alpha_to_one=False, eta=0, epsilon prediction; plus the inverter's
closed-form prev/next steps (reference: stable_null_inverter.py:25-43).

The tables are built on the host in float64 and stored as float32, exactly
as the JAX package's `scheduler.py` builds them; the step functions take the
denoising step index as a Python int and work on tensors of any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DDIMSchedule(NamedTuple):
    """Precomputed DDIM tables for a fixed number of inference steps.

    `timesteps` is ordered high->low (denoising order); `alpha_t[s]` and
    `alpha_prev[s]` are the cumulative alphas of denoising step s and of
    the step it lands on.
    """

    num_train_timesteps: int
    num_inference_steps: int
    timesteps: np.ndarray
    alphas_cumprod: np.ndarray
    final_alpha_cumprod: float
    alpha_t: np.ndarray
    alpha_prev: np.ndarray


def make_ddim_schedule(num_inference_steps: int = 50,
                       num_train_timesteps: int = 1000,
                       beta_start: float = 0.00085,
                       beta_end: float = 0.012) -> DDIMSchedule:
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    final_alpha_cumprod = float(alphas_cumprod[0])
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()
    timesteps = timesteps[::-1].copy().astype(np.int64)
    prev_timesteps = timesteps - step_ratio
    alpha_t = alphas_cumprod[timesteps]
    alpha_prev = np.where(prev_timesteps >= 0,
                          alphas_cumprod[np.clip(prev_timesteps, 0, None)],
                          final_alpha_cumprod)
    return DDIMSchedule(
        num_train_timesteps=num_train_timesteps,
        num_inference_steps=num_inference_steps,
        timesteps=timesteps,
        alphas_cumprod=alphas_cumprod.astype(np.float32),
        final_alpha_cumprod=final_alpha_cumprod,
        alpha_t=alpha_t.astype(np.float32),
        alpha_prev=alpha_prev.astype(np.float32),
    )


def _transition(sample, eps, alpha_from, alpha_to):
    # coefficients in float32 on the host (IEEE sqrt is exact-rounded, so
    # these equal the JAX package's on-device float32 values)
    a_from, a_to = np.float32(alpha_from), np.float32(alpha_to)
    one = np.float32(1.0)
    sample = sample.float()
    eps = eps.float()
    pred_x0 = (sample - float(np.sqrt(one - a_from)) * eps) / float(
        np.sqrt(a_from))
    return (float(np.sqrt(a_to)) * pred_x0
            + float(np.sqrt(one - a_to)) * eps)


def ddim_step(schedule: DDIMSchedule, eps, step_idx: int, sample):
    """One deterministic DDIM denoising step x_t -> x_{t-1} at denoising
    index `step_idx` (0 = noisiest)."""
    return _transition(sample, eps, schedule.alpha_t[step_idx],
                       schedule.alpha_prev[step_idx])


def ddim_next_step(schedule: DDIMSchedule, eps, step_idx: int, sample):
    """One inversion step at inversion iteration `step_idx`: the reference
    visits `timesteps[S - 1 - i]`, whose (alpha_prev, alpha_t) pair is the
    (current, next) pair of the inversion step."""
    s = schedule.num_inference_steps - 1 - step_idx
    return _transition(sample, eps, schedule.alpha_prev[s],
                       schedule.alpha_t[s])


def add_noise(schedule: DDIMSchedule, sample, noise, timestep: int):
    """q-sample: sqrt(a_t) x0 + sqrt(1-a_t) eps (diffusers add_noise)."""
    alpha = np.float32(schedule.alphas_cumprod[timestep])
    return (float(np.sqrt(alpha)) * sample.float()
            + float(np.sqrt(np.float32(1.0) - alpha)) * noise.float())


def scale_model_input(sample, timestep=None):
    """DDIM does not rescale model inputs: the identity, as in diffusers'
    DDIMScheduler."""
    del timestep
    return sample
