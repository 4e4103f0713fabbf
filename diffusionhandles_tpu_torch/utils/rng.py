"""Seeded noise with reference parity.

The reference seeds torch's CPU Mersenne Twister and samples the initial
latent noise on the host, then moves it to the accelerator
(reference: diffhandles/guided_stable_diffuser.py:159,197-200). Noise is
therefore always drawn from a CPU `torch.Generator`, never a CUDA one, so
that a seed gives the same numbers on every device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def seeded_randn(shape: Sequence[int], seed: int,
                 method: str = "torch_cpu",
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard-normal float32 noise from a seeded CPU generator, moved to
    `device` (CPU when None)."""
    if method != "torch_cpu":
        raise ValueError(f"Unknown noise rng method '{method}'")
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    noise = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return noise if device is None else noise.to(device)
