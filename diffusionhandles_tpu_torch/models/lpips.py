"""LPIPS perceptual distance (VGG16 backbone).

The counterpart of the JAX package's `models/lpips.py`: VGG16 feature
stacks at relu{1_2, 2_2, 3_3, 4_3, 5_3}, unit-normalized along channels,
squared differences weighted by the learned 1x1 "lin" heads, averaged over
space and summed over layers. Weights come from the released torchvision
VGG16 and LPIPS lin checkpoints (`convert_lpips_weights`) or from the JAX
package's parameters (`lpips_state_dict`); with seeded random weights the
measure is a deterministic perceptual-feature distance, not a calibrated
one. NCHW, fp32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.utils.device import resolve_device

# VGG16's conv plan: (channels, convs) per stage; a feature is tapped at
# each stage's last relu
_VGG_STAGES: Tuple[Tuple[int, int], ...] = ((64, 2), (128, 2), (256, 3),
                                            (512, 3), (512, 3))
# torchvision's `features.<i>` index of each of the 13 convs
_TORCHVISION_CONV_IDS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class VGG16Features(nn.Module):
    """The 13 3x3 convs of VGG16 as `conv_<i>`."""

    def __init__(self):
        super().__init__()
        cin = 3
        idx = 0
        for ch, n_convs in _VGG_STAGES:
            for _ in range(n_convs):
                self.add_module(f"conv_{idx}", nn.Conv2d(cin, ch, 3,
                                                         padding=1))
                cin = ch
                idx += 1

    def forward(self, x) -> List[torch.Tensor]:
        """x [B, 3, H, W] normalized; returns the 5 feature maps."""
        feats = []
        idx = 0
        for stage, (_, n_convs) in enumerate(_VGG_STAGES):
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv_{idx}")(x))
                idx += 1
            feats.append(x)
            if stage < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_STAGES):
            setattr(self, f"lin_{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("mean", torch.tensor(
            [0.485, 0.456, 0.406]).reshape(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(
            [0.229, 0.224, 0.225]).reshape(1, 3, 1, 1), persistent=False)

    def forward(self, a, b) -> torch.Tensor:
        """a, b: [B, 3, H, W] in [0, 1]. Returns [B] distances."""
        fa = self.vgg((a - self.mean) / self.std)
        fb = self.vgg((b - self.mean) / self.std)
        total = 0.0
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True)
                       + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True)
                       + 1e-10)
            w = getattr(self, f"lin_{i}").abs()[None, :, None, None]
            total = total + ((na - nb) ** 2 * w).sum(1).mean((1, 2))
        return total


def seeded_init_lpips_(model: LPIPS, generator: torch.Generator) -> LPIPS:
    """Seeded random VGG weights (normal, variance 1 / fan_in: the scale
    of flax's default init, which the JAX package's random LPIPS takes),
    zero biases and unit lin heads."""
    with torch.no_grad():
        for mod in model.vgg.children():
            fan_in = mod.in_channels * 9
            mod.weight.copy_(torch.randn(
                mod.weight.shape, generator=generator,
                device=mod.weight.device) / float(np.sqrt(fan_in)))
            mod.bias.zero_()
    return model


class LPIPSMetric:
    """LPIPS on `device` (default: the GPU): weights from `params` (this
    module's state dict, from `convert_lpips_weights` or
    `lpips_state_dict`), else seeded random."""

    def __init__(self, params=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = LPIPS()
        if params is None:
            seeded_init_lpips_(self.model, torch.Generator(
                device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    @torch.no_grad()
    def __call__(self, a: np.ndarray, b: np.ndarray) -> float:
        """a, b: [C, H, W] or [1, C, H, W] images in [0, 1]."""
        a = torch.as_tensor(np.ascontiguousarray(a, np.float32),
                            device=self.device)
        b = torch.as_tensor(np.ascontiguousarray(b, np.float32),
                            device=self.device)
        if a.ndim == 3:
            a, b = a[None], b[None]
        return float(self.model(a, b)[0])


def convert_lpips_weights(vgg_state: dict, lin_state: dict) -> dict:
    """Map torchvision VGG16 `features.*` conv weights and the LPIPS
    `lin<i>.model.1` 1x1 weights into this module's state dict."""
    sd = {}
    for i, cid in enumerate(_TORCHVISION_CONV_IDS):
        sd[f"vgg.conv_{i}.weight"] = torch.as_tensor(
            np.asarray(vgg_state[f"features.{cid}.weight"], np.float32))
        sd[f"vgg.conv_{i}.bias"] = torch.as_tensor(
            np.asarray(vgg_state[f"features.{cid}.bias"], np.float32))
    for i in range(len(_VGG_STAGES)):
        w = np.asarray(lin_state[f"lin{i}.model.1.weight"], np.float32)
        sd[f"lin_{i}"] = torch.from_numpy(w.reshape(-1).copy())
    return sd


def lpips_state_dict(params: dict) -> dict:
    """The JAX package's LPIPS parameters ({"params": {"vgg": {"conv_<i>":
    {"kernel" HWIO, "bias"}}, "lin_<i>": [C]}}) as this module's state
    dict, so both packages run one set of weights."""
    p = params.get("params", params)
    sd = {}
    for name, conv in p["vgg"].items():
        sd[f"vgg.{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(conv["kernel"], np.float32),
                         (3, 2, 0, 1))))
        sd[f"vgg.{name}.bias"] = torch.from_numpy(np.asarray(
            conv["bias"], np.float32).copy())
    for i in range(len(_VGG_STAGES)):
        sd[f"lin_{i}"] = torch.from_numpy(np.asarray(
            p[f"lin_{i}"], np.float32).copy())
    return sd
