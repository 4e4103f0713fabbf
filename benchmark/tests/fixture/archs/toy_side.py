"""A model family that the SD-2 builders cannot express, named by no
harness code: the port's tiny U-Net with four input channels inside a
wrapper that adds a side network's residual, made from the
image-resolution depth map, to the U-Net's input features (as a ControlNet
adds its residuals to the U-Net's) and a projected pooled text vector to
its time embedding (as SDXL's added conditioning does). The port's U-Net
has no inputs for either, so the wrapper adds them through forward hooks
on its `conv_in` and on its time embedding's last linear layer.

A configuration of this family (`"arch": "toy_side"`) holds the U-Net's
widths under "denoiser", the side network's under "side", the text
tower's under "text" and the sampler's settings under "sampler"; the
reference is `reference/toy_side.py` beside this folder.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict

import torch
from torch import nn

from benchmark import check, harness
from benchmark.reference.pipeline import RefDDIMSchedule, hash_token_ids
from benchmark.reference.sd import RefUNetConfig
from benchmark.tap import UNetTap

FIXTURE = pathlib.Path(__file__).resolve().parents[1]


def image_res(cfg: dict) -> int:
    """The image's side in pixels (the depth map's)."""
    return cfg["image_res"]


def _unet_fields(cfg: dict) -> dict:
    d = cfg["denoiser"]
    return dict(sample_size=d["sample_size"], in_channels=d["in_channels"],
                out_channels=d["out_channels"],
                block_out_channels=tuple(d["block_out_channels"]),
                down_block_types=tuple(d["down_block_types"]),
                up_block_types=tuple(d["up_block_types"]),
                layers_per_block=d["layers_per_block"],
                num_heads=tuple(d["attention_head_dim"]),
                cross_attention_dim=d["cross_attention_dim"],
                norm_num_groups=d["norm_num_groups"])


class TextTower(nn.Module):
    """Token ids [B,77] -> (the context [B,77,D] after a LayerNorm, its
    mean over the tokens, the pooled vector [B,D])."""

    def __init__(self, cfg: dict):
        super().__init__()
        t = cfg["text"]
        self.token_embedding = nn.Embedding(t["vocab_size"], t["width"])
        self.final_layer_norm = nn.LayerNorm(t["width"])

    def forward(self, ids):
        x = self.final_layer_norm(self.token_embedding(ids))
        return x, x.mean(1)


class SideDenoiser(nn.Module):
    """(sample [B,4,h,w], timestep, context [B,77,D], depth [B,1,H,W],
    pooled [B,D]) -> the U-Net's (eps, activations, attn)."""

    def __init__(self, cfg: dict):
        from diffusionhandles_tpu_torch.models.unet import (
            UNet2DConditionModel, tiny_unet_config)
        super().__init__()
        self.unet = UNet2DConditionModel(tiny_unet_config(**_unet_fields(
            cfg)))
        ch0 = cfg["denoiser"]["block_out_channels"][0]
        widths = [1] + list(cfg["side"]["channels"]) + [ch0]
        layers = []
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            if i:
                layers.append(nn.SiLU())
            layers.append(nn.Conv2d(a, b, 3, stride=2, padding=1))
        self.side = nn.Sequential(*layers)
        self.pooled_proj = nn.Linear(cfg["text"]["width"], 4 * ch0)
        self._added = None
        self.unet.conv_in.register_forward_hook(
            lambda mod, args, out: out + self._added[0])
        self.unet.time_embedding.linear_2.register_forward_hook(
            lambda mod, args, out: out + self._added[1])

    def forward(self, sample, timestep, context, depth, pooled):
        self._added = (self.side(depth), self.pooled_proj(pooled))
        try:
            return self.unet(sample, timestep, context)
        finally:
            self._added = None


@dataclasses.dataclass
class SideProgram:
    """The program's handles: the denoiser, the text tower and its
    tokenizer."""

    denoiser: SideDenoiser
    text: TextTower
    tokenizer: object
    device: torch.device

    def encode(self, prompts):
        ids = torch.tensor(self.tokenizer(prompts), device=self.device)
        with torch.no_grad():
            return self.text(ids)


def program_modules(cfg: dict):
    with torch.device("meta"):
        mods = {"denoiser": SideDenoiser(cfg), "text": TextTower(cfg)}
    return mods, None


def program_handles(cfg: dict, weights: Dict[str, dict], device):
    from diffusionhandles_tpu_torch.models.tokenizer import load_tokenizer
    mods, _ = program_modules(cfg)
    for name, mod in mods.items():
        mod.load_state_dict(weights[name], strict=True, assign=True)
        mod.eval().requires_grad_(False)
    t = cfg["text"]
    tok = load_tokenizer(None, max_length=t["max_length"],
                         vocab_size=t["vocab_size"])
    return SideProgram(mods["denoiser"], mods["text"], tok,
                       torch.device(device))


def tap(cfg: dict) -> UNetTap:
    """The tap at `SideDenoiser.__call__`, not at the U-Net inside it: the
    latents are the whole sample."""
    names = ("sample", "timestep", "context", "depth", "pooled")

    def parse(args, kwargs):
        a = dict(zip(names, args), **kwargs)
        return (a["sample"].detach(), a["timestep"],
                (a["sample"], a["context"], a["pooled"]))
    return UNetTap(SideDenoiser, parse)


@dataclasses.dataclass
class Reference:
    denoiser: nn.Module
    pooled: torch.Tensor  # [2, D]: the prompt's, the empty prompt's


def reference_models(cfg: dict, weights=None, device="meta"):
    """The reference's denoiser and text tower, float32, on the meta
    device, or on `device` holding `weights`."""
    ref = harness.load_module("reference", "toy_side", FIXTURE)
    t = cfg["text"]
    with torch.device("meta"):
        den = ref.RefSideDenoiser(RefUNetConfig(**_unet_fields(cfg)),
                                  cfg["side"]["channels"], t["width"])
        text = ref.RefTextTower(t["vocab_size"], t["width"])
    if weights is not None:
        for mod, sd in ((den, weights["denoiser"]), (text, weights["text"])):
            mod.to_empty(device=device).float()
            mod.load_state_dict(sd, strict=True)
    for mod in (den, text):
        mod.eval().requires_grad_(False)
    return den, text


def shared(cfg: dict, weights: Dict[str, dict], prompt: str,
           device) -> check.Shared:
    """The float32 reference on `weights`, and the prompt and the empty
    prompt through its text tower."""
    den, text = reference_models(cfg, weights, device)
    t = cfg["text"]
    ids = torch.tensor([hash_token_ids(p, t["vocab_size"], t["max_length"])
                        for p in (prompt, "")], device=device)
    with torch.no_grad():
        ctx, pooled = text(ids)
    sched = RefDDIMSchedule(cfg["sampler"]["num_timesteps"])
    return check.Shared(cfg, Reference(den, pooled), sched, ctx[:1],
                        ctx[1:], torch.device(device))
