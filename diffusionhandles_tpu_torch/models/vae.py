"""AutoencoderKL (the SD-2 VAE), NCHW, diffusers module names.

The counterpart of the JAX package's `models/vae.py`: deterministic
encode to the posterior mean and decode back to [-1, 1] images, with dense
single-head attention in the mid blocks. Numerics as the JAX module:
parameters in `param_dtype`, convs in `dtype`, GroupNorm in fp32, the
decoder's output conv in fp32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.models.unet import (Conv2d, GroupNorm, Linear,
                                                    ResnetBlock2D, gn_silu)
from diffusionhandles_tpu_torch.ops.attention import dot_product_attention

SD_VAE_SCALING = 0.18215  # reference: stable_null_inverter.py:75,108


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = SD_VAE_SCALING
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def downscale_factor(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)


def tiny_vae_config(**overrides) -> VAEConfig:
    base = dict(block_out_channels=(16, 16, 32), layers_per_block=1,
                norm_num_groups=8, dtype=torch.float32)
    base.update(overrides)
    return VAEConfig(**base)


def _resnet(in_ch, out_ch, cfg: VAEConfig):
    return ResnetBlock2D(in_ch, out_ch, None, cfg.norm_num_groups, 1e-6,
                         cfg.dtype, cfg.param_dtype)


class VAEAttention(nn.Module):
    """Single-head self-attention over the spatial grid (VAE mid block)."""

    def __init__(self, channels: int, cfg: VAEConfig):
        super().__init__()
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.dtype = dt
        self.group_norm = GroupNorm(cfg.norm_num_groups, channels, eps=1e-6,
                                    dtype=pdt)
        self.to_q = Linear(channels, channels, dtype=dt, param_dtype=pdt)
        self.to_k = Linear(channels, channels, dtype=dt, param_dtype=pdt)
        self.to_v = Linear(channels, channels, dtype=dt, param_dtype=pdt)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype=dt,
                                            param_dtype=pdt)])

    def forward(self, x):
        b, c, h, w = x.shape
        hid = self.group_norm(x).to(self.dtype).permute(0, 2, 3, 1).reshape(
            b, h * w, c)
        q = self.to_q(hid)[:, :, None, :]
        k = self.to_k(hid)[:, :, None, :]
        v = self.to_v(hid)[:, :, None, :]
        out = self.to_out[0](dot_product_attention(q, k, v)[:, :, 0, :])
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, cfg: VAEConfig):
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(channels, channels, cfg)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, cfg)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class VAEDownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, add_down: bool, cfg: VAEConfig):
        super().__init__()
        self.resnets = nn.ModuleList([
            _resnet(in_ch if i == 0 else out_ch, out_ch, cfg)
            for i in range(cfg.layers_per_block)])
        if add_down:
            # diffusers pads (0, 1, 0, 1) ahead of an unpadded stride-2 conv
            self.downsamplers = nn.ModuleList([nn.Module()])
            self.downsamplers[0].conv = Conv2d(
                out_ch, out_ch, 3, stride=2, padding=0, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype)
        else:
            self.downsamplers = None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class VAEUpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, add_up: bool, cfg: VAEConfig):
        super().__init__()
        self.resnets = nn.ModuleList([
            _resnet(in_ch if i == 0 else out_ch, out_ch, cfg)
            for i in range(cfg.layers_per_block + 1)])
        if add_up:
            self.upsamplers = nn.ModuleList([nn.Module()])
            self.upsamplers[0].conv = Conv2d(
                out_ch, out_ch, 3, padding=1, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype)
        else:
            self.upsamplers = None

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0].conv(
                F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        chs = cfg.block_out_channels
        n = len(chs)
        self.conv_in = Conv2d(cfg.in_channels, chs[0], 3, padding=1,
                              dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.down_blocks = nn.ModuleList([
            VAEDownBlock(chs[max(i - 1, 0)], ch, i < n - 1, cfg)
            for i, ch in enumerate(chs)])
        self.mid_block = VAEMidBlock(chs[-1], cfg)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chs[-1],
                                       eps=1e-6, dtype=cfg.param_dtype)
        self.conv_out = Conv2d(chs[-1], 2 * cfg.latent_channels, 3,
                               padding=1, dtype=cfg.dtype,
                               param_dtype=cfg.param_dtype)

    def forward(self, x):
        x = self.conv_in(x.to(self.dtype))
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(gn_silu(self.conv_norm_out, x, self.dtype))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.dtype = cfg.dtype
        rev = list(reversed(cfg.block_out_channels))
        n = len(rev)
        self.conv_in = Conv2d(cfg.latent_channels, rev[0], 3, padding=1,
                              dtype=cfg.dtype, param_dtype=cfg.param_dtype)
        self.mid_block = VAEMidBlock(rev[0], cfg)
        self.up_blocks = nn.ModuleList([
            VAEUpBlock(rev[max(i - 1, 0)], ch, i < n - 1, cfg)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1],
                                       eps=1e-6, dtype=cfg.param_dtype)
        # the output conv runs in fp32, like the JAX decoder's
        self.conv_out = Conv2d(rev[-1], cfg.out_channels, 3, padding=1,
                               dtype=torch.float32,
                               param_dtype=cfg.param_dtype)

    def forward(self, z):
        x = self.conv_in(z.to(self.dtype))
        x = self.mid_block(x)
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(gn_silu(self.conv_norm_out, x, self.dtype))


class AutoencoderKL(nn.Module):
    """VAE with deterministic (posterior-mean) encode."""

    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = cfg = config
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.latent_channels,
                                 2 * cfg.latent_channels, 1, dtype=cfg.dtype,
                                 param_dtype=cfg.param_dtype)
        self.post_quant_conv = Conv2d(cfg.latent_channels,
                                      cfg.latent_channels, 1,
                                      dtype=cfg.dtype,
                                      param_dtype=cfg.param_dtype)

    def encode(self, image):
        """image [B,3,H,W] in [-1,1] -> posterior mean [B,4,h,w] fp32."""
        moments = self.quant_conv(self.encoder(image))
        return moments.chunk(2, dim=1)[0].float()

    def decode(self, latents):
        """latents [B,4,h,w] (unscaled) -> image [B,3,H,W] fp32 ~[-1,1]."""
        return self.decoder(self.post_quant_conv(latents)).float()
