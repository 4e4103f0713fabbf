"""Plain float32 reference of the toy_side family (archs/toy_side.py),
independent of the program: the reference U-Net (benchmark/reference/sd.py)
with a side network's residual, made from the depth map, added to its
input features and a projected pooled text vector added to its time
embedding; and the text tower. State-dict names are the program's."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.sd import RefUNet, RefUNetConfig, timestep_embedding


class RefSideDenoiser(nn.Module):
    """(sample [B,4,h,w], timesteps, context [B,77,D], depth [B,1,H,W],
    pooled [B,D]) -> (eps, the three decoder activations)."""

    def __init__(self, unet: RefUNetConfig, side: Sequence[int],
                 pooled_dim: int):
        super().__init__()
        self.unet = RefUNet(unet)
        ch0 = unet.block_out_channels[0]
        widths = [1] + list(side) + [ch0]
        layers = []
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            if i:
                layers.append(nn.SiLU())
            layers.append(nn.Conv2d(a, b, 3, stride=2, padding=1))
        self.side = nn.Sequential(*layers)
        self.pooled_proj = nn.Linear(pooled_dim, 4 * ch0)

    def forward(self, sample, timesteps, context, depth, pooled):
        u = self.unet
        cfg = u.cfg
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = u.time_embedding.linear_2(
            F.silu(u.time_embedding.linear_1(temb)))
        temb = temb + self.pooled_proj(pooled)

        x = u.conv_in(sample) + self.side(depth)
        skips = [x]
        for block in u.down_blocks:
            x, block_skips = block(x, temb, context)
            skips.extend(block_skips)
        x = u.mid_block(x, temb, context)
        activations = []
        for i, block in enumerate(u.up_blocks):
            num_layers = cfg.layers_per_block + 1
            block_skips = skips[-num_layers:]
            skips = skips[:-num_layers]
            x = block(x, list(block_skips), temb, context)
            if cfg.up_block_types[i] == "CrossAttnUpBlock2D":
                activations.append(x)
        eps = u.conv_out(F.silu(u.conv_norm_out(x)))
        return eps, activations


class RefTextTower(nn.Module):
    """Token ids [B,77] -> (the context [B,77,D] after a LayerNorm, its
    mean over the tokens [B,D])."""

    def __init__(self, vocab_size: int, width: int):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.final_layer_norm = nn.LayerNorm(width)

    def forward(self, ids: torch.Tensor):
        x = self.final_layer_norm(self.token_embedding(ids))
        return x, x.mean(1)
