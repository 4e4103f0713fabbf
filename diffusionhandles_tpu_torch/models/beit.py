"""BEiT-L-384 backbone and the MiDaS DPT neck (ZoeDepth-NK's feature core).

The counterpart of the JAX package's `models/beit.py` (reference:
test/estimate_depth.py:18-30 builds `zoedepth_nk`, whose MiDaS core is
DPT-BEiT-L-384): a BEiT-Large backbone (per-block relative-position
attention bias over the patch grid + cls window, q/v-only qkv biases,
gamma_1/gamma_2 layer scale) hooked at four depths, MiDaS's project-readout
reassembly and RefineNet-style fusion, giving the relative depth and the
multi-scale features ZoeDepth's metric-bins head reads.

Module names are the release's (timm `beit_large_patch16_384` under
`pretrained.model`, MiDaS `DPTDepthModel`'s `pretrained.act_postprocess*`
and `scratch.*`), so a released state dict loads strictly. Layout NCHW /
[B, tokens, D]; attention is dense (fp32 logits plus the gathered bias,
then softmax), as in the JAX package, and fp32 throughout, as its
BEiTConfig.dtype. The x2 fusion upsamples are
`bilinear_ac` (align_corners=True) through ops/resize.resize_nchw.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.ops.resize import resize_nchw


@dataclasses.dataclass(frozen=True)
class BEiTConfig:
    """Defaults = beit_large_patch16_384 (as used by DPT-BEiT-L-384)."""

    image_size: int = 384
    patch_size: int = 16
    embed_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    # MiDaS hooks for beit_l_384
    hooks: Tuple[int, ...] = (5, 11, 17, 23)
    # DPT reassemble output channels per hook
    reassemble_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    fusion_channels: int = 256
    midas_out_channels: int = 32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


def relative_position_index(grid: int) -> np.ndarray:
    """BEiT relative-position index over (cls + grid*grid) tokens: pairwise
    token offsets map into a (2g-1)^2 table, with 3 extra entries for
    cls->token, token->cls and cls->cls."""
    g = grid
    num_rel = (2 * g - 1) * (2 * g - 1)
    coords = np.stack(np.meshgrid(np.arange(g), np.arange(g),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += g - 1
    rel[..., 1] += g - 1
    rel[..., 0] *= 2 * g - 1
    idx = np.zeros((g * g + 1, g * g + 1), np.int64)
    idx[1:, 1:] = rel.sum(-1)
    idx[0, 0:] = num_rel + 1   # cls -> token
    idx[0:, 0] = num_rel + 2   # token -> cls
    idx[0, 0] = num_rel        # cls -> cls
    return idx


def resize2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear, align_corners=True (the MiDaS Interpolate)."""
    return resize_nchw(x, (x.shape[2] * 2, x.shape[3] * 2), "bilinear_ac")


class BEiTAttention(nn.Module):
    def __init__(self, dim: int, heads: int, grid: int):
        super().__init__()
        # timm BEiT: qkv has no bias; q and v have their own (k's is 0)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        num_rel = (2 * grid - 1) * (2 * grid - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(num_rel, heads))
        # recomputed, so not state (a release file's copy is skipped)
        self.register_buffer("relative_position_index", torch.tensor(
            relative_position_index(grid)), persistent=False)
        self.proj = nn.Linear(dim, dim)
        self.heads, self.head_dim = heads, dim // heads

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = (q + self.q_bias).view(b, s, self.heads, self.head_dim)
        k = k.view(b, s, self.heads, self.head_dim)
        v = (v + self.v_bias).view(b, s, self.heads, self.head_dim)
        bias = self.relative_position_bias_table[
            self.relative_position_index].permute(2, 0, 1)[None]
        logits = torch.einsum("bqhd,bkhd->bhqk", q * self.head_dim ** -0.5,
                              k).float() + bias.float()
        probs = logits.softmax(-1).to(x.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
        return self.proj(out)


class BEiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, grid: int, mlp_ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = BEiTAttention(dim, heads, grid)
        self.gamma_1 = nn.Parameter(torch.ones(dim))
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp.fc2 = nn.Linear(dim * mlp_ratio, dim)
        self.gamma_2 = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x = x + self.gamma_1 * self.attn(self.norm1(x))
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))
        return x + self.gamma_2 * h


class ResidualConvUnit(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """MiDaS FeatureFusionBlock_custom (bn=False, relu, expand=False). The
    top block is built with resConfUnit1 as the release has it, and does
    not use it."""

    def __init__(self, ch: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(ch)
        self.resConfUnit2 = ResidualConvUnit(ch)
        self.out_conv = nn.Conv2d(ch, ch, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(resize2x(self.resConfUnit2(x)))


class ProjectReadout(nn.Module):
    """MiDaS 'project' readout: the cls token fused into every patch token
    (concat, Linear, GELU); `project` is the release's Sequential."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        patches = tokens[:, 1:]
        readout = tokens[:, :1].expand_as(patches)
        return self.project(torch.cat([patches, readout], dim=-1))


class MidasDPT(nn.Module):
    """DPT-BEiT depth model: [B, 3, S, S] (ImageNet-normalized) ->
    (relative depth [B, S, S], features), the features being
    [out_conv (midas_out_channels @ S), l4_rn (1/32), path4 (1/16),
    path3 (1/8), path2 (1/4), path1 (1/2)], the list ZoeDepth's head
    reads from MidasCore."""

    def __init__(self, cfg: BEiTConfig):
        super().__init__()
        self.cfg = cfg
        d, g = cfg.embed_dim, cfg.grid
        pre = nn.Module()
        pre.model = nn.Module()
        pre.model.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        pre.model.patch_embed = nn.Module()
        pre.model.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size,
                                               stride=cfg.patch_size)
        pre.model.blocks = nn.ModuleList(
            [BEiTBlock(d, cfg.num_heads, g, cfg.mlp_ratio)
             for _ in range(cfg.num_layers)])
        for level, ch in enumerate(cfg.reassemble_channels):
            post = nn.Sequential()
            post.add_module("0", ProjectReadout(d))
            post.add_module("1", nn.Identity())  # the release's Transpose
            post.add_module("2", nn.Identity())  # and Unflatten
            post.add_module("3", nn.Conv2d(d, ch, 1))
            if level == 0:
                post.add_module("4", nn.ConvTranspose2d(ch, ch, 4, stride=4))
            elif level == 1:
                post.add_module("4", nn.ConvTranspose2d(ch, ch, 2, stride=2))
            elif level == 3:
                post.add_module("4", nn.Conv2d(ch, ch, 3, stride=2,
                                               padding=1))
            setattr(pre, f"act_postprocess{level + 1}", post)
        self.pretrained = pre

        fc = cfg.fusion_channels
        scratch = nn.Module()
        for i, ch in enumerate(cfg.reassemble_channels):
            setattr(scratch, f"layer{i + 1}_rn",
                    nn.Conv2d(ch, fc, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(scratch, f"refinenet{i}", FeatureFusionBlock(fc))
        scratch.output_conv = nn.Sequential(
            nn.Conv2d(fc, fc // 2, 3, padding=1),
            nn.Identity(),  # the release's Interpolate (x2)
            nn.Conv2d(fc // 2, cfg.midas_out_channels, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(cfg.midas_out_channels, 1, 1),
            nn.ReLU())
        self.scratch = scratch

    def backbone(self, x) -> List[torch.Tensor]:
        """[B, 3, S, S] -> the hooked token maps [B, 1 + g*g, D]."""
        m = self.pretrained.model
        b = x.shape[0]
        tokens = m.patch_embed.proj(x).flatten(2).transpose(1, 2)
        tokens = torch.cat([m.cls_token.expand(b, -1, -1), tokens], dim=1)
        hooks = []
        for i, blk in enumerate(m.blocks):
            tokens = blk(tokens)
            if i in self.cfg.hooks:
                hooks.append(tokens)
        return hooks

    def forward(self, x):
        cfg = self.cfg
        g, b = cfg.grid, x.shape[0]
        feats = []
        for level, tokens in enumerate(self.backbone(x)):
            post = getattr(self.pretrained, f"act_postprocess{level + 1}")
            h = post[0](tokens).transpose(1, 2).reshape(b, cfg.embed_dim, g,
                                                        g)
            h = post[3](h)
            if level != 2:
                h = post[4](h)
            feats.append(h)
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(feats[i]) for i in range(4)]
        path4 = s.refinenet4(rn[3])
        path3 = s.refinenet3(path4, rn[2])
        path2 = s.refinenet2(path3, rn[1])
        path1 = s.refinenet1(path2, rn[0])
        oc = s.output_conv
        out_feat = F.relu(oc[2](resize2x(oc[0](path1))))
        rel_depth = F.relu(oc[4](out_feat))[:, 0]
        return rel_depth, [out_feat, rn[3], path4, path3, path2, path1]


def tiny_beit_config(**overrides) -> BEiTConfig:
    base = dict(image_size=64, patch_size=16, embed_dim=32, num_layers=4,
                num_heads=2, hooks=(0, 1, 2, 3),
                reassemble_channels=(8, 16, 32, 32), fusion_channels=16,
                midas_out_channels=8)
    base.update(overrides)
    return BEiTConfig(**base)
