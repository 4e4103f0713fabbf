"""Swin Transformer backbone, release-convertible.

The counterpart of the JAX package's `models/swin.py`: GroundingDINO's
vision backbone (Swin-T with out_indices (1, 2, 3) in the released
`groundingdino_swint_ogc.pth`). A 4x4 patch embed and LayerNorm, stages of
window attention blocks (a relative-position bias per window; every second
block cyclically shifted, with the shifted-window attention mask), patch
merging between stages, and a LayerNorm per requested output level.

Module names are the release's (under GroundingDINO's `backbone.0.`):
`patch_embed.{proj,norm}`, `layers.i.blocks.j.*`, `layers.i.downsample.*`,
`norm{i}`; `relative_position_index` is a buffer of the release state
dict. Every stage map must hold at least one window (Swin-T, window 7:
an input of 193 pixels or more). fp32, NHWC inside; the modules do not
turn TF32 on.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96                      # Swin-T
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)

    def stage_dim(self, i: int) -> int:
        return self.embed_dim * 2 ** i


def tiny_swin_config(**overrides) -> SwinConfig:
    base = dict(embed_dim=16, depths=(1, 1, 2), num_heads=(2, 2, 2),
                window_size=2, out_indices=(0, 1, 2))
    base.update(overrides)
    return SwinConfig(**base)


def _rel_pos_index(ws: int) -> torch.Tensor:
    """Relative position index inside a ws x ws window (published Swin),
    [N, N] int64, on the default device."""
    c = torch.arange(ws)
    coords = torch.stack(torch.meshgrid(c, c, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + ws - 1
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


@functools.lru_cache(maxsize=32)
def _shift_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Attention mask for shifted windows (published Swin img_mask),
    [nW, N, N] float32 (0 or -100)."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs] = cnt
            cnt += 1
    wins = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    wins = wins.reshape(-1, ws * ws)
    diff = wins[:, :, None] != wins[:, None, :]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             _rel_pos_index(window_size))

    def forward(self, x, attn_mask=None):
        """x [nW, N, C] windows; attn_mask [nW0, N, N] or None (added to
        the logits per shifted-window group)."""
        nw, n, c = x.shape
        nh = self.num_heads
        hd = c // nh
        q, k, v = self.qkv(x).reshape(nw, n, 3, nh, hd).unbind(2)
        logits = torch.einsum("wqhc,wkhc->whqk", q, k) / np.sqrt(hd)
        bias = self.relative_position_bias_table[
            self.relative_position_index]                    # [N, N, H]
        logits = logits + bias.permute(2, 0, 1)[None]
        if attn_mask is not None:
            g = attn_mask.shape[0]
            logits = (logits.view(nw // g, g, nh, n, n)
                      + attn_mask[None, :, None]).view(nw, nh, n, n)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("whqk,wkhc->wqhc", attn, v).reshape(nw, n, c)
        return self.proj(out)


def _window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws * ws, c)


def _window_reverse(wins, ws: int, b: int, h: int, w: int):
    x = wins.view(b, h // ws, w // ws, ws, ws, -1).transpose(2, 3)
    return x.reshape(b, h, w, -1)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift: int, mlp_ratio: float):
        super().__init__()
        self.window_size = window_size
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        b, h, w, c = x.shape
        ws = self.window_size
        if min(h, w) < ws:
            # the JAX package shrinks the window to the map here, with a
            # relative-position table of the shrunk size, which no release
            # file holds
            raise ValueError(f"a {h}x{w} stage map is smaller than the "
                             f"{ws}x{ws} window; use a larger input")
        shift = self.shift if ws < min(h, w) else 0
        ph, pw = (-h) % ws, (-w) % ws  # bottom/right (published)
        hx = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        mask = None
        if shift:
            hx = torch.roll(hx, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(_shift_mask(hp, wp, ws, shift)).to(
                x.device)
        wins = self.attn(_window_partition(hx, ws), mask)
        hx = _window_reverse(wins, ws, b, hp, wp)
        if shift:
            hx = torch.roll(hx, (shift, shift), dims=(1, 2))
        x = x + hx[:, :h, :w]
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        # published concat order: (0::2, 0::2), (1::2, 0::2), (0::2, 1::2),
        # (1::2, 1::2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformer(nn.Module):
    """[B, 3, H, W] -> {level index: [B, C_i, H / s_i, W / s_i]} for
    out_indices (strides 4 * 2^i); the JAX backbone gives the same maps
    channels-last."""

    def __init__(self, config: SwinConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        p = cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.embed_dim, p, p)
        self.patch_embed.norm = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.layers = nn.ModuleList()
        for i, depth in enumerate(cfg.depths):
            dim = cfg.stage_dim(i)
            stage = nn.Module()
            stage.blocks = nn.ModuleList([
                SwinBlock(dim, cfg.num_heads[i], cfg.window_size,
                          0 if j % 2 == 0 else cfg.window_size // 2,
                          cfg.mlp_ratio) for j in range(depth)])
            if i < len(cfg.depths) - 1:
                stage.downsample = PatchMerging(dim)
            self.layers.append(stage)
            if i in cfg.out_indices:
                self.add_module(f"norm{i}", nn.LayerNorm(dim, eps=LN_EPS))

    def forward(self, x) -> Dict[int, torch.Tensor]:
        cfg = self.config
        p = cfg.patch_size
        h, w = x.shape[-2:]
        x = F.pad(x, (0, (-w) % p, 0, (-h) % p))
        x = self.patch_embed.norm(
            self.patch_embed.proj(x).permute(0, 2, 3, 1))
        outs = {}
        for i, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            if i in cfg.out_indices:
                outs[i] = getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2)
            if i < len(self.layers) - 1:
                x = stage.downsample(x)
        return outs
