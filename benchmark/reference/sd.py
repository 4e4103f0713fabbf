"""Plain PyTorch reference of the SD-2-depth model stack.

A clean-room implementation of the diffusers UNet2DConditionModel,
AutoencoderKL and transformers CLIPTextModel semantics, with the published
state-dict names, so that the weights the benchmark makes load into it and
into the measured program alike. Attention is written out (fp32 logits and
softmax), convolutions and norms are the stock torch modules: no kernel of
the program is imported. The benchmark runs it in float32 with TF32 off.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------

def timestep_embedding(timesteps, dim, flip_sin_to_cos=True, freq_shift=0.0,
                       max_period=10000):
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / (
            half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, groups=32, eps=1e-5,
                 with_temb=True):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if with_temb:
            self.time_emb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)
        else:
            self.conv_shortcut = None
        self.with_temb = with_temb

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.with_temb:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        res = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + res


class Attention(nn.Module):
    """diffusers Attention: to_q/k/v (no bias), to_out.0 Linear (bias)."""

    def __init__(self, query_dim, context_dim, heads, head_dim):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, x, context=None):
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(context).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).view(b, sk, self.heads, self.head_dim)
        scale = self.head_dim ** -0.5
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        probs = logits.softmax(dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, sq, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, heads, head_dim, context_dim):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads, head_dim)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = nn.Module()
        self.ff.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Dropout(0.0),
                                     nn.Linear(dim * 4, dim)])

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        h = self.ff.net[0](self.norm3(x))
        h = self.ff.net[2](self.ff.net[1](h))
        return x + h


class Transformer2D(nn.Module):
    """use_linear_projection=True variant (SD2)."""

    def __init__(self, channels, heads, context_dim, groups=32):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads,
                                  context_dim)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        hid = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hid = self.proj_in(hid)
        hid = self.transformer_blocks[0](hid, context)
        hid = self.proj_out(hid)
        return hid.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class Downsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, num_layers, heads,
                 context_dim, add_downsample, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, temb_ch,
                        groups=groups) for i in range(num_layers)])
        if heads:
            self.attentions = nn.ModuleList([
                Transformer2D(out_ch, heads, context_dim, groups=groups)
                for _ in range(num_layers)])
        else:
            self.attentions = None
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample(out_ch)])
        else:
            self.downsamplers = None

    def forward(self, x, temb, context):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UpBlock(nn.Module):
    def __init__(self, prev_ch, skip_chs: Sequence[int], out_ch, temb_ch,
                 heads, context_dim, add_upsample, groups=32):
        super().__init__()
        resnets = []
        ch = prev_ch
        for skip_ch in skip_chs:
            resnets.append(ResnetBlock(ch + skip_ch, out_ch, temb_ch,
                                       groups=groups))
            ch = out_ch
        self.resnets = nn.ModuleList(resnets)
        if heads:
            self.attentions = nn.ModuleList([
                Transformer2D(out_ch, heads, context_dim, groups=groups)
                for _ in range(len(skip_chs))])
        else:
            self.attentions = None
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample(out_ch)])
        else:
            self.upsamplers = None

    def forward(self, x, skips: List[torch.Tensor], temb, context):
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=1)
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, temb_ch, heads, context_dim, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, temb_ch, groups=groups),
            ResnetBlock(channels, channels, temb_ch, groups=groups)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, heads, context_dim, groups=groups)])

    def forward(self, x, temb, context):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context)
        x = self.resnets[1](x, temb)
        return x


@dataclass
class RefUNetConfig:
    sample_size: int = 64
    in_channels: int = 5
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D")
    layers_per_block: int = 1
    num_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32



class RefUNet(nn.Module):
    """diffusers UNet2DConditionModel semantics, exact state-dict names.

    Also returns the three decoder activations the pipeline records
    (after each cross-attn up block, reference unet_2d_condition.py:1146-1161).
    """

    def __init__(self, cfg: RefUNetConfig):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch0, temb_ch)
        self.time_embedding.linear_2 = nn.Linear(temb_ch, temb_ch)

        n = len(cfg.block_out_channels)
        down = []
        ch = ch0
        skip_chs = [ch0]
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            heads = cfg.num_heads[i] if btype == "CrossAttnDownBlock2D" else 0
            add_down = i < n - 1
            down.append(DownBlock(ch, out_ch, temb_ch, cfg.layers_per_block,
                                  heads, cfg.cross_attention_dim, add_down,
                                  groups=g))
            skip_chs.extend([out_ch] * cfg.layers_per_block)
            if add_down:
                skip_chs.append(out_ch)
            ch = out_ch
        self.down_blocks = nn.ModuleList(down)

        self.mid_block = MidBlock(ch, temb_ch, cfg.num_heads[-1],
                                  cfg.cross_attention_dim, groups=g)

        up = []
        rev_channels = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.num_heads))
        prev = ch
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = rev_channels[i]
            heads = rev_heads[i] if btype == "CrossAttnUpBlock2D" else 0
            num_layers = cfg.layers_per_block + 1
            block_skips = [skip_chs.pop() for _ in range(num_layers)]
            up.append(UpBlock(prev, block_skips, out_ch, temb_ch, heads,
                              cfg.cross_attention_dim, i < n - 1, groups=g))
            prev = out_ch
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = nn.GroupNorm(g, prev, eps=1e-5)
        self.conv_out = nn.Conv2d(prev, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context):
        cfg = self.cfg
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding.linear_2(
            F.silu(self.time_embedding.linear_1(temb)))

        x = self.conv_in(sample)
        skips = [x]
        for block in self.down_blocks:
            x, block_skips = block(x, temb, context)
            skips.extend(block_skips)
        x = self.mid_block(x, temb, context)
        activations = []
        for i, block in enumerate(self.up_blocks):
            num_layers = cfg.layers_per_block + 1
            block_skips = skips[-num_layers:]
            skips = skips[:-num_layers]
            x = block(x, list(block_skips), temb, context)
            if cfg.up_block_types[i] == "CrossAttnUpBlock2D":
                activations.append(x)
        eps = self.conv_out(F.silu(self.conv_norm_out(x)))
        return eps, activations


# ---------------------------------------------------------------------------
# VAE (AutoencoderKL)
# ---------------------------------------------------------------------------

class VAEAttention(nn.Module):
    """diffusers VAE mid attention: heads=1, dim_head=channels."""

    def __init__(self, channels, groups=32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])
        self.channels = channels

    def forward(self, x):
        b, c, h, w = x.shape
        residual = x
        hid = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(hid), self.to_k(hid), self.to_v(hid)
        logits = torch.einsum("bqd,bkd->bqk", q, k) * (c ** -0.5)
        out = torch.einsum("bqk,bkd->bqd", logits.softmax(-1), v)
        out = self.to_out[0](out)
        return out.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual


class VAEDownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, num_layers, add_down, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, 0,
                        groups=groups, eps=1e-6, with_temb=False)
            for i in range(num_layers)])
        if add_down:
            self.downsamplers = nn.ModuleList([Downsample(out_ch)])
            # diffusers VAE downsampler pads (0,1,0,1) with a pad=0 conv
            self.downsamplers[0].conv = nn.Conv2d(out_ch, out_ch, 3,
                                                  stride=2, padding=0)
        else:
            self.downsamplers = None

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            x = F.pad(x, (0, 1, 0, 1))
            x = self.downsamplers[0].conv(x)
        return x


class VAEUpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, num_layers, add_up, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, 0,
                        groups=groups, eps=1e-6, with_temb=False)
            for i in range(num_layers)])
        self.upsamplers = (nn.ModuleList([Upsample(out_ch)]) if add_up
                           else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class VAEMidBlock(nn.Module):
    def __init__(self, channels, groups=32):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, 0, groups=groups, eps=1e-6,
                        with_temb=False),
            ResnetBlock(channels, channels, 0, groups=groups, eps=1e-6,
                        with_temb=False)])
        self.attentions = nn.ModuleList([VAEAttention(channels,
                                                      groups=groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


@dataclass
class RefVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32



class RefVAE(nn.Module):
    def __init__(self, cfg: RefVAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        n = len(cfg.block_out_channels)

        enc = nn.Module()
        enc.conv_in = nn.Conv2d(cfg.in_channels, cfg.block_out_channels[0],
                                3, padding=1)
        blocks = []
        ch = cfg.block_out_channels[0]
        for i, out_ch in enumerate(cfg.block_out_channels):
            blocks.append(VAEDownBlock(ch, out_ch, cfg.layers_per_block,
                                       add_down=i < n - 1, groups=g))
            ch = out_ch
        enc.down_blocks = nn.ModuleList(blocks)
        enc.mid_block = VAEMidBlock(ch, groups=g)
        enc.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        enc.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)
        self.encoder = enc

        dec = nn.Module()
        dec.conv_in = nn.Conv2d(cfg.latent_channels,
                                cfg.block_out_channels[-1], 3, padding=1)
        dec.mid_block = VAEMidBlock(cfg.block_out_channels[-1], groups=g)
        blocks = []
        rev = list(reversed(cfg.block_out_channels))
        ch = rev[0]
        for i, out_ch in enumerate(rev):
            blocks.append(VAEUpBlock(ch, out_ch, cfg.layers_per_block + 1,
                                     add_up=i < n - 1, groups=g))
            ch = out_ch
        dec.up_blocks = nn.ModuleList(blocks)
        dec.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        dec.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)
        self.decoder = dec

        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode_mean(self, image):
        x = self.encoder.conv_in(image)
        for b in self.encoder.down_blocks:
            x = b(x)
        x = self.encoder.mid_block(x)
        x = self.encoder.conv_out(F.silu(self.encoder.conv_norm_out(x)))
        moments = self.quant_conv(x)
        mean, _ = moments.chunk(2, dim=1)
        return mean

    def decode(self, z):
        x = self.decoder.conv_in(self.post_quant_conv(z))
        x = self.decoder.mid_block(x)
        for b in self.decoder.up_blocks:
            x = b(x)
        return self.decoder.conv_out(F.silu(self.decoder.conv_norm_out(x)))


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------

@dataclass
class RefCLIPConfig:
    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 23
    max_position_embeddings: int = 77



class CLIPLayer(nn.Module):
    def __init__(self, cfg: RefCLIPConfig):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = nn.Module()
        self.self_attn.q_proj = nn.Linear(d, d)
        self.self_attn.k_proj = nn.Linear(d, d)
        self.self_attn.v_proj = nn.Linear(d, d)
        self.self_attn.out_proj = nn.Linear(d, d)
        self.layer_norm1 = nn.LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = nn.Linear(cfg.intermediate_size, d)
        self.layer_norm2 = nn.LayerNorm(d)
        self.heads = cfg.num_heads
        self.head_dim = d // cfg.num_heads

    def forward(self, x, causal_mask):
        h = self.layer_norm1(x)
        b, s, d = h.shape
        q = self.self_attn.q_proj(h).view(b, s, self.heads, self.head_dim)
        k = self.self_attn.k_proj(h).view(b, s, self.heads, self.head_dim)
        v = self.self_attn.v_proj(h).view(b, s, self.heads, self.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) \
            * (self.head_dim ** -0.5)
        logits = logits.masked_fill(~causal_mask, float("-inf"))
        out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)
        x = x + self.self_attn.out_proj(out.reshape(b, s, d))
        h = self.layer_norm2(x)
        h = self.mlp.fc2(F.gelu(self.mlp.fc1(h)))
        return x + h


class RefCLIPText(nn.Module):
    """transformers CLIPTextModel semantics: state dict keys are prefixed
    `text_model.` (handled by the wrapper in state_dict_with_prefix)."""

    def __init__(self, cfg: RefCLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size,
                                                       cfg.hidden_size)
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [CLIPLayer(cfg) for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)

    def forward(self, input_ids):
        s = input_ids.shape[-1]
        pos_ids = torch.arange(s, device=input_ids.device)
        x = self.embeddings.token_embedding(input_ids) \
            + self.embeddings.position_embedding(pos_ids)[None]
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                       device=input_ids.device))[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)
