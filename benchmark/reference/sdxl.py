"""Plain PyTorch reference of SDXL base 1.0 with the depth ControlNet.

A clean-room implementation, from the published descriptions, of what the
SDXL family adds to the SD-2 reference (`sd.py`, whose resnet, attention,
transformer-block, resampling and CLIP-layer modules it reuses): diffusers' UNet2DConditionModel with a transformer depth per level
(`transformer_layers_per_block`, the mid block taking the last), the
`text_time` added embedding and a ControlNet's residual inputs;
ControlNetModel (the conditioning network on the control image, a copy of
the encoder, the 1x1 convs to the residuals, the conditioning scale); and
transformers' CLIPTextModel / CLIPTextModelWithProjection read as SDXL
reads them (the penultimate hidden states, with no final norm; bigG's
pooled output, the final-norm state at the end token through
`text_projection`). State-dict keys follow the published naming.

Departures, each also made by the program: the end token is found as the
largest id (transformers' rule for these configs, whose eos_token_id is
2); the recorded activations are the outputs of the cross-attention up
blocks, after their upsampler, as for SD-2. Where a graph is recorded, each
resnet and each transformer is recomputed in the backward (activation
checkpointing: the same arithmetic, in the memory of one block), so that
the float32 backward through both nets at 1024x1024 fits on the card. The
benchmark runs it in float32 with TF32 off; no kernel of the program is
imported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from benchmark.reference.sd import (BasicTransformerBlock, CLIPLayer,
                                    Downsample, ResnetBlock, Upsample,
                                    timestep_embedding)


def _block(module, *args):
    """module(*args), recomputed in the backward where a graph is recorded
    (unless the module's `recompute` is False: the FLOP count sets it)."""
    if getattr(module, "recompute", True) and torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(module, *args, use_reentrant=False)
    return module(*args)


# ---------------------------------------------------------------------------
# U-Net and ControlNet
# ---------------------------------------------------------------------------

class DeepTransformer2D(nn.Module):
    """Linear-projection spatial transformer with `depth` blocks."""

    def __init__(self, channels, heads, context_dim, groups, depth):
        super().__init__()
        self.norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, channels // heads,
                                  context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x, context):
        b, c, h, w = x.shape
        hid = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        hid = self.proj_in(hid)
        for block in self.transformer_blocks:
            hid = block(hid, context)
        hid = self.proj_out(hid)
        return hid.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class XLDownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_ch, num_layers, heads,
                 context_dim, add_downsample, groups, depth):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_ch if i == 0 else out_ch, out_ch, temb_ch,
                        groups=groups) for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            DeepTransformer2D(out_ch, heads, context_dim, groups, depth)
            for _ in range(num_layers)]) if heads else None
        self.downsamplers = (nn.ModuleList([Downsample(out_ch)])
                             if add_downsample else None)

    def forward(self, x, temb, context):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = _block(resnet, x, temb)
            if self.attentions is not None:
                x = _block(self.attentions[i], x, context)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class XLUpBlock(nn.Module):
    def __init__(self, prev_ch, skip_chs: Sequence[int], out_ch, temb_ch,
                 heads, context_dim, add_upsample, groups, depth):
        super().__init__()
        chs = [prev_ch] + [out_ch] * (len(skip_chs) - 1)
        self.resnets = nn.ModuleList([
            ResnetBlock(c + s, out_ch, temb_ch, groups=groups)
            for c, s in zip(chs, skip_chs)])
        self.attentions = nn.ModuleList([
            DeepTransformer2D(out_ch, heads, context_dim, groups, depth)
            for _ in skip_chs]) if heads else None
        self.upsamplers = (nn.ModuleList([Upsample(out_ch)])
                           if add_upsample else None)

    def forward(self, x, skips: List[torch.Tensor], temb, context):
        for i, resnet in enumerate(self.resnets):
            x = _block(resnet, torch.cat([x, skips.pop()], dim=1), temb)
            if self.attentions is not None:
                x = _block(self.attentions[i], x, context)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class XLMidBlock(nn.Module):
    def __init__(self, channels, temb_ch, heads, context_dim, groups, depth):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, temb_ch, groups=groups),
            ResnetBlock(channels, channels, temb_ch, groups=groups)])
        self.attentions = nn.ModuleList([
            DeepTransformer2D(channels, heads, context_dim, groups, depth)])

    def forward(self, x, temb, context):
        x = _block(self.resnets[0], x, temb)
        x = _block(self.attentions[0], x, context)
        return _block(self.resnets[1], x, temb)


@dataclass
class XLUNetConfig:
    """The published SDXL base 1.0 unet/config.json widths."""

    sample_size: int = 128
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D")
    layers_per_block: int = 2
    num_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816


class XLEncoder(nn.Module):
    """conv_in, the time and `text_time` embeddings, the down blocks and
    the mid block, with diffusers' names."""

    def _build(self, cfg: XLUNetConfig):
        self.cfg = cfg
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = nn.Linear(ch0, temb_ch)
        self.time_embedding.linear_2 = nn.Linear(temb_ch, temb_ch)
        self.add_embedding = nn.Module()
        self.add_embedding.linear_1 = nn.Linear(
            cfg.projection_class_embeddings_input_dim, temb_ch)
        self.add_embedding.linear_2 = nn.Linear(temb_ch, temb_ch)
        n = len(cfg.block_out_channels)
        down, ch, skip_chs = [], ch0, [ch0]
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            heads = cfg.num_heads[i] if btype.startswith("CrossAttn") else 0
            down.append(XLDownBlock(ch, out_ch, temb_ch,
                                    cfg.layers_per_block, heads,
                                    cfg.cross_attention_dim, i < n - 1, g,
                                    cfg.transformer_layers_per_block[i]))
            skip_chs += [out_ch] * cfg.layers_per_block
            if i < n - 1:
                skip_chs.append(out_ch)
            ch = out_ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = XLMidBlock(ch, temb_ch, cfg.num_heads[-1],
                                    cfg.cross_attention_dim, g,
                                    cfg.transformer_layers_per_block[-1])
        self.skip_chs = skip_chs
        return temb_ch, g

    def embed(self, timesteps, batch, text_embeds, time_ids):
        """The time embedding plus the added embedding of the pooled
        text vector and the six size and crop ids."""
        cfg = self.cfg
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(batch)
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding.linear_2(
            F.silu(self.time_embedding.linear_1(temb)))
        ids = timestep_embedding(time_ids.flatten(),
                                 cfg.addition_time_embed_dim)
        added = torch.cat([text_embeds, ids.reshape(batch, -1)], dim=-1)
        return temb + self.add_embedding.linear_2(
            F.silu(self.add_embedding.linear_1(added)))

    def encode(self, x, temb, context):
        skips = [x]
        for block in self.down_blocks:
            x, s = block(x, temb, context)
            skips += s
        return self.mid_block(x, temb, context), skips


class OracleXLUNet(XLEncoder):
    """diffusers UNet2DConditionModel at SDXL's config: (sample, timesteps,
    context, text_embeds, time_ids, down residuals, mid residual) -> (eps,
    the outputs of the cross-attention up blocks)."""

    def __init__(self, cfg: XLUNetConfig):
        super().__init__()
        temb_ch, g = self._build(cfg)
        n = len(cfg.block_out_channels)
        skip_chs = list(self.skip_chs)
        rev = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.num_heads))
        rev_depth = list(reversed(cfg.transformer_layers_per_block))
        up, prev = [], rev[0]
        for i, btype in enumerate(cfg.up_block_types):
            heads = rev_heads[i] if btype.startswith("CrossAttn") else 0
            block_skips = [skip_chs.pop()
                           for _ in range(cfg.layers_per_block + 1)]
            up.append(XLUpBlock(prev, block_skips, rev[i], temb_ch, heads,
                                cfg.cross_attention_dim, i < n - 1, g,
                                rev_depth[i]))
            prev = rev[i]
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = nn.GroupNorm(g, prev, eps=1e-5)
        self.conv_out = nn.Conv2d(prev, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, text_embeds, time_ids,
                down_residuals: Optional[list] = None, mid_residual=None):
        cfg = self.cfg
        temb = self.embed(timesteps, sample.shape[0], text_embeds, time_ids)
        x, skips = self.encode(self.conv_in(sample), temb, context)
        if down_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_residuals)]
            x = x + mid_residual
        acts = []
        for i, block in enumerate(self.up_blocks):
            k = cfg.layers_per_block + 1
            x = block(x, list(skips[-k:]), temb, context)
            skips = skips[:-k]
            if cfg.up_block_types[i].startswith("CrossAttn"):
                acts.append(x)
        return self.conv_out(F.silu(self.conv_norm_out(x))), acts


class OracleControlNet(XLEncoder):
    """diffusers ControlNetModel: (sample, timesteps, context, control
    image [B, 3, H, W], text_embeds, time_ids) -> (down residuals, mid
    residual), scaled by `scale`."""

    def __init__(self, cfg: XLUNetConfig,
                 embedding: Tuple[int, ...] = (16, 32, 96, 256),
                 scale: float = 1.0):
        super().__init__()
        self._build(cfg)
        self.scale = scale
        emb = nn.Module()
        emb.conv_in = nn.Conv2d(3, embedding[0], 3, padding=1)
        blocks = []
        for a, b in zip(embedding, embedding[1:]):
            blocks += [nn.Conv2d(a, a, 3, padding=1),
                       nn.Conv2d(a, b, 3, padding=1, stride=2)]
        emb.blocks = nn.ModuleList(blocks)
        emb.conv_out = nn.Conv2d(embedding[-1], cfg.block_out_channels[0],
                                 3, padding=1)
        self.controlnet_cond_embedding = emb
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in self.skip_chs])
        mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1)

    def cond_embedding(self, image):
        e = self.controlnet_cond_embedding
        x = F.silu(e.conv_in(image))
        for conv in e.blocks:
            x = F.silu(conv(x))
        return e.conv_out(x)

    def forward(self, sample, timesteps, context, control, text_embeds,
                time_ids):
        temb = self.embed(timesteps, sample.shape[0], text_embeds, time_ids)
        x = self.conv_in(sample) + self.cond_embedding(control)
        x, skips = self.encode(x, temb, context)
        down = [conv(s) * self.scale
                for conv, s in zip(self.controlnet_down_blocks, skips)]
        return down, self.controlnet_mid_block(x) * self.scale


# ---------------------------------------------------------------------------
# Text towers
# ---------------------------------------------------------------------------

@dataclass
class XLCLIPConfig:
    """CLIP ViT-L/14's published text_encoder/config.json; bigG/14's
    (text_encoder_2) sets hidden 1280, intermediate 5120, 20 heads, 32
    layers, gelu and projection_dim 1280."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_heads: int = 12
    num_layers: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: Optional[int] = None


class ActCLIPLayer(CLIPLayer):
    """The SD oracle's CLIP layer with the tower's activation."""

    def __init__(self, cfg: XLCLIPConfig):
        super().__init__(cfg)
        self.act = cfg.hidden_act

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
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h) if self.act == "quick_gelu" \
            else F.gelu(h)
        return x + self.mlp.fc2(h)


class OracleXLTower(nn.Module):
    """ids [B, 77] -> (the penultimate hidden states, no final norm; with
    a projection, the pooled output [B, projection_dim], else None). Keys
    as transformers' (`text_model.` prefix, `text_projection`)."""

    def __init__(self, cfg: XLCLIPConfig):
        super().__init__()
        tm = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg.vocab_size,
                                                     cfg.hidden_size)
        tm.embeddings.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList(
            [ActCLIPLayer(cfg) for _ in range(cfg.num_layers)])
        tm.final_layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.text_model = tm
        self.text_projection = (
            nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
            if cfg.projection_dim else None)

    def forward(self, input_ids):
        tm = self.text_model
        s = input_ids.shape[-1]
        dev = input_ids.device
        x = tm.embeddings.token_embedding(input_ids) \
            + tm.embeddings.position_embedding(torch.arange(s, device=dev))
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                       device=dev))[None, None]
        states = [x]
        for layer in tm.encoder.layers:
            x = layer(x, causal)
            states.append(x)
        if self.text_projection is None:
            return states[-2], None
        last = tm.final_layer_norm(x)
        eos = last[torch.arange(x.shape[0], device=dev),
                   input_ids.argmax(dim=-1)]
        return states[-2], self.text_projection(eos)


def encode_prompt_xl(tower_l: OracleXLTower, tower_g: OracleXLTower,
                     input_ids):
    """SDXL's prompt encoding: the two towers' penultimate states
    concatenated [B, 77, 2048] and bigG's pooled output [B, 1280]."""
    ctx_l, _ = tower_l(input_ids)
    ctx_g, pooled = tower_g(input_ids)
    return torch.cat([ctx_l, ctx_g], dim=-1), pooled
