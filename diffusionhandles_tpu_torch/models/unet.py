"""The Stable Diffusion U-Net (diffusers UNet2DConditionModel semantics),
NCHW: SD-2-depth's by default, SDXL's with its fields set.

The counterpart of the JAX package's `models/unet.py`. Modules carry the
diffusers names, so the state dict has a real checkpoint's keys
(`down_blocks.0.attentions.1.transformer_blocks.0.attn2.to_k.weight`). The
forward returns what the JAX U-Net returns: `(eps, activations, attn)`, with
`activations` the hidden states after each cross-attention up block (the
guidance capture points, reference unet_2d_condition.py:1146-1161) and
`attn` the optional cross-attention probabilities.

Numerics follow the JAX module: parameters are stored in `param_dtype`,
matmuls and convs run in the compute `dtype`, GroupNorm and LayerNorm run in
fp32 (then SiLU, then a cast), attention logits and softmax in fp32, and
eps and the activations come out fp32. Long self-attentions take the flash
kernels where the JAX package's gate sends them (`ops/attention.py`). With
the fused GroupNorm switches on (`UNetConfig.fused_gn_conv`, `fused_gn`),
the resnet halves and the GroupNorm sites take the kernels of
`ops/gn_conv.py` and `ops/groupnorm.py` where the JAX package's gates send
them; with `UNetConfig.conv3x3_kernel`, the resnet and upsampler 3x3 convs
take the conv kernel of `ops/conv.py` where its gate passes ('hybrid': its
dx kernel under the library forward; 'mixed': its forward kernel over a
plain backward). The parameters are the same either way.

SDXL's U-Net sets `transformer_layers_per_block` (transformer blocks per
level, the mid block taking the last level's), `addition_embed_type
="text_time"` (the pooled text vector and six size and crop ids, each as
sinusoids, projected into the time embedding) and takes a ControlNet's
residuals, added to the skip connections and to the mid block's output
(`models/controlnet.py`). `UNetEncoder` is the part the two nets share.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from diffusionhandles_tpu_torch.models import unet_graphs
from diffusionhandles_tpu_torch.ops import groupnorm
from diffusionhandles_tpu_torch.ops.attention import dot_product_attention
from diffusionhandles_tpu_torch.ops.conv import (conv3x3, conv3x3_hybrid,
                                                 conv3x3_mixed, conv3x3_ok,
                                                 in_kernel_layout,
                                                 to_kernel_layout)
from diffusionhandles_tpu_torch.ops.gn_conv import (gn_silu_conv3x3,
                                                    gn_silu_conv3x3_ok,
                                                    gn_silu_conv3x3_ref)
from diffusionhandles_tpu_torch.utils.profiling import span

# U-Net calls by path, "eager", "capture" and "replay" (unet_graphs.py),
# beside the kernels' LAUNCHES
GRAPH_CALLS = unet_graphs.GRAPH_CALLS


# UNetConfig.conv3x3_kernel -> the conv op of ops/conv.py it selects
CONV3X3_MODES = {False: None, True: conv3x3, "hybrid": conv3x3_hybrid,
                 "mixed": conv3x3_mixed}


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """SD-2-depth defaults (stabilityai/stable-diffusion-2-depth unet);
    in_channels = 4 latent channels + 1 depth channel.

    fused_gn_conv mirrors the JAX UNetConfig's pallas_conv='fused': each
    resnet half GroupNorm -> SiLU -> conv3x3 is one op (ops/gn_conv.py).
    fused_gn mirrors its pallas_gn=True: the transformer norms,
    conv_norm_out and, without fused_gn_conv, the resnet norms take the
    GroupNorm op (ops/groupnorm.py). conv3x3_kernel mirrors its
    pallas_conv=True, 'hybrid' and 'mixed': the resnet and upsampler 3x3
    convs take the conv op (ops/conv.py: conv3x3, conv3x3_hybrid,
    conv3x3_mixed) where its gate passes; conv_in, conv_out and the
    downsamplers stay F.conv2d, as they stay XLA convs there. fused_gn_conv
    and conv3x3_kernel are values of that one JAX field, so they exclude
    each other.

    conv_per_image runs every Conv2d of a batch image by image, so that an
    image's output does not depend on its position in the batch: at batch
    > 1 cuDNN may pick an algorithm that sums two equal images' outputs in
    different orders (parallel/batch.py needs equal transforms to give
    equal bits)."""

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
    layers_per_block: int = 2
    # heads per block (head dim = channels // heads = 64 at SD-2's widths)
    num_heads: Tuple[int, ...] = (5, 10, 20, 20)
    cross_attention_dim: int = 1024
    norm_num_groups: int = 32
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    flash_attention: bool = False
    fused_gn_conv: bool = False
    fused_gn: bool = False
    # False | True | 'hybrid' | 'mixed' (the JAX UNetConfig.pallas_conv
    # values that select conv3x3, conv3x3_hybrid and conv3x3_mixed)
    conv3x3_kernel: Union[bool, str] = False
    conv_per_image: bool = False
    # False | True (each down and up block recomputed in the backward) |
    # 'dots' (the matmul and convolution outputs saved, the rest
    # recomputed), as the JAX UNetConfig.remat
    remat: Union[bool, str] = False
    # transformer blocks per level (SDXL: (1, 2, 10)); empty: one at every
    # level. The mid block takes the last level's, as diffusers'
    transformer_layers_per_block: Tuple[int, ...] = ()
    # "text_time" (SDXL): the pooled text vector and the size and crop ids,
    # each id as sinusoids of width addition_time_embed_dim, concatenated
    # to projection_class_embeddings_input_dim and added to the time
    # embedding; None: no added embedding (SD-2)
    addition_embed_type: Optional[str] = None
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 0

    def depth(self, level: int) -> int:
        """Transformer blocks per attention at down level `level` (-1:
        the mid block)."""
        layers = self.transformer_layers_per_block
        return layers[level] if layers else 1

    def __post_init__(self):
        if self.fused_gn_conv and self.conv3x3_kernel:
            raise ValueError("fused_gn_conv and conv3x3_kernel are two "
                             "values of the JAX package's pallas_conv; "
                             "set at most one")
        if self.conv3x3_kernel not in CONV3X3_MODES:
            raise ValueError(f"conv3x3_kernel={self.conv3x3_kernel!r}: "
                             "False, True, 'hybrid' or 'mixed'")
        if self.remat not in (False, True, "dots"):
            raise ValueError(f"remat={self.remat!r}: False, True or 'dots'")
        if self.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"addition_embed_type="
                             f"{self.addition_embed_type!r}: None or "
                             "'text_time'")


def tiny_unet_config(**overrides) -> UNetConfig:
    """The JAX package's tiny_unet_config (same topology, tiny widths)."""
    base = dict(sample_size=8, in_channels=5, out_channels=4,
                block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                num_heads=(2, 2, 2, 2), cross_attention_dim=32,
                dtype=torch.float32)
    base.update(overrides)
    return UNetConfig(**base)


# ---------------------------------------------------------------------------
# Layers with separate parameter and compute dtypes (flax's dtype /
# param_dtype split): weights are cast to the compute dtype at use.
# ---------------------------------------------------------------------------

class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    """With `per_image` (UNetConfig.conv_per_image), a batch is convolved
    one image at a time."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, dtype=param_dtype)
        self.compute_dtype = dtype
        self.per_image = False

    def forward(self, x):
        if self.per_image and x.shape[0] > 1:
            return torch.cat([self._forward_one(xi) for xi in x.split(1)])
        return self._forward_one(x)

    def _forward_one(self, x):
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class Conv3x3(Conv2d):
    """A 3x3 SAME Conv2d (same parameters) that, with `kernel` (a value of
    UNetConfig.conv3x3_kernel), runs that conv op of ops/conv.py where its
    gate passes (the JAX package's Conv3x3 with impl 'pallas', 'hybrid' or
    'mixed'), else F.conv2d. With any `kernel` the weight is held in the
    kernel's layout (channels-last; the hybrid dx kernel reads it too),
    set at construction and again after every state-dict load:
    `load_state_dict(assign=True)` replaces the parameter with the source
    tensor."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype = torch.float32,
                 kernel: Union[bool, str] = False):
        super().__init__(in_channels, out_channels, 3, padding=1,
                         dtype=dtype, param_dtype=param_dtype)
        self.kernel = kernel
        self._hold_kernel_layout()

    def _hold_kernel_layout(self):
        if self.kernel and not in_kernel_layout(self.weight):
            self.weight.data = to_kernel_layout(self.weight.data)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._hold_kernel_layout()

    def _forward_one(self, x):
        dt = self.compute_dtype
        b, ci, h, w = x.shape
        if self.kernel and conv3x3_ok(
                (b, h, w, ci), (3, 3, ci, self.out_channels),
                dtype_bytes=torch.finfo(dt).bits // 8):
            return (CONV3X3_MODES[self.kernel](x.to(dt), self.weight)
                    + self.bias.to(dt)[:, None, None])
        return super()._forward_one(x)


class GroupNorm(nn.GroupNorm):
    """GroupNorm computed in fp32 (output fp32; callers cast)."""

    def forward(self, x):
        x = x.float()
        if x.device.type == "cpu":
            # ATen's CPU kernel splits a channels-last input's sums across
            # threads by batch position, so two equal images in one batch
            # could normalize to different bits; NCHW keeps them equal
            x = x.contiguous()
        return F.group_norm(x, self.num_groups, self.weight.float(),
                            self.bias.float(), self.eps)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32 (output fp32; callers cast)."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


def timestep_embedding(timesteps, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0, max_period: int = 10000):
    """Sinusoidal timestep embedding (diffusers get_timestep_embedding)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / (
            half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


def gn_silu(norm: GroupNorm, x, dtype, act: bool = True,
            fused: bool = False):
    """GroupNorm in fp32, SiLU (with `act`), then a cast to the compute
    dtype (the JAX package's GNSiLU). With `fused`, shapes that pass the
    JAX package's gate take the GroupNorm op (ops/groupnorm.py)."""
    jax_shape = (x.shape[0], *x.shape[2:], x.shape[1])
    if fused and groupnorm.gn_ok(jax_shape, norm.num_groups):
        return groupnorm.gn_silu(x, norm.weight, norm.bias, norm.num_groups,
                                 norm.eps, act, dtype)
    y = norm(x)
    return (F.silu(y) if act else y).to(dtype)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int],
                 groups: int, eps: float, dtype, param_dtype,
                 fused_gn_conv: bool = False, fused_gn: bool = False,
                 conv3x3_kernel: Union[bool, str] = False):
        super().__init__()
        self.dtype = dtype
        self.fused_gn_conv, self.fused_gn = fused_gn_conv, fused_gn
        self.norm1 = GroupNorm(groups, in_ch, eps=eps, dtype=param_dtype)
        # the fused halves hand conv1/conv2's weights to the GN+SiLU+conv
        # kernels, which read them channels-last as the conv kernel does
        # (their forward is not called then)
        kernel_layout = conv3x3_kernel or fused_gn_conv
        self.conv1 = Conv3x3(in_ch, out_ch, dtype=dtype,
                             param_dtype=param_dtype, kernel=kernel_layout)
        if temb_ch is not None:
            self.time_emb_proj = Linear(temb_ch, out_ch, dtype=dtype,
                                        param_dtype=param_dtype)
        else:
            self.time_emb_proj = None
        self.norm2 = GroupNorm(groups, out_ch, eps=eps, dtype=param_dtype)
        self.conv2 = Conv3x3(out_ch, out_ch, dtype=dtype,
                             param_dtype=param_dtype, kernel=kernel_layout)
        self.conv_shortcut = (Conv2d(in_ch, out_ch, 1, dtype=dtype,
                                     param_dtype=param_dtype)
                              if in_ch != out_ch else None)

    def _half(self, x, norm: GroupNorm, conv: Conv2d):
        """conv(silu(norm(x))) + bias. Fused: the GN+SiLU+conv op where the
        JAX package's gate passes, else its unfused composition (the JAX
        ResnetBlock._fused)."""
        if not self.fused_gn_conv:
            return conv(gn_silu(norm, x, self.dtype, fused=self.fused_gn))
        b, ci, h, w = x.shape
        ok = gn_silu_conv3x3_ok((b, h, w, ci), (3, 3, ci, conv.out_channels),
                                norm.num_groups)
        fn = gn_silu_conv3x3 if ok else gn_silu_conv3x3_ref
        y = fn(x.to(self.dtype), norm.weight, norm.bias, conv.weight,
               norm.num_groups, norm.eps)
        return y + conv.bias.to(self.dtype)[:, None, None]

    def forward(self, x, temb=None):
        h = self._half(x, self.norm1, self.conv1)
        if self.time_emb_proj is not None:
            t = self.time_emb_proj(F.silu(temb).to(self.dtype))
            h = h + t[:, :, None, None]
        h = self._half(h, self.norm2, self.conv2)
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return h + residual


class Attention(nn.Module):
    """diffusers Attention: to_q/k/v without bias, to_out.0 with bias.
    Self-attention when `context` is None."""

    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 head_dim: int, dtype, param_dtype, use_flash: bool = False):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.use_flash = use_flash
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype,
                           param_dtype=param_dtype)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype,
                           param_dtype=param_dtype)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype,
                           param_dtype=param_dtype)
        self.to_out = nn.ModuleList([Linear(inner, query_dim, dtype=dtype,
                                            param_dtype=param_dtype)])

    def forward(self, x, context=None, capture_probs: bool = False):
        is_self = context is None
        context = x if context is None else context
        b, sq, _ = x.shape
        sk = context.shape[1]
        q = self.to_q(x).view(b, sq, self.heads, self.head_dim)
        k = self.to_k(context).view(b, sk, self.heads, self.head_dim)
        v = self.to_v(context).view(b, sk, self.heads, self.head_dim)
        probs = None
        if capture_probs:
            out, probs = dot_product_attention(q, k, v, return_probs=True)
        else:
            out = dot_product_attention(q, k, v,
                                        use_flash=self.use_flash and is_self)
        return self.to_out[0](out.reshape(b, sq, -1)), probs


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype, param_dtype):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, dtype=dtype,
                           param_dtype=param_dtype)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype, param_dtype):
        super().__init__()
        self.net = nn.ModuleList([
            GEGLU(dim, dim * 4, dtype, param_dtype), nn.Dropout(0.0),
            Linear(dim * 4, dim, dtype=dtype, param_dtype=param_dtype)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention, GEGLU feed-forward."""

    def __init__(self, dim: int, heads: int, context_dim: int, dtype,
                 param_dtype, use_flash: bool):
        super().__init__()
        self.dtype = dtype
        head_dim = dim // heads
        self.norm1 = LayerNorm(dim, dtype=param_dtype)
        self.attn1 = Attention(dim, dim, heads, head_dim, dtype, param_dtype,
                               use_flash)
        self.norm2 = LayerNorm(dim, dtype=param_dtype)
        self.attn2 = Attention(dim, context_dim, heads, head_dim, dtype,
                               param_dtype, use_flash)
        self.norm3 = LayerNorm(dim, dtype=param_dtype)
        self.ff = FeedForward(dim, dtype, param_dtype)

    def forward(self, x, context, capture_probs: bool = False):
        x = x + self.attn1(self.norm1(x).to(self.dtype))[0]
        h, probs = self.attn2(self.norm2(x).to(self.dtype), context,
                              capture_probs=capture_probs)
        x = x + h
        return x + self.ff(self.norm3(x).to(self.dtype)), probs


class Transformer2DModel(nn.Module):
    """Spatial transformer with linear projections and `depth` blocks (one
    in SD-2; up to ten in SDXL). With `capture_probs` it returns the last
    block's cross-attention probabilities."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 groups: int, dtype, param_dtype, use_flash: bool,
                 fused_gn: bool = False, depth: int = 1):
        super().__init__()
        self.dtype = dtype
        self.fused_gn = fused_gn
        self.norm = GroupNorm(groups, channels, eps=1e-6, dtype=param_dtype)
        self.proj_in = Linear(channels, channels, dtype=dtype,
                              param_dtype=param_dtype)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            channels, heads, context_dim, dtype, param_dtype, use_flash)
            for _ in range(depth)])
        self.proj_out = Linear(channels, channels, dtype=dtype,
                               param_dtype=param_dtype)

    def forward(self, x, context, capture_probs: bool = False):
        b, c, h, w = x.shape
        hid = gn_silu(self.norm, x, self.dtype, act=False,
                      fused=self.fused_gn)
        hid = hid.permute(0, 2, 3, 1).reshape(b, h * w, c)
        hid = self.proj_in(hid)
        for block in self.transformer_blocks:
            hid, probs = block(hid, context, capture_probs)
        hid = self.proj_out(hid)
        return hid.reshape(b, h, w, c).permute(0, 3, 1, 2) + x, probs


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype, param_dtype):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1,
                           dtype=dtype, param_dtype=param_dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype, param_dtype,
                 conv3x3_kernel: Union[bool, str] = False):
        super().__init__()
        self.conv = Conv3x3(channels, channels, dtype=dtype,
                            param_dtype=param_dtype, kernel=conv3x3_kernel)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D (heads > 0) or DownBlock2D."""

    def __init__(self, in_ch, out_ch, temb_ch, num_layers, heads,
                 context_dim, add_downsample, groups, dtype, param_dtype,
                 use_flash, fused_gn_conv=False, fused_gn=False,
                 conv3x3_kernel=False, depth=1):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, temb_ch,
                          groups, 1e-5, dtype, param_dtype, fused_gn_conv,
                          fused_gn, conv3x3_kernel)
            for i in range(num_layers)])
        self.attentions = (nn.ModuleList([
            Transformer2DModel(out_ch, heads, context_dim, groups, dtype,
                               param_dtype, use_flash, fused_gn, depth)
            for _ in range(num_layers)]) if heads else None)
        self.downsamplers = (nn.ModuleList([Downsample2D(out_ch, dtype,
                                                         param_dtype)])
                             if add_downsample else None)

    def forward(self, x, temb, context, capture_probs: bool = False):
        skips, probs = [], []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x, p = self.attentions[i](x, context, capture_probs)
                probs.append(p)
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips, probs


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D (heads > 0) or UpBlock2D."""

    def __init__(self, prev_ch, skip_chs: Sequence[int], out_ch, temb_ch,
                 heads, context_dim, add_upsample, groups, dtype,
                 param_dtype, use_flash, fused_gn_conv=False, fused_gn=False,
                 conv3x3_kernel=False, depth=1):
        super().__init__()
        resnets = []
        ch = prev_ch
        for skip_ch in skip_chs:
            # the concat of trunk and skip feeds one conv, as in the JAX
            # package with any pallas_conv (no SplitInputConv there)
            resnets.append(ResnetBlock2D(ch + skip_ch, out_ch, temb_ch,
                                         groups, 1e-5, dtype, param_dtype,
                                         fused_gn_conv, fused_gn,
                                         conv3x3_kernel))
            ch = out_ch
        self.resnets = nn.ModuleList(resnets)
        self.attentions = (nn.ModuleList([
            Transformer2DModel(out_ch, heads, context_dim, groups, dtype,
                               param_dtype, use_flash, fused_gn, depth)
            for _ in skip_chs]) if heads else None)
        self.upsamplers = (nn.ModuleList([Upsample2D(
            out_ch, dtype, param_dtype, conv3x3_kernel)])
                           if add_upsample else None)

    def forward(self, x, skips: List[torch.Tensor], temb, context,
                capture_probs: bool = False):
        probs = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[-(i + 1)]], dim=1), temb)
            if self.attentions is not None:
                x, p = self.attentions[i](x, context, capture_probs)
                probs.append(p)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x, probs


class MidBlock(nn.Module):
    def __init__(self, channels, temb_ch, heads, context_dim, groups, dtype,
                 param_dtype, use_flash, fused_gn_conv=False, fused_gn=False,
                 conv3x3_kernel=False, depth=1):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, temb_ch, groups, 1e-5, dtype,
                          param_dtype, fused_gn_conv, fused_gn,
                          conv3x3_kernel)
            for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer2DModel(
            channels, heads, context_dim, groups, dtype, param_dtype,
            use_flash, fused_gn, depth)])

    def forward(self, x, temb, context, capture_probs: bool = False):
        x = self.resnets[0](x, temb)
        x, probs = self.attentions[0](x, context, capture_probs)
        return self.resnets[1](x, temb), [probs]


# The aten ops whose outputs remat='dots' saves (jax.checkpoint_policies.
# dots_saveable): matmuls and convolutions. The CUDA kernels launched
# through ctypes (flash attention, the conv and GroupNorm kernels) are not
# aten ops, so no policy can save their outputs: under either remat mode
# the backward reruns their forward, and their launch counts grow by it.
_DOTS = frozenset([torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                   torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
                   torch.ops.aten.convolution.default])


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_call(mode, block, *args):
    """block(*args), recomputed in the backward (non-reentrant
    checkpoint) when `mode` is set and a graph is being recorded."""
    if not mode or not torch.is_grad_enabled():
        return block(*args)
    kwargs = {}
    if mode == "dots":
        kwargs["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(block, *args, use_reentrant=False, **kwargs)


class UNetEncoder(nn.Module):
    """What the U-Net and a ControlNet share: the input conv, the time
    embedding (with SDXL's added embedding), the down blocks and the mid
    block, registered in the U-Net's order."""

    def _init_encoder(self, cfg: UNetConfig):
        self.config = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        g = cfg.norm_num_groups
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        flash = cfg.flash_attention
        switches = (cfg.fused_gn_conv, cfg.fused_gn, cfg.conv3x3_kernel)
        self.conv_in = Conv2d(cfg.in_channels, ch0, 3, padding=1, dtype=dt,
                              param_dtype=pdt)
        self.time_embedding = nn.Module()
        self.time_embedding.linear_1 = Linear(ch0, temb_ch, dtype=dt,
                                              param_dtype=pdt)
        self.time_embedding.linear_2 = Linear(temb_ch, temb_ch, dtype=dt,
                                              param_dtype=pdt)
        self.add_embedding = None
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = nn.Module()
            self.add_embedding.linear_1 = Linear(
                cfg.projection_class_embeddings_input_dim, temb_ch,
                dtype=dt, param_dtype=pdt)
            self.add_embedding.linear_2 = Linear(temb_ch, temb_ch, dtype=dt,
                                                 param_dtype=pdt)

        n = len(cfg.block_out_channels)
        down, ch, skip_chs = [], ch0, [ch0]
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[i]
            heads = cfg.num_heads[i] if btype == "CrossAttnDownBlock2D" else 0
            down.append(DownBlock(ch, out_ch, temb_ch, cfg.layers_per_block,
                                  heads, cfg.cross_attention_dim, i < n - 1,
                                  g, dt, pdt, flash, *switches,
                                  depth=cfg.depth(i)))
            skip_chs.extend([out_ch] * cfg.layers_per_block)
            if i < n - 1:
                skip_chs.append(out_ch)
            ch = out_ch
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = MidBlock(ch, temb_ch, cfg.num_heads[-1],
                                  cfg.cross_attention_dim, g, dt, pdt, flash,
                                  *switches, depth=cfg.depth(-1))
        # the channels of the skip connections, in the order they are made
        self.skip_channels = tuple(skip_chs)
        return temb_ch, g, flash, switches

    def _embed(self, timesteps, sample, text_embeds=None, time_ids=None):
        """The time embedding [B, 4 * ch0] in the compute dtype, plus the
        added embedding of `text_embeds` [B, P] and `time_ids` [B, 6]
        where the config has one."""
        cfg = self.config
        dt = cfg.dtype
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding.linear_1(temb.to(dt))
        temb = self.time_embedding.linear_2(F.silu(temb))
        if self.add_embedding is None:
            return temb
        ids = timestep_embedding(time_ids.flatten(),
                                 cfg.addition_time_embed_dim,
                                 cfg.flip_sin_to_cos, cfg.freq_shift)
        added = torch.cat([text_embeds.float(),
                           ids.reshape(text_embeds.shape[0], -1)], dim=-1)
        aug = self.add_embedding.linear_1(added.to(dt))
        return temb + self.add_embedding.linear_2(F.silu(aug))

    def _encode(self, x, temb, context, capture_attention: bool):
        """Down blocks and mid block on the input features `x`: (the mid
        block's output, the skip connections, the down and mid blocks'
        cross-attention probabilities)."""
        cfg = self.config
        skips = [x]
        attn_down = []
        for i, block in enumerate(self.down_blocks):
            x, block_skips, probs = _remat_call(
                cfg.remat, block, x, temb, context, capture_attention)
            skips.extend(block_skips)
            if cfg.down_block_types[i] == "CrossAttnDownBlock2D":
                attn_down.append(probs)
        x, attn_mid = self.mid_block(x, temb, context, capture_attention)
        return x, skips, attn_down, attn_mid


class UNet2DConditionModel(UNetEncoder):
    """The denoising U-Net. Input NCHW; returns (eps, activations, attn)."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = config
        temb_ch, g, flash, switches = self._init_encoder(cfg)
        dt, pdt = cfg.dtype, cfg.param_dtype
        n = len(cfg.block_out_channels)
        skip_chs = list(self.skip_channels)
        up, prev = [], cfg.block_out_channels[-1]
        rev_channels = list(reversed(cfg.block_out_channels))
        rev_heads = list(reversed(cfg.num_heads))
        for i, btype in enumerate(cfg.up_block_types):
            out_ch = rev_channels[i]
            heads = rev_heads[i] if btype == "CrossAttnUpBlock2D" else 0
            block_skips = [skip_chs.pop()
                           for _ in range(cfg.layers_per_block + 1)]
            up.append(UpBlock(prev, block_skips, out_ch, temb_ch, heads,
                              cfg.cross_attention_dim, i < n - 1, g, dt, pdt,
                              flash, *switches, depth=cfg.depth(n - 1 - i)))
            prev = out_ch
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(g, prev, eps=1e-5, dtype=pdt)
        # the output conv runs in fp32, like the JAX model's
        self.conv_out = Conv2d(prev, cfg.out_channels, 3, padding=1,
                               dtype=torch.float32, param_dtype=pdt)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.per_image = cfg.conv_per_image
        self._graphs = unet_graphs.UNetGraphs()

    def _apply(self, fn, *args, **kwargs):
        # the graphs read the parameters in place: drop them where the
        # parameters may become other tensors
        self._graphs = unet_graphs.UNetGraphs()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._graphs = unet_graphs.UNetGraphs()
        return super().load_state_dict(*args, **kwargs)

    def forward(self, sample, timesteps, encoder_hidden_states,
                capture_attention: bool = False):
        """sample [B, C_in, H, W]; timesteps scalar or [B];
        encoder_hidden_states [B, 77, cross_attention_dim].

        Returns eps [B, out, H, W] fp32, the decoder activations (fp32,
        NCHW; one per cross-attention up block) and, with
        `capture_attention`, a dict of cross-attention probability lists
        ('down', 'mid', 'up'), else None. On CUDA a signature's later calls
        replay CUDA graphs of its second (`unet_graphs.py`), with the same
        kernels and the same results. SDXL's U-Net is called through
        `controlnet.ControlNetDenoiser`, which gives `_forward` its added
        conditions and residuals."""
        with span("unet"):
            return self._graphs.call(self, self._forward, sample, timesteps,
                                     encoder_hidden_states,
                                     capture_attention)

    def _forward(self, sample, timesteps, encoder_hidden_states,
                 capture_attention: bool, text_embeds=None, time_ids=None,
                 down_residuals=None, mid_residual=None):
        """The eager forward (`forward`). SDXL: text_embeds [B, P] and
        time_ids [B, 6] feed the added embedding, and a ControlNet's
        residuals, where given, are added to the skip connections
        (`down_residuals`, in their order) and to the mid block's
        output."""
        cfg = self.config
        dt = cfg.dtype
        temb = self._embed(timesteps, sample, text_embeds, time_ids)
        context = encoder_hidden_states.to(dt)

        x, skips, attn_down, attn_mid = self._encode(
            self.conv_in(sample.to(dt)), temb, context, capture_attention)
        if down_residuals is not None:
            skips = [s + r for s, r in zip(skips, down_residuals)]
        if mid_residual is not None:
            x = x + mid_residual

        activations, attn_up = [], []
        for i, block in enumerate(self.up_blocks):
            num_layers = cfg.layers_per_block + 1
            block_skips = skips[-num_layers:]
            skips = skips[:-num_layers]
            x, probs = _remat_call(cfg.remat, block, x, block_skips, temb,
                                   context, capture_attention)
            if cfg.up_block_types[i] == "CrossAttnUpBlock2D":
                activations.append(x.float())
                attn_up.append(probs)

        eps = self.conv_out(gn_silu(self.conv_norm_out, x, dt,
                                    fused=cfg.fused_gn))
        attn = ({"down": attn_down, "mid": attn_mid, "up": attn_up}
                if capture_attention else None)
        return eps.float(), tuple(activations), attn
