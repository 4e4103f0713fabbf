"""SDXL's ControlNet (diffusers ControlNetModel semantics), NCHW, and the
denoiser that runs it with the U-Net.

A ControlNet is a copy of the U-Net's encoder (input conv, time and added
embeddings, down blocks, mid block: `unet.UNetEncoder`) whose input
features also receive the conditioning network's embedding of the control
image (convs on the image's full resolution, three of them with stride 2,
down to the latent grid), and whose skip connections and mid-block output
each pass through a 1x1 conv (`controlnet_down_blocks`,
`controlnet_mid_block`, zero-initialised in training) to become the
residuals that the U-Net adds to its own, scaled by the conditioning
scale. Modules carry the diffusers names, so the state dict has a real
checkpoint's keys (`controlnet_cond_embedding.blocks.3.weight`).

`ControlNetDenoiser` is one denoiser call, ControlNet then U-Net, under
the `unet` span with the ControlNet's forward in a `controlnet` span; on
CUDA its calls replay CUDA graphs of the pair (`unet_graphs.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.models import unet_graphs
from diffusionhandles_tpu_torch.models.unet import (Conv2d, UNetConfig,
                                                    UNetEncoder)
from diffusionhandles_tpu_torch.utils.profiling import span


# the scale of the residuals in the controlnet-depth-sdxl-1.0 model card's
# example (diffusers' default is 1.0)
SDXL_CONDITIONING_SCALE = 0.5


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """The conditioning network's widths (diffusers/controlnet-depth-sdxl
    -1.0) and the scale of the residuals (a pipeline argument, fixed per
    model here: a captured graph holds it)."""

    conditioning_channels: int = 3
    conditioning_embedding_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    conditioning_scale: float = 1.0


class ControlNetConditioningEmbedding(nn.Module):
    """Control image [B, 3, H, W] -> features on the latent grid [B, ch0,
    H / 8, W / 8] at SDXL's four widths: a 3x3 conv, then per width a 3x3
    conv and a stride-2 3x3 conv to the next width, SiLU after each, and a
    3x3 conv out."""

    def __init__(self, out_channels: int, cfg: ControlNetConfig, dtype,
                 param_dtype):
        super().__init__()
        widths = cfg.conditioning_embedding_out_channels

        def conv(a, b, stride=1):
            return Conv2d(a, b, 3, stride=stride, padding=1, dtype=dtype,
                          param_dtype=param_dtype)
        self.conv_in = conv(cfg.conditioning_channels, widths[0])
        blocks = []
        for a, b in zip(widths, widths[1:]):
            blocks += [conv(a, a), conv(a, b, 2)]
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = conv(widths[-1], out_channels)

    def forward(self, image):
        x = F.silu(self.conv_in(image))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNetModel(UNetEncoder):
    """(sample, timesteps, context, control image, text_embeds, time_ids)
    -> (the residuals of the U-Net's skip connections, of its mid block),
    in the compute dtype, scaled by `config.conditioning_scale`."""

    def __init__(self, unet_config: UNetConfig,
                 config: ControlNetConfig = ControlNetConfig()):
        super().__init__()
        self.cn_config = config
        self._init_encoder(unet_config)
        dt, pdt = unet_config.dtype, unet_config.param_dtype
        ch0 = unet_config.block_out_channels[0]
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            ch0, config, dt, pdt)
        self.controlnet_down_blocks = nn.ModuleList([
            Conv2d(c, c, 1, dtype=dt, param_dtype=pdt)
            for c in self.skip_channels])
        mid = unet_config.block_out_channels[-1]
        self.controlnet_mid_block = Conv2d(mid, mid, 1, dtype=dt,
                                           param_dtype=pdt)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.per_image = unet_config.conv_per_image

    def forward(self, sample, timesteps, encoder_hidden_states, control,
                text_embeds=None, time_ids=None):
        cfg = self.config
        dt = cfg.dtype
        temb = self._embed(timesteps, sample, text_embeds, time_ids)
        context = encoder_hidden_states.to(dt)
        x = (self.conv_in(sample.to(dt))
             + self.controlnet_cond_embedding(control.to(dt)))
        x, skips, _, _ = self._encode(x, temb, context, False)
        scale = self.cn_config.conditioning_scale
        down = [conv(s) * scale
                for conv, s in zip(self.controlnet_down_blocks, skips)]
        return down, self.controlnet_mid_block(x) * scale


class ControlNetDenoiser(nn.Module):
    """One denoiser call of the SDXL family: the ControlNet on the control
    image, then the U-Net with its residuals. (sample [B, 4, h, w],
    timesteps, context [B, 77, D], control [B, 3, H, W], text_embeds
    [B, P], time_ids [B, 6]) -> the U-Net's (eps, activations, attn)."""

    def __init__(self, unet: nn.Module, controlnet: ControlNetModel):
        super().__init__()
        self.unet = unet
        self.controlnet = controlnet
        self._graphs = unet_graphs.UNetGraphs()

    @property
    def config(self) -> UNetConfig:
        return self.unet.config

    def _apply(self, fn, *args, **kwargs):
        # as the U-Net's: the graphs read the parameters in place
        self._graphs = unet_graphs.UNetGraphs()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self._graphs = unet_graphs.UNetGraphs()
        return super().load_state_dict(*args, **kwargs)

    def forward(self, sample, timesteps, encoder_hidden_states, control,
                text_embeds, time_ids, capture_attention: bool = False):
        with span("unet"):
            return self._graphs.call(
                self, self._forward, sample, timesteps,
                encoder_hidden_states, capture_attention,
                (control, text_embeds, time_ids))

    def _forward(self, sample, timesteps, encoder_hidden_states,
                 capture_attention: bool, control, text_embeds, time_ids):
        with span("controlnet"):
            down, mid = self.controlnet(sample, timesteps,
                                        encoder_hidden_states, control,
                                        text_embeds, time_ids)
        return self.unet._forward(sample, timesteps, encoder_hidden_states,
                                  capture_attention, text_embeds, time_ids,
                                  down, mid)


def control_image(disparity: torch.Tensor, image_res: int) -> torch.Tensor:
    """The ControlNet's control image of a disparity [B, 1, H, W]: resized
    (bicubic) to the image's resolution where it differs, normalised to
    [0, 1] per image and repeated to three channels, fp32 (the
    controlnet-depth-sdxl-1.0 model card's preparation, without its round
    trip through 8-bit pixels)."""
    d = disparity.float()
    if tuple(d.shape[-2:]) != (image_res, image_res):
        d = F.interpolate(d, size=(image_res, image_res), mode="bicubic",
                          align_corners=False)
    dmin = d.amin(dim=(1, 2, 3), keepdim=True)
    dmax = d.amax(dim=(1, 2, 3), keepdim=True)
    return ((d - dmin) / (dmax - dmin)).expand(-1, 3, -1, -1).contiguous()


def sdxl_configs(tiny: bool = False, **unet_fields):
    """(U-Net, ControlNet, VAE, ViT-L tower, bigG tower) configs of SDXL
    base 1.0 with controlnet-depth-sdxl-1.0 (the published config.json
    files of `unet/`, `vae/`, `text_encoder/`, `text_encoder_2/` and of
    the ControlNet), or with `tiny` the same topology at test widths:
    three levels with a DownBlock2D first, transformer depths (1, 1, 2),
    two recorded up blocks, two towers of two layers. `unet_fields`
    (dtypes, route switches, the conditioning scale's
    `conditioning_scale`) override both nets' configs."""
    from diffusionhandles_tpu_torch.models.clip_text import CLIPTextConfig
    from diffusionhandles_tpu_torch.models.vae import VAEConfig
    scale = unet_fields.pop("conditioning_scale", 1.0)
    if tiny:
        widths, depths, heads, time_dim = (32, 32, 64), (1, 1, 2), \
            (2, 2, 2), 8
        c1 = CLIPTextConfig(vocab_size=1024, hidden_size=32,
                            intermediate_size=64, num_heads=2,
                            num_layers=2, hidden_act="quick_gelu",
                            penultimate=True)
        c2 = dataclasses.replace(c1, hidden_size=48, intermediate_size=96,
                                 hidden_act="gelu", projection_dim=40)
        vae = VAEConfig(block_out_channels=(16, 16, 32), layers_per_block=1,
                        norm_num_groups=8, dtype=torch.float32,
                        scaling_factor=0.13025)
        embedding, sample, groups = (4, 8, 16), 8, 8
    else:
        widths, depths, heads, time_dim = (320, 640, 1280), (1, 2, 10), \
            (5, 10, 20), 256
        c1 = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                            num_heads=12, num_layers=12,
                            hidden_act="quick_gelu", penultimate=True)
        c2 = CLIPTextConfig(hidden_size=1280, intermediate_size=5120,
                            num_heads=20, num_layers=32, hidden_act="gelu",
                            penultimate=True, projection_dim=1280)
        vae = VAEConfig(scaling_factor=0.13025)
        embedding, sample, groups = (16, 32, 96, 256), 128, 32
    fields = dict(
        sample_size=sample, in_channels=4, out_channels=4,
        block_out_channels=widths,
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D",
                          "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "CrossAttnUpBlock2D",
                        "UpBlock2D"),
        layers_per_block=2 if not tiny else 1, num_heads=heads,
        cross_attention_dim=c1.hidden_size + c2.hidden_size,
        norm_num_groups=groups, transformer_layers_per_block=depths,
        addition_embed_type="text_time", addition_time_embed_dim=time_dim,
        projection_class_embeddings_input_dim=(c2.projection_dim
                                               + 6 * time_dim))
    if tiny:
        fields["dtype"] = torch.float32
    fields.update(unet_fields)
    if "dtype" in unet_fields and not tiny:
        vae = dataclasses.replace(vae, dtype=unet_fields["dtype"],
                                  param_dtype=unet_fields.get(
                                      "param_dtype", vae.param_dtype))
    ucfg = UNetConfig(**fields)
    cncfg = ControlNetConfig(conditioning_embedding_out_channels=embedding,
                             conditioning_scale=scale)
    return ucfg, cncfg, vae, c1, c2
