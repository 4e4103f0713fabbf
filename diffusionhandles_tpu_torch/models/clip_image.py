"""CLIP image encoder (ViT), the vision tower of the text-prompted
segmenter.

The counterpart of the JAX package's `models/clip_image.py`: a bilinear
resize to `image_size`, CLIP's mean/std, a bias-free patch conv, class and
position embeddings, `ln_pre`, pre-LN blocks with quick-GELU and dense
attention, `ln_post`, and the visual projection applied to the class token
(pooled) and to every patch token.

Module names are the HF `CLIPModel` release's (`vision_model.embeddings.*`,
`vision_model.pre_layrnorm` [the HF spelling], `vision_model.encoder.
layers.N.*`, `vision_model.post_layernorm`, `visual_projection`), so a
released state dict loads strictly (models/weights_clip.py). fp32; the
layer norms take the JAX package's epsilon (1e-6).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from diffusionhandles_tpu_torch.ops.attention import dot_product_attention
from diffusionhandles_tpu_torch.ops.resize import resize_nchw

LN_EPS = 1e-6  # flax's LayerNorm default, which the JAX package uses
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPImageConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    projection_dim: int = 1024


def tiny_clip_image_config(**overrides) -> CLIPImageConfig:
    base = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                num_heads=2, projection_dim=32)
    base.update(overrides)
    return CLIPImageConfig(**base)


class CLIPVisionAttention(nn.Module):
    def __init__(self, cfg: CLIPImageConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        b, s, d = x.shape
        shape = (b, s, self.heads, d // self.heads)
        o = dot_product_attention(self.q_proj(x).view(shape),
                                  self.k_proj(x).view(shape),
                                  self.v_proj(x).view(shape))
        return self.out_proj(o.reshape(b, s, d))


class CLIPViTBlock(nn.Module):
    """Pre-LN block: attention, then fc1 -> quick-GELU -> fc2."""

    def __init__(self, config: CLIPImageConfig):
        super().__init__()
        d = config.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = CLIPVisionAttention(config)
        self.layer_norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, d * config.mlp_ratio)
        self.mlp.fc2 = nn.Linear(d * config.mlp_ratio, d)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        h = self.mlp.fc1(self.layer_norm2(x))
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu (CLIP)
        return x + self.mlp.fc2(h)


class CLIPImageEncoder(nn.Module):
    """img [B, 3, H, W] in [0, 1] -> (pooled [B, proj], patch tokens
    [B, n, n, proj]) (the JAX encoder takes [B, H, W, 3]; its outputs have
    these shapes)."""

    def __init__(self, config: CLIPImageConfig):
        super().__init__()
        self.config = config
        d = config.hidden_size
        n = config.image_size // config.patch_size
        vm = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(d))
        vm.embeddings.patch_embedding = nn.Conv2d(
            3, d, config.patch_size, config.patch_size, bias=False)
        vm.embeddings.position_embedding = nn.Embedding(n * n + 1, d)
        vm.pre_layrnorm = nn.LayerNorm(d, eps=LN_EPS)
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList(
            [CLIPViTBlock(config) for _ in range(config.num_layers)])
        vm.post_layernorm = nn.LayerNorm(d, eps=LN_EPS)
        self.vision_model = vm
        self.visual_projection = nn.Linear(d, config.projection_dim,
                                           bias=False)

    def forward(self, img):
        cfg = self.config
        vm = self.vision_model
        b = img.shape[0]
        x = resize_nchw(img.float(), (cfg.image_size, cfg.image_size),
                        "bilinear")
        mean = torch.tensor(_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(_STD, device=x.device)[:, None, None]
        x = vm.embeddings.patch_embedding((x - mean) / std)
        tokens = x.flatten(2).transpose(1, 2)
        cls = vm.embeddings.class_embedding.expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = vm.pre_layrnorm(tokens
                                 + vm.embeddings.position_embedding.weight)
        for layer in vm.encoder.layers:
            tokens = layer(tokens)
        tokens = self.visual_projection(vm.post_layernorm(tokens))
        n = cfg.image_size // cfg.patch_size
        return tokens[:, 0], tokens[:, 1:].reshape(b, n, n, -1)


@torch.no_grad()
def seeded_init_clip_image_(model: nn.Module,
                            generator: torch.Generator) -> nn.Module:
    """Seeded random weights as flax initializes the JAX encoder: LeCun
    truncated-normal kernels, zero biases, unit norm scales; the class and
    position embeddings and the projection normal(0.02)."""
    from diffusionhandles_tpu_torch.diffuser import seeded_init_
    seeded_init_(model, generator)
    emb = model.vision_model.embeddings
    for p in (emb.class_embedding, emb.position_embedding.weight,
              model.visual_projection.weight):
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=p.device) * 0.02)
    return model
