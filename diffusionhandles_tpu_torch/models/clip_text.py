"""CLIP text encoders, transformers CLIPTextModel module names
(`text_model.` prefix).

The counterpart of the JAX package's `models/clip_text.py`: SD-2's
OpenCLIP ViT-H tower encodes prompts to [B, 77, 1024] last hidden states
with a causal mask and a final layer norm, in fp32. SDXL reads two towers
(CLIP ViT-L/14 and OpenCLIP bigG/14) at their penultimate layer, before
any final norm (`CLIPTextConfig.penultimate`), and bigG's pooled output:
the final-norm state at the end token through `text_projection`
(`CLIPTextModelWithProjection`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """Defaults match stabilityai/stable-diffusion-2(-depth) text_encoder."""

    vocab_size: int = 49408
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_heads: int = 16
    num_layers: int = 23
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "gelu"  # SD-2: exact gelu
    # the context is the hidden state before the last layer, with no final
    # norm (SDXL's towers); else the final-norm state after every layer
    penultimate: bool = False
    # the width of the pooled output's projection (SDXL's bigG: 1280);
    # None: the tower has no projection
    projection_dim: Optional[int] = None


def tiny_clip_config(**overrides) -> CLIPTextConfig:
    base = dict(vocab_size=1024, hidden_size=32, intermediate_size=64,
                num_heads=2, num_layers=2)
    base.update(overrides)
    return CLIPTextConfig(**base)


def _act(name: str, x):
    if name == "gelu":
        return F.gelu(x)
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    raise ValueError(f"Unknown activation {name}")


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.head_dim = d // cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, causal_mask):
        b, s, d = x.shape
        shape = (b, s, self.heads, self.head_dim)
        q = self.q_proj(x).view(shape)
        k = self.k_proj(x).view(shape)
        v = self.v_proj(x).view(shape)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.head_dim ** -0.5
        logits = logits.masked_fill(~causal_mask,
                                    torch.finfo(logits.dtype).min)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = cfg.hidden_act
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(_act(self.act, self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)

    def forward(self, x, causal_mask):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size,
                                                       cfg.hidden_size)
        self.embeddings.position_embedding = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                             for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.penultimate = cfg.penultimate

    def forward(self, input_ids, pooled: bool = False):
        """The context; with `pooled`, (the context, the final-norm state
        at each row's end token, the largest id)."""
        s = input_ids.shape[-1]
        pos = torch.arange(s, device=input_ids.device)
        x = (self.embeddings.token_embedding(input_ids)
             + self.embeddings.position_embedding(pos)[None])
        causal = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                       device=input_ids.device))[None, None]
        last = len(self.encoder.layers) - 1
        for i, layer in enumerate(self.encoder.layers):
            if self.penultimate and i == last:
                context = x
                if not pooled:
                    return context
            x = layer(x, causal)
        x = self.final_layer_norm(x)
        if not self.penultimate:
            context = x
        if not pooled:
            return context
        rows = torch.arange(x.shape[0], device=x.device)
        return context, x[rows, input_ids.argmax(dim=-1)]


class CLIPTextModel(nn.Module):
    """input_ids [B, 77] (int64) -> last_hidden_state [B, 77, hidden]."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids):
        return self.text_model(input_ids)


class CLIPTextModelWithProjection(CLIPTextModel):
    """input_ids [B, 77] -> (the context [B, 77, hidden], the pooled
    output [B, projection_dim]: the final-norm state at the end token
    through `text_projection`, which has no bias)."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__(config)
        self.text_projection = nn.Linear(config.hidden_size,
                                         config.projection_dim, bias=False)

    def forward(self, input_ids):
        context, pooled = self.text_model(input_ids, pooled=True)
        return context, self.text_projection(pooled)
