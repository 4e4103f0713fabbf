"""Segment Anything (SAM), release-convertible.

The counterpart of the JAX package's `models/sam.py`: the published graph
with the facebookresearch/segment-anything module names
(`image_encoder.*`, `prompt_encoder.*`, `mask_decoder.*`), so a released
`sam_vit_{b,l,h}` state dict loads strictly (models/weights_sam.py):

* ImageEncoderViT (ViT-det): 16x16 patch embed, a learned absolute
  position embedding, blocks with decomposed relative-position attention
  (windowed, 14x14 with the grid padded to a multiple, except at the global
  indices) and a bias-free 1x1 / 3x3 conv neck with channel LayerNorms;
* PromptEncoder: random-Fourier point encoding, per-label point
  embeddings, box corner embeddings, mask downscaling convs, the no-mask
  dense embedding;
* MaskDecoder: the two-way transformer, an IoU token and 4 mask tokens,
  transposed-conv 4x upscaling, hypernetwork MLPs and the IoU head.

The attention logits carry an additive relative-position term, so they are
computed densely (matmul and softmax in fp32), as the JAX package does.
Images and embeddings are NCHW (the JAX package: NHWC). fp32; the modules
do not turn TF32 on (set torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False to keep every product fp32). The
layer norms take the JAX package's epsilon, 1e-6.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.ops.resize import resize_nchw
from diffusionhandles_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-6  # flax's LayerNorm default, which the JAX package uses


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768            # vit_b; vit_l 1024, vit_h 1280
    depth: int = 12                 # vit_b; vit_l 24, vit_h 32
    num_heads: int = 12             # vit_b; vit_l/h 16
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    mlp_ratio: float = 4.0
    prompt_embed_dim: int = 256
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    decoder_depth: int = 2
    num_mask_tokens: int = 4        # 1 primary + 3 multimask

    @property
    def embedding_size(self) -> int:
        return self.img_size // self.patch_size


def sam_vit_b() -> SAMConfig:
    return SAMConfig()


def sam_vit_l() -> SAMConfig:
    return SAMConfig(embed_dim=1024, depth=24, num_heads=16,
                     global_attn_indexes=(5, 11, 17, 23))


def sam_vit_h() -> SAMConfig:
    return SAMConfig(embed_dim=1280, depth=32, num_heads=16,
                     global_attn_indexes=(7, 15, 23, 31))


def tiny_sam_config(**overrides) -> SAMConfig:
    # prompt_embed_dim must stay >= 64 (mask_downscaling uses dim // 64)
    base = dict(img_size=64, embed_dim=32, depth=2, num_heads=2,
                global_attn_indexes=(1,), window_size=2,
                prompt_embed_dim=64, decoder_mlp_dim=64)
    base.update(overrides)
    return SAMConfig(**base)


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW tensor."""

    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        x = F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], self.weight,
                         self.bias, self.eps)
        return x.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Image encoder (ViT-det)
# ---------------------------------------------------------------------------

def _rel_pos_logits(q2d, rel_pos_h, rel_pos_w):
    """Decomposed relative-position logits (ViT-det). q2d [B*, qh, qw, c]
    (the UNSCALED q, per the published ordering); rel_pos_* [2*size-1, c].
    Returns [B*, qh, qw, qh, qw]."""
    qh, qw = q2d.shape[1], q2d.shape[2]
    dev = q2d.device
    idx_h = (torch.arange(qh, device=dev)[:, None]
             - torch.arange(qh, device=dev)[None, :] + (qh - 1))
    idx_w = (torch.arange(qw, device=dev)[:, None]
             - torch.arange(qw, device=dev)[None, :] + (qw - 1))
    rel_h = torch.einsum("bhwc,hkc->bhwk", q2d, rel_pos_h[idx_h])
    rel_w = torch.einsum("bhwc,wkc->bhwk", q2d, rel_pos_w[idx_w])
    return rel_h[..., :, None] + rel_w[..., None, :]


class ViTDetAttention(nn.Module):
    """Multi-head attention over a [B, H, W, C] grid with decomposed
    relative positions (tables sized to this block's grid)."""

    def __init__(self, config: SAMConfig, grid: int):
        super().__init__()
        c = config.embed_dim
        self.num_heads = config.num_heads
        hd = c // config.num_heads
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * grid - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * grid - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)
        attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
        attn = attn.view(b * nh, h, w, h, w) + _rel_pos_logits(
            q.reshape(b * nh, h, w, hd), self.rel_pos_h, self.rel_pos_w)
        attn = torch.softmax(attn.view(b * nh, h * w, h * w), dim=-1)
        out = (attn @ v).view(b, nh, h, w, hd).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(b, h, w, c))


def _window_partition(x, ws: int):
    b, h, w, c = x.shape
    ph, pw = (-h) % ws, (-w) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def _window_unpartition(wins, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp // ws * (wp // ws))
    x = wins.view(b, hp // ws, wp // ws, ws, ws, -1).transpose(2, 3)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class ViTDetBlock(nn.Module):
    def __init__(self, config: SAMConfig, window_size: int, grid: int):
        """window_size 0: global attention over the `grid` x `grid`
        embedding."""
        super().__init__()
        c = config.embed_dim
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = ViTDetAttention(config, window_size or grid)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.lin1 = nn.Linear(c, int(c * config.mlp_ratio))
        self.mlp.lin2 = nn.Linear(int(c * config.mlp_ratio), c)

    def forward(self, x):
        h = self.norm1(x)
        if self.window_size > 0:
            hw = h.shape[1:3]
            h, pad_hw = _window_partition(h, self.window_size)
        h = self.attn(h)
        if self.window_size > 0:
            h = _window_unpartition(h, self.window_size, pad_hw, hw)
        x = x + h
        return x + self.mlp.lin2(F.gelu(self.mlp.lin1(self.norm2(x))))


class ImageEncoderViT(nn.Module):
    def __init__(self, config: SAMConfig):
        super().__init__()
        cfg = config
        e = cfg.embedding_size
        d = cfg.prompt_embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size,
                                          cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, e, e, cfg.embed_dim))
        self.blocks = nn.ModuleList([
            ViTDetBlock(cfg, 0 if i in cfg.global_attn_indexes
                        else cfg.window_size, e) for i in range(cfg.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(cfg.embed_dim, d, 1, bias=False), LayerNorm2d(d),
            nn.Conv2d(d, d, 3, padding=1, bias=False), LayerNorm2d(d))

    def forward(self, x):
        """x [B, 3, img_size, img_size] (normalized) -> [B, 256, E, E]."""
        h = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        return self.neck(h.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        # a buffer in the release state dict
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))


class PromptEncoder(nn.Module):
    """Points (+labels), boxes and mask inputs -> sparse [B, P, D] and
    dense [B, D, E, E] embeddings. Point labels: 1 fg, 0 bg, -1 padding."""

    def __init__(self, config: SAMConfig):
        super().__init__()
        self.config = config
        d = config.prompt_embed_dim
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        # 0: neg point, 1: pos point, 2: box corner 1, 3: box corner 2
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, d) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, d // 64, 2, 2), LayerNorm2d(d // 64), nn.GELU(),
            nn.Conv2d(d // 64, d // 16, 2, 2), LayerNorm2d(d // 16),
            nn.GELU(), nn.Conv2d(d // 16, d, 1))

    def _pe(self, coords):
        """coords in [0, 1]^2 -> [..., prompt_embed_dim]."""
        g = self.pe_layer.positional_encoding_gaussian_matrix
        proj = 2.0 * math.pi * ((2.0 * coords - 1.0) @ g)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_pe(self):
        """Positional encoding of the embedding grid [E, E, D]."""
        e = self.config.embedding_size
        dev = self.no_mask_embed.weight.device
        c = (torch.arange(e, device=dev, dtype=torch.float32) + 0.5) / e
        yy, xx = torch.meshgrid(c, c, indexing="ij")
        return self._pe(torch.stack([xx, yy], dim=-1))

    def embed_points(self, points, labels):
        """points [B, P, 2] in input-image pixels, labels [B, P]."""
        pe = self._pe((points + 0.5) / self.config.img_size)
        lab = labels[..., None]
        pe = torch.where(lab == -1, self.not_a_point_embed.weight[0], pe)
        zero = pe.new_zeros(())
        pe = pe + torch.where(lab == 0, self.point_embeddings[0].weight[0],
                              zero)
        return pe + torch.where(lab == 1, self.point_embeddings[1].weight[0],
                                zero)

    def embed_boxes(self, boxes):
        """boxes [B, 2, 2] corner points (x1, y1), (x2, y2) in pixels."""
        pe = self._pe((boxes + 0.5) / self.config.img_size)
        corner = torch.stack([self.point_embeddings[2].weight[0],
                              self.point_embeddings[3].weight[0]])
        return pe + corner

    def embed_mask(self, mask):
        """mask [B, 1, 4E, 4E] logits -> dense embedding [B, D, E, E]."""
        return self.mask_downscaling(mask)

    def no_mask_dense(self, batch: int):
        e = self.config.embedding_size
        return self.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
            batch, -1, e, e)

    def forward(self, points, labels, boxes=None, mask=None):
        sparse = self.embed_points(points, labels)
        if boxes is not None:
            sparse = torch.cat([sparse, self.embed_boxes(boxes)], dim=1)
        if mask is not None:
            dense = self.embed_mask(mask)
        else:
            dense = self.no_mask_dense(points.shape[0])
        return sparse, dense


# ---------------------------------------------------------------------------
# Mask decoder (two-way transformer)
# ---------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    def __init__(self, config: SAMConfig, downsample_rate: int = 1):
        super().__init__()
        d = config.prompt_embed_dim
        inner = d // downsample_rate
        self.heads = config.decoder_heads
        self.q_proj = nn.Linear(d, inner)
        self.k_proj = nn.Linear(d, inner)
        self.v_proj = nn.Linear(d, inner)
        self.out_proj = nn.Linear(inner, d)

    def forward(self, q, k, v):
        b = q.shape[0]
        qq, kk, vv = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        d = qq.shape[-1]
        hd = d // self.heads
        qq = qq.reshape(b, -1, self.heads, hd)
        kk = kk.reshape(b, -1, self.heads, hd)
        vv = vv.reshape(b, -1, self.heads, hd)
        logits = torch.einsum("bqhc,bkhc->bhqk", qq, kk) / math.sqrt(hd)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhc->bqhc", attn, vv).reshape(b, -1, d)
        return self.out_proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, config: SAMConfig, skip_first_layer_pe: bool):
        super().__init__()
        d = config.prompt_embed_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(config)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn_token_to_image = DecoderAttention(config, 2)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = MLPBlock(d, config.decoder_mlp_dim)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn_image_to_token = DecoderAttention(config, 2)
        self.norm4 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = queries + self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, config: SAMConfig):
        super().__init__()
        d = config.prompt_embed_dim
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(config, skip_first_layer_pe=(i == 0))
            for i in range(config.decoder_depth)])
        self.final_attn_token_to_image = DecoderAttention(config, 2)
        self.norm_final_attn = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, keys, key_pe, tokens):
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q = queries + tokens
        k = keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """`num_layers` Linear layers with ReLU between (`layers.j`)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, config: SAMConfig):
        super().__init__()
        d = config.prompt_embed_dim
        m = config.num_mask_tokens
        self.num_mask_tokens = m
        self.transformer = TwoWayTransformer(config)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(m, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4),
            nn.GELU(), nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(d, d, d // 8, 3) for _ in range(m)])
        self.iou_prediction_head = MLP(d, d, m, 3)

    def forward(self, image_embedding, image_pe, sparse_prompt,
                dense_prompt):
        """image_embedding [B, D, E, E]; image_pe [E, E, D]; sparse_prompt
        [B, P, D]; dense_prompt [B, D, E, E]. Returns (mask_logits
        [B, M, 4E, 4E], iou_pred [B, M])."""
        b, d, e, _ = image_embedding.shape
        m = self.num_mask_tokens
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], dim=0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1),
                            sparse_prompt], dim=1)
        src = image_embedding + dense_prompt
        keys = src.flatten(2).transpose(1, 2)
        key_pe = image_pe.reshape(1, e * e, d).expand(b, -1, -1)
        queries, keys = self.transformer(keys, key_pe, tokens)
        iou_token_out = queries[:, 0]
        mask_tokens_out = queries[:, 1:m + 1]
        up = self.output_upscaling(keys.transpose(1, 2).reshape(b, d, e, e))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("bmc,bchw->bmhw", hyper_in, up)
        return masks, self.iou_prediction_head(iou_token_out)


class SamModel(nn.Module):
    """Full SAM: submodule names are the release state dict's prefixes."""

    def __init__(self, config: SAMConfig):
        super().__init__()
        self.config = config
        self.image_encoder = ImageEncoderViT(config)
        self.prompt_encoder = PromptEncoder(config)
        self.mask_decoder = MaskDecoder(config)

    def embed(self, image):
        """[B, 3, S, S] normalized -> [B, 256, E, E]."""
        return self.image_encoder(image)

    def decode(self, embedding, points, labels, boxes=None, mask=None):
        sparse, dense = self.prompt_encoder(points, labels, boxes, mask)
        return self.mask_decoder(embedding, self.prompt_encoder.dense_pe(),
                                 sparse, dense)

    def forward(self, image, points, labels, boxes=None, mask=None):
        return self.decode(self.embed(image), points, labels, boxes, mask)


@torch.no_grad()
def seeded_init_sam_(model: SamModel, generator: torch.Generator) -> SamModel:
    """Seeded random weights as flax initializes the JAX model: LeCun
    truncated-normal kernels, zero biases, unit norm scales, zero position
    embedding and relative-position tables, normal(1) prompt embeddings,
    Fourier matrix and output tokens."""
    from diffusionhandles_tpu_torch.diffuser import seeded_init_
    seeded_init_(model, generator)
    for name, p in model.named_parameters():
        if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w")):
            p.zero_()
        elif isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                        nn.Embedding):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device))
    g = model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix
    g.copy_(torch.randn(g.shape, generator=generator, device=g.device))
    return model


# SAM's input normalization (published pixel stats, [0, 255] scale)
_PIXEL_MEAN = (123.675, 116.28, 103.53)
_PIXEL_STD = (58.395, 57.12, 57.375)


class PromptableSegmenter:
    """Point/box-promptable segmentation with the published predictor
    pipeline on `device` (default: the GPU): longest-side resize to
    img_size, bottom/right padding, mask selection by predicted IoU, logit
    upsampling back to the input resolution, threshold at 0. `params` is a
    SamModel state dict (release names; models/weights_sam.py makes one
    from the JAX package's params), else `checkpoint_path` (a released
    .pth), else seeded random weights."""

    def __init__(self, config: Optional[SAMConfig] = None, params=None,
                 seed: int = 0, checkpoint_path: Optional[str] = None,
                 multimask: bool = True, device=None):
        self.config = config or tiny_sam_config()
        self.device = resolve_device(device)
        self.multimask = multimask
        with torch.device(self.device):
            self.model = SamModel(self.config)
        if checkpoint_path is not None:
            from diffusionhandles_tpu_torch.models.weights_sam import \
                load_sam_checkpoint
            params = load_sam_checkpoint(checkpoint_path, self.config)
        if params is None:
            seeded_init_sam_(self.model, torch.Generator(
                device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    def _preprocess(self, img: np.ndarray):
        """img [1, 3, H, W] in [0, 1] -> (padded input [1, 3, S, S],
        resized (h, w), scale)."""
        h, w = img.shape[-2:]
        s = self.config.img_size
        scale = s / max(h, w)
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        x = resize_nchw(x, (nh, nw), "bilinear")
        mean = torch.tensor(_PIXEL_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(_PIXEL_STD, device=x.device)[:, None, None]
        x = F.pad((x * 255.0 - mean) / std, (0, s - nw, 0, s - nh))
        return x, (nh, nw), scale

    @staticmethod
    def _prompts(points, labels, boxes, scale: float):
        """(pts [1, P, 2], lbl [1, P], box [1, 2, 2] or None) as the
        published predictor builds them."""
        if points is None:
            if boxes is not None:
                # box-only prompt: the published PromptEncoder emits NO
                # point tokens (SamPredictor passes points=None; the
                # not_a_point pad comes only beside real points when no box
                # is given): the sparse prompt is the 2 box corners
                pts = np.zeros((1, 0, 2), np.float32)
                lbl = np.zeros((1, 0), np.int64)
            else:
                pts = np.zeros((1, 1, 2), np.float32)
                lbl = -np.ones((1, 1), np.int64)
        else:
            pts = np.asarray(points, np.float32).reshape(1, -1, 2) * scale
            lbl = (np.ones((1, pts.shape[1]), np.int64) if labels is None
                   else np.asarray(labels, np.int64).reshape(1, -1))
            if boxes is None:  # the pad point (published behavior)
                pts = np.concatenate([pts, np.zeros((1, 1, 2), np.float32)],
                                     axis=1)
                lbl = np.concatenate([lbl, -np.ones((1, 1), np.int64)],
                                     axis=1)
        box = (None if boxes is None else
               np.asarray(boxes, np.float32).reshape(1, 2, 2) * scale)
        return pts, lbl, box

    @torch.no_grad()
    def mask_logits(self, img: np.ndarray, points=None, labels=None,
                    boxes=None):
        """The chosen mask's logits at the input resolution [1, H, W] and
        its IoU score; `predict` thresholds them at 0."""
        h, w = img.shape[-2:]
        x, (nh, nw), scale = self._preprocess(img)
        emb = self.model.embed(x)
        pts, lbl, box = self._prompts(points, labels, boxes, scale)
        t = lambda a: None if a is None else torch.as_tensor(
            a, device=self.device)
        masks, iou = self.model.decode(emb, t(pts), t(lbl), t(box))
        best = 1 + int(torch.argmax(iou[0, 1:])) if self.multimask else 0
        s = self.config.img_size
        logits = resize_nchw(masks[:, best:best + 1], (s, s), "bilinear")
        logits = resize_nchw(logits[..., :nh, :nw], (h, w), "bilinear")
        return logits[:, 0].cpu().numpy(), float(iou[0, best])

    def predict(self, img: np.ndarray, points=None, labels=None,
                boxes=None):
        """img [1, 3, H, W] in [0, 1]; points [P, 2] pixel coordinates;
        labels [P]; boxes [x1, y1, x2, y2]. Returns (mask [1, 1, H, W],
        IoU score)."""
        logits, iou = self.mask_logits(img, points, labels, boxes)
        return (logits > 0.0)[:, None].astype(np.float32), iou

    def segment(self, img: np.ndarray, points, labels=None) -> np.ndarray:
        """The best mask [1, 1, H, W] for point prompts."""
        mask, _ = self.predict(img, points=points, labels=labels)
        return mask
