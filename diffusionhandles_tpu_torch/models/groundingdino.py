"""GroundingDINO (open-vocabulary text -> boxes), the grounding stage of
the reference's LangSAM dependency (reference:
test/estimate_foreground.py:6-40).

The counterpart of the JAX package's `models/groundingdino.py`
(groundingdino_swint_ogc):

* Swin-T backbone (models/swin.py), levels at strides 8/16/32 and an
  extra stride-64 conv level, each projected to d_model with GroupNorm;
* the BERT text tower (models/bert.py) with per-phrase attention blocks
  and position ids, and a 768 -> 256 feature map;
* the feature enhancer: per layer, bi-directional image<->text attention,
  text self-attention and multi-scale deformable image self-attention;
* language-guided query selection: contrastive image-text scores over the
  encoder memory pick the top `num_queries` proposals (lower index first
  among equal scores, as `jax.lax.top_k`), whose refined boxes seed the
  decoder's reference points;
* the cross-modality decoder with iterative box refinement, and the
  contrastive logit head.

Module names are the IDEA-Research release's (`backbone.0.*`, `bert.*`,
`feat_map`, `input_proj.*`, `transformer.*`, and the top-level
`bbox_embed.*`, which is the decoder's `transformer.decoder.bbox_embed`
itself, as in the release), so a released state dict loads strictly
(models/weights_gdino.py). The deformable sampler is `F.grid_sample`
(bilinear, align_corners=False, zero padding) on the map 2 * loc - 1.
fp32; the modules do not turn TF32 on.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.models.bert import (BertConfig, BertModel,
                                                    WordPieceTokenizer,
                                                    tiny_bert_config)
from diffusionhandles_tpu_torch.models.sam import MLP
from diffusionhandles_tpu_torch.models.swin import (SwinConfig,
                                                    SwinTransformer,
                                                    tiny_swin_config)
from diffusionhandles_tpu_torch.ops.resize import resize_nchw
from diffusionhandles_tpu_torch.utils.device import resolve_device

LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    d_model: int = 256
    num_heads: int = 8
    num_levels: int = 4
    num_points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    ffn_dim: int = 2048
    num_queries: int = 900
    max_text_len: int = 256
    fusion_dim: int = 1024      # BiMultiHeadAttention embed dim
    fusion_heads: int = 4
    text_layer_heads: int = 4
    text_layer_ffn: int = 1024
    # bert-base-uncased ids for [CLS], [SEP], '.', '?': the phrase
    # delimiters of generate_masks_with_special_tokens_and_transfer_map
    special_token_ids: Tuple[int, ...] = (101, 102, 1012, 1029)
    # the swint_ogc config's PositionEmbeddingSineHW temperature
    pe_temperature: float = 20.0
    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)


def tiny_gdino_config(**overrides) -> GroundingDinoConfig:
    base = dict(d_model=32, num_heads=4, num_levels=4, num_points=2,
                enc_layers=2, dec_layers=2, ffn_dim=64, num_queries=20,
                max_text_len=32, fusion_dim=64, fusion_heads=2,
                text_layer_heads=2, text_layer_ffn=32,
                swin=tiny_swin_config(), bert=tiny_bert_config())
    base.update(overrides)
    return GroundingDinoConfig(**base)


def _inverse_sigmoid(x, eps: float = 1e-3):
    """The published util.misc.inverse_sigmoid: clamp x to [0, 1], then
    the numerator and denominator separately (x = 1 -> log(1 / eps))."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _sine_embed(x, dim: int, temperature: float = 10000.0):
    """[...] scalar positions -> [..., dim] sine embedding (DETR: scale
    2 pi, per-frequency interleaved sin/cos)."""
    freqs = temperature ** (torch.arange(dim // 2, dtype=torch.float32,
                                         device=x.device) * 2.0 / dim)
    ang = x[..., None] * (2 * math.pi) / freqs
    return torch.stack([torch.sin(ang), torch.cos(ang)],
                       dim=-1).reshape(x.shape + (dim,))


def _box_sine_embed(boxes, d_model: int):
    """cxcywh boxes in [0, 1] -> [..., 2 * d_model]: the published
    gen_sineembed_for_position order (y, x, w, h)."""
    per = d_model // 2
    return torch.cat([_sine_embed(boxes[..., i], per) for i in (1, 0, 2, 3)],
                     dim=-1)


def build_text_token_masks(input_ids, txt_mask, special_ids):
    """The published generate_masks_with_special_tokens_and_transfer_map:
    the tokens between consecutive special tokens ([CLS] / [SEP] / '.' /
    '?') form independent phrases. Each phrase (with its trailing special
    token) gets block self-attention and fresh arange position ids; [CLS]
    and the padding attend only themselves, with position 0.

    input_ids [B, S] int; txt_mask [B, S] bool (the valid tokens).
    Returns (attn [B, S, S] bool, position_ids [B, S] int64)."""
    sp = torch.zeros_like(txt_mask)
    for sid in special_ids:
        sp = sp | (input_ids == sid)
    sp = sp & txt_mask
    s = input_ids.shape[1]
    # block id = the number of special tokens strictly before the token
    block = torch.cumsum(sp.long(), dim=1) - sp.long()
    attn = ((block[:, :, None] == block[:, None, :])
            & txt_mask[:, :, None] & txt_mask[:, None, :])
    attn = attn | torch.eye(s, dtype=torch.bool, device=attn.device)[None]
    # the previous special position (exclusive running max), -1 if none
    idx = torch.arange(s, device=input_ids.device)[None]
    marked = torch.where(sp, idx, torch.full_like(idx, -1))
    run = torch.cummax(marked, dim=1).values
    prev = torch.cat([torch.full_like(run[:, :1], -1), run[:, :-1]], dim=1)
    covered = idx <= marked.max(dim=1, keepdim=True).values
    position_ids = torch.where(covered & txt_mask, idx - prev - 1,
                               torch.zeros_like(idx))
    return attn, position_ids


def select_topk(scores, k: int):
    """Indices [B, k] of the k largest scores per row, in descending order
    and, among equal scores, lower index first (`jax.lax.top_k`'s order,
    which `torch.topk` does not promise): a stable sort of -scores."""
    return torch.sort(-scores, dim=1, stable=True).indices[:, :k]


class MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention's parameters (one packed
    `in_proj_weight` / `in_proj_bias` and `out_proj`) with an explicit
    forward: -1e9 on the masked logits, as the JAX package."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, q, k, v, mask=None):
        """mask: [B, Sq, Sk] or [B, 1, Sk] bool, True = attend."""
        d = q.shape[-1]
        wq, wk, wv = self.in_proj_weight.split(d)
        bq, bk, bv = self.in_proj_bias.split(d)
        b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
        hd = d // self.heads
        qq = F.linear(q, wq, bq).view(b, sq, self.heads, hd)
        kk = F.linear(k, wk, bk).view(b, sk, self.heads, hd)
        vv = F.linear(v, wv, bv).view(b, sk, self.heads, hd)
        logits = torch.einsum("bqhc,bkhc->bhqk", qq, kk) / np.sqrt(hd)
        if mask is not None:
            logits = torch.where(mask[:, None], logits,
                                 logits.new_tensor(-1e9))
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhc->bqhc", attn, vv).reshape(b, sq, d)
        return self.out_proj(out)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (Deformable-DETR)."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        cfg = config
        d, H, L, P = cfg.d_model, cfg.num_heads, cfg.num_levels, cfg.num_points
        self.heads, self.levels, self.points = H, L, P
        self.sampling_offsets = nn.Linear(d, H * L * P * 2)
        self.attention_weights = nn.Linear(d, H * L * P)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, ref_points, value, spatial_shapes):
        """query [B, Q, D]; ref_points [B, Q, 2] (cx, cy) or [B, Q, 4]
        (cxcywh) in [0, 1]; value [B, S, D], the levels flattened;
        spatial_shapes [(h, w)] per level. Returns [B, Q, D]."""
        b, q, d = query.shape
        H, L, P = self.heads, self.levels, self.points
        hd = d // H
        v = self.value_proj(value).view(b, -1, H, hd)
        off = self.sampling_offsets(query).view(b, q, H, L, P, 2)
        w = torch.softmax(self.attention_weights(query).view(b, q, H, L * P),
                          dim=-1)
        if ref_points.shape[-1] == 2:
            norm = torch.tensor([[wd, ht] for (ht, wd) in spatial_shapes],
                                dtype=torch.float32, device=query.device)
            loc = (ref_points[:, :, None, None, None, :]
                   + off / norm[None, None, None, :, None, :])
        else:
            loc = (ref_points[:, :, None, None, None, :2]
                   + off / P * ref_points[:, :, None, None, None, 2:] * 0.5)
        grids = 2.0 * loc - 1.0
        sampled = []
        start = 0
        for lvl, (ht, wd) in enumerate(spatial_shapes):
            vl = v[:, start:start + ht * wd].permute(0, 2, 3, 1).reshape(
                b * H, hd, ht, wd)
            g = grids[:, :, :, lvl].transpose(1, 2).reshape(b * H, q, P, 2)
            sampled.append(F.grid_sample(vl, g, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=False))
            start += ht * wd
        sampled = torch.stack(sampled, dim=-2).flatten(-2)  # [BH, hd, Q, LP]
        wf = w.transpose(1, 2).reshape(b * H, 1, q, L * P)
        out = (sampled * wf).sum(-1).view(b, d, q).transpose(1, 2)
        return self.output_proj(out)


class BiAttention(nn.Module):
    """Bi-directional image<->text attention (GLIP / GroundingDINO
    BiAttentionBlock): pre-LN, clamped logits, layer-scale residuals added
    to the normed inputs."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        cfg = config
        d, e = cfg.d_model, cfg.fusion_dim
        self.heads = cfg.fusion_heads
        self.layer_norm_v = nn.LayerNorm(d, eps=LN_EPS)
        self.layer_norm_l = nn.LayerNorm(d, eps=LN_EPS)
        self.attn = nn.Module()
        for name in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            self.attn.add_module(name, nn.Linear(d, e))
        self.attn.out_v_proj = nn.Linear(e, d)
        self.attn.out_l_proj = nn.Linear(e, d)
        self.gamma_v = nn.Parameter(torch.full((d,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((d,), 1e-4))

    def forward(self, vis, txt, txt_mask):
        a = self.attn
        H = self.heads
        b, sv, _ = vis.shape
        sl = txt.shape[1]
        vn = self.layer_norm_v(vis)
        ln = self.layer_norm_l(txt)
        e = a.v_proj.out_features
        hd = e // H
        qv = a.v_proj(vn).view(b, sv, H, hd) / np.sqrt(hd)
        kl = a.l_proj(ln).view(b, sl, H, hd)
        valv = a.values_v_proj(vn).view(b, sv, H, hd)
        vall = a.values_l_proj(ln).view(b, sl, H, hd)
        logits = torch.einsum("bvhc,blhc->bhvl", qv, kl).clamp(-50000.0,
                                                                50000.0)
        # v attends l (the padded text masked); l attends v
        attn_v = torch.softmax(torch.where(
            txt_mask[:, None, None, :], logits, logits.new_tensor(-1e9)),
            dim=-1)
        attn_l = torch.softmax(logits, dim=2)
        out_v = torch.einsum("bhvl,blhc->bvhc", attn_v, vall).reshape(b, sv,
                                                                      e)
        out_l = torch.einsum("bhvl,bvhc->blhc", attn_l, valv).reshape(b, sl,
                                                                      e)
        return (vn + self.gamma_v * a.out_v_proj(out_v),
                ln + self.gamma_l * a.out_l_proj(out_l))


class TextSelfAttnLayer(nn.Module):
    """Post-LN transformer encoder layer over the text tokens (the
    position embedding is added to q and k only)."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        d = config.d_model
        self.self_attn = MultiheadAttention(d, config.text_layer_heads)
        self.linear1 = nn.Linear(d, config.text_layer_ffn)
        self.linear2 = nn.Linear(config.text_layer_ffn, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, txt, attn_mask, pos):
        """attn_mask [B, S, S] bool: the per-phrase blocks."""
        q = txt + pos
        txt = self.norm1(txt + self.self_attn(q, q, txt, attn_mask))
        return self.norm2(txt + self.linear2(F.relu(self.linear1(txt))))


class DeformableEncoderLayer(nn.Module):
    """Deformable image self-attention + FFN (Deformable-DETR encoder)."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        d = config.d_model
        self.self_attn = MSDeformAttn(config)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, config.ffn_dim)
        self.linear2 = nn.Linear(config.ffn_dim, d)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, src, pos, ref_points, spatial_shapes):
        src = self.norm1(src + self.self_attn(src + pos, ref_points, src,
                                              spatial_shapes))
        return self.norm2(src + self.linear2(F.relu(self.linear1(src))))


class DecoderLayer(nn.Module):
    """Query self-attention -> text cross-attention -> deformable image
    cross-attention -> FFN."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        d, h = config.d_model, config.num_heads
        self.cross_attn = MSDeformAttn(config)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.ca_text = MultiheadAttention(d, h)
        self.catext_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = MultiheadAttention(d, h)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, config.ffn_dim)
        self.linear2 = nn.Linear(config.ffn_dim, d)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, tgt, query_pos, ref_points, memory, spatial_shapes,
                txt, txt_mask):
        q = tgt + query_pos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        tgt = self.catext_norm(tgt + self.ca_text(
            tgt + query_pos, txt, txt, txt_mask[:, None, :]))
        tgt = self.norm1(tgt + self.cross_attn(
            tgt + query_pos, ref_points, memory, spatial_shapes))
        return self.norm3(tgt + self.linear2(F.relu(self.linear1(tgt))))


def _grid(h: int, w: int, device):
    yy, xx = torch.meshgrid(
        (torch.arange(h, device=device, dtype=torch.float32) + 0.5) / h,
        (torch.arange(w, device=device, dtype=torch.float32) + 0.5) / w,
        indexing="ij")
    return torch.stack([xx, yy], -1).reshape(h * w, 2)


def _image_pos_embed(spatial_shapes, d_model: int,
                     temperature: float = 20.0, device=None):
    """Per-level sine position embeddings [S_total, d_model]: the
    published PositionEmbeddingSineHW with normalize=True ((i + 1) / (H +
    1e-6), scale 2 pi), the y block first."""
    per = d_model // 2
    parts = []
    for (h, w) in spatial_shapes:
        yy = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / (
            h + 1e-6)
        xx = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / (
            w + 1e-6)
        ey = _sine_embed(yy, per, temperature)[:, None, :].expand(h, w, per)
        ex = _sine_embed(xx, per, temperature)[None, :, :].expand(h, w, per)
        parts.append(torch.cat([ey, ex], -1).reshape(h * w, d_model))
    return torch.cat(parts, dim=0)


def _encoder_ref_points(spatial_shapes, device=None):
    """Per-pixel normalized (cx, cy) reference points [S_total, 2]."""
    return torch.cat([_grid(h, w, device) for (h, w) in spatial_shapes])


def _output_proposals(spatial_shapes, device=None):
    """Two-stage proposal anchors (gen_encoder_output_proposals): grid
    centres, wh = 0.05 * 2^level. Returns (proposals [S_total, 4] in
    inverse-sigmoid space with +inf on invalid rows, valid [S_total]): a
    proposal is valid iff all its coordinates lie in (0.01, 0.99)."""
    props = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        wh = torch.full((h * w, 2), 0.05 * 2 ** lvl, device=device)
        props.append(torch.cat([_grid(h, w, device), wh], -1))
    raw = torch.cat(props, dim=0)
    valid = ((raw > 0.01) & (raw < 0.99)).all(dim=-1)
    unsig = torch.log(raw / (1.0 - raw))
    return torch.where(valid[:, None], unsig,
                       unsig.new_tensor(float("inf"))), valid


class GroundingDinoModel(nn.Module):
    """forward(image [B, 3, H, W] normalized, input_ids, txt_mask) ->
    (pred_logits [B, Q, max_text_len], pred_boxes [B, Q, 4] cxcywh)."""

    def __init__(self, config: GroundingDinoConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.d_model
        sw = cfg.swin
        self.backbone = nn.ModuleList([SwinTransformer(sw)])
        self.bert = BertModel(cfg.bert)
        self.feat_map = nn.Linear(cfg.bert.hidden_size, d)
        groups = min(32, d)
        projs = [nn.Sequential(nn.Conv2d(sw.stage_dim(i), d, 1),
                               nn.GroupNorm(groups, d, eps=LN_EPS))
                 for i in sorted(sw.out_indices)]
        projs.append(nn.Sequential(
            nn.Conv2d(sw.stage_dim(max(sw.out_indices)), d, 3, stride=2,
                      padding=1), nn.GroupNorm(groups, d, eps=LN_EPS)))
        self.input_proj = nn.ModuleList(projs)
        tr = nn.Module()
        tr.level_embed = nn.Parameter(torch.zeros(cfg.num_levels, d))
        tr.tgt_embed = nn.Embedding(cfg.num_queries, d)
        tr.encoder = nn.Module()
        tr.encoder.layers = nn.ModuleList(
            [DeformableEncoderLayer(cfg) for _ in range(cfg.enc_layers)])
        tr.encoder.text_layers = nn.ModuleList(
            [TextSelfAttnLayer(cfg) for _ in range(cfg.enc_layers)])
        tr.encoder.fusion_layers = nn.ModuleList(
            [BiAttention(cfg) for _ in range(cfg.enc_layers)])
        tr.decoder = nn.Module()
        tr.decoder.layers = nn.ModuleList(
            [DecoderLayer(cfg) for _ in range(cfg.dec_layers)])
        tr.decoder.bbox_embed = nn.ModuleList(
            [MLP(d, d, 4, 3) for _ in range(cfg.dec_layers)])
        tr.decoder.ref_point_head = MLP(2 * d, d, d, 2)
        tr.decoder.norm = nn.LayerNorm(d, eps=LN_EPS)
        tr.enc_output = nn.Linear(d, d)
        tr.enc_output_norm = nn.LayerNorm(d, eps=LN_EPS)
        tr.enc_out_bbox_embed = MLP(d, d, 4, 3)
        self.transformer = tr
        # the release's top-level alias: the same modules
        self.bbox_embed = tr.decoder.bbox_embed

    def forward(self, image, input_ids, txt_mask, return_topk: bool = False):
        """With `return_topk`, also the selected proposal indices [B, Q]."""
        cfg = self.config
        tr = self.transformer
        dev = image.device
        b = image.shape[0]
        d = cfg.d_model

        # ---- towers
        feats = self.backbone[0](image)
        levels = [feats[i] for i in sorted(feats)]
        xs = [proj(f) for proj, f in zip(self.input_proj, levels)]
        xs.append(self.input_proj[len(levels)](levels[-1]))
        spatial_shapes = [tuple(x.shape[2:]) for x in xs]
        src = torch.cat([x.flatten(2).transpose(1, 2) for x in xs], dim=1)

        # per-phrase block masks and fresh position ids feed both the BERT
        # tower and the enhancer's text layers
        text_self_mask, position_ids = build_text_token_masks(
            input_ids, txt_mask, cfg.special_token_ids)
        hidden, _ = self.bert(input_ids, text_self_mask,
                              position_ids=position_ids)
        txt = self.feat_map(hidden)
        st = txt.shape[1]

        # ---- feature enhancer
        pos = _image_pos_embed(spatial_shapes, d, cfg.pe_temperature, dev)
        lvl_pos = torch.cat([tr.level_embed[i].expand(h * w, d)
                             for i, (h, w) in enumerate(spatial_shapes)])
        pos = (pos + lvl_pos)[None]
        ref_enc = _encoder_ref_points(spatial_shapes, dev)[None]
        # the published get_sine_pos_embed takes the RAW integer
        # per-phrase position ids
        pos_text = _sine_embed(position_ids.float(), d)
        enc = tr.encoder
        for i in range(cfg.enc_layers):
            src, txt = enc.fusion_layers[i](src, txt, txt_mask)
            txt = enc.text_layers[i](txt, text_self_mask, pos_text)
            src = enc.layers[i](src, pos, ref_enc, spatial_shapes)

        # ---- language-guided query selection (two stage); the memory is
        # zeroed at invalid proposal rows before the projection
        proposals, prop_valid = _output_proposals(spatial_shapes, dev)
        memory = tr.enc_output_norm(tr.enc_output(
            torch.where(prop_valid[None, :, None], src, src.new_zeros(()))))
        txt_masked = torch.where(txt_mask[..., None], txt, txt.new_zeros(()))
        enc_logits = torch.einsum("bsd,btd->bst", memory, txt_masked)
        enc_scores = torch.where(txt_mask[:, None, :], enc_logits,
                                 enc_logits.new_tensor(-float("inf"))
                                 ).amax(dim=-1)
        topk = select_topk(enc_scores, cfg.num_queries)
        enc_boxes = tr.enc_out_bbox_embed(memory) + proposals[None]
        ref = torch.sigmoid(torch.gather(
            enc_boxes, 1, topk[..., None].expand(-1, -1, 4)))

        # ---- cross-modality decoder with iterative box refinement: the
        # RUNNING chain refines on the raw layer output, the REPORTED boxes
        # on the decoder-normed output, both against the reference points
        # going into the layer
        dec = tr.decoder
        tgt = tr.tgt_embed.weight[None].expand(b, -1, -1)
        boxes_out = None
        for i in range(cfg.dec_layers):
            query_pos = dec.ref_point_head(_box_sine_embed(ref, d))
            tgt = dec.layers[i](tgt, query_pos, ref, src, spatial_shapes,
                                txt, txt_mask)
            ref_unsig = _inverse_sigmoid(ref)
            boxes_out = torch.sigmoid(dec.bbox_embed[i](dec.norm(tgt))
                                      + ref_unsig)
            ref = torch.sigmoid(dec.bbox_embed[i](tgt) + ref_unsig)

        logits = torch.einsum("bqd,btd->bqt", dec.norm(tgt), txt_masked)
        logits = torch.where(txt_mask[:, None, :], logits,
                             logits.new_tensor(-float("inf")))
        if cfg.max_text_len > st:
            logits = F.pad(logits, (0, cfg.max_text_len - st),
                           value=-float("inf"))
        logits = logits[:, :, :cfg.max_text_len]
        return (logits, boxes_out, topk) if return_topk else (logits,
                                                              boxes_out)


@torch.no_grad()
def seeded_init_gdino_(model: GroundingDinoModel,
                       generator: torch.Generator) -> GroundingDinoModel:
    """Seeded random weights as flax initializes the JAX model: LeCun
    truncated-normal kernels (the packed attention projections too), zero
    biases, unit norm scales; normal(0.02) BERT embeddings and Swin bias
    tables, normal(1) level and query embeddings, layer scales 1e-4."""
    from diffusionhandles_tpu_torch.diffuser import seeded_init_
    seeded_init_(model, generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "in_proj_bias":
            p.zero_()
        elif leaf in ("gamma_v", "gamma_l"):
            p.fill_(1e-4)
        elif leaf in ("level_embed",) or name.startswith(
                "transformer.tgt_embed"):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device))
        elif (name.startswith("bert.embeddings.") and "LayerNorm" not in name
              ) or leaf == "relative_position_bias_table":
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
    return model


# ImageNet statistics (GroundingDINO's input normalization)
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class GroundingDinoGrounder:
    """Text -> boxes (the grounding stage of LangSAM, reference:
    test/estimate_foreground.py:37-39) on `device` (default: the GPU): a
    square resize to `input_size`, ImageNet normalization, the WordPiece
    caption, phrase scores = sigmoid of the max contrastive logit over the
    caption's tokens. `params` is a GroundingDinoModel state dict (release
    names; models/weights_gdino.py makes one from the JAX package's params
    or a released file), else `checkpoint_path`, else seeded random."""

    def __init__(self, config: Optional[GroundingDinoConfig] = None,
                 params=None, checkpoint_path: Optional[str] = None,
                 vocab_path: Optional[str] = None, input_size: int = 512,
                 box_threshold: float = 0.35, seed: int = 0, device=None):
        self.config = config or GroundingDinoConfig()
        self.device = resolve_device(device)
        self.input_size = input_size
        self.box_threshold = box_threshold
        self.tokenizer = WordPieceTokenizer(vocab_path,
                                            self.config.bert.vocab_size)
        with torch.device(self.device):
            self.model = GroundingDinoModel(self.config)
        if checkpoint_path is not None:
            from diffusionhandles_tpu_torch.models.weights_gdino import \
                load_gdino_checkpoint
            params = load_gdino_checkpoint(checkpoint_path, self.config)
        if params is None:
            seeded_init_gdino_(self.model, torch.Generator(
                device=self.device).manual_seed(seed))
        else:
            self.model.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    def inputs(self, img: np.ndarray, caption: str):
        """(image [1, 3, S, S] normalized, ids [1, L], mask [1, L]) on the
        device, as predict_boxes feeds the model."""
        s = self.input_size
        x = torch.as_tensor(np.ascontiguousarray(img, np.float32),
                            device=self.device)
        x = resize_nchw(x, (s, s), "bilinear")
        mean = torch.tensor(_IMAGENET_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(_IMAGENET_STD, device=x.device)[:, None, None]
        cap = caption.strip().lower()
        if not cap.endswith("."):
            cap = cap + "."
        ids, mask = self.tokenizer([cap], max_length=min(
            64, self.config.max_text_len))
        return ((x - mean) / std,
                torch.as_tensor(ids, dtype=torch.long, device=self.device),
                torch.as_tensor(mask, device=self.device))

    @torch.no_grad()
    def predict_boxes(self, img: np.ndarray, caption: str,
                      box_threshold: Optional[float] = None):
        """img [1, 3, H, W] in [0, 1] -> (boxes [N, 4] xyxy pixels,
        scores [N]), N >= 1 (the best box is always included)."""
        thr = self.box_threshold if box_threshold is None else box_threshold
        h, w = img.shape[-2:]
        x, ids, mask = self.inputs(img, caption)
        logits, boxes = self.model(x, ids, mask)
        valid = mask[0].cpu().numpy()
        lg = logits[0].cpu().numpy()[:, :valid.shape[0]]
        lg = np.where(valid[None, :], lg, -np.inf)
        scores = 1.0 / (1.0 + np.exp(-lg.max(axis=-1)))     # [Q]
        bx = boxes[0].cpu().numpy()                          # cxcywh [0, 1]
        xyxy = np.stack([
            (bx[:, 0] - bx[:, 2] / 2) * w, (bx[:, 1] - bx[:, 3] / 2) * h,
            (bx[:, 0] + bx[:, 2] / 2) * w, (bx[:, 1] + bx[:, 3] / 2) * h,
        ], axis=-1)
        keep = scores > thr
        if not keep.any():
            keep = scores == scores.max()
        order = np.argsort(-scores[keep])
        return xyxy[keep][order], scores[keep][order]

    def best_box(self, img: np.ndarray, caption: str) -> np.ndarray:
        boxes, _ = self.predict_boxes(img, caption)
        return boxes[0]
