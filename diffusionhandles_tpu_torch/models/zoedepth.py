"""ZoeDepth-NK metric depth estimation.

The counterpart of the JAX package's `models/zoedepth.py` (reference:
test/estimate_depth.py:11-32 builds `zoedepth_nk` and calls
`model.infer(img)`):

* the MiDaS core (models/beit.py): relative depth and the feature list
  [out_conv, l4_rn, r4, r3, r2, r1];
* a patch-transformer router on the bottleneck (1x1-conv embedding, a zero
  class token, sinusoidal positions, a post-norm transformer encoder) and
  an MLP classifier over the two domains (N = nyu, K = kitti);
* per domain: softplus seed bins at the bottleneck, one inverse-attractor
  layer per decoder scale, and a conditional log-binomial over the final
  bin centres, conditioned on the 32-channel MiDaS output features;
* hard routing (the release's): the argmax domain's depth, each domain's
  clipped to its own range.

Module names are the isl-org/ZoeDepth release's (`core.core.*`,
`patch_transformer.*`, `mlp_classifier.*`, `seed_bin_regressors.{domain}`,
`projectors.{i}`, `attractors.{domain}.{i}`,
`conditional_log_binomial.{domain}`), so a released state dict loads
strictly (models/weights_zoedepth.py). fp32 throughout, NCHW.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusionhandles_tpu_torch.models.beit import (BEiTConfig, MidasDPT,
                                                    tiny_beit_config)
from diffusionhandles_tpu_torch.ops.resize import resize_nchw
from diffusionhandles_tpu_torch.utils.device import (deterministic_cudnn,
                                                     resolve_device)


@dataclasses.dataclass(frozen=True)
class BinConf:
    name: str
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0


@dataclasses.dataclass(frozen=True)
class ZoeDepthConfig:
    """zoedepth_nk defaults (isl-org/ZoeDepth zoedepth_nk config)."""

    backbone: BEiTConfig = dataclasses.field(default_factory=BEiTConfig)
    bin_confs: Tuple[BinConf, ...] = (
        BinConf("nyu", 64, 1e-3, 10.0),
        BinConf("kitti", 64, 1e-3, 80.0))
    bin_embedding_dim: int = 128
    bottleneck_features: int = 256
    n_attractors: Tuple[int, ...] = (16, 8, 4, 1)
    attractor_alpha: float = 1e-3
    attractor_gamma: int = 2
    patch_transformer_dim: int = 128
    patch_transformer_heads: int = 4
    patch_transformer_layers: int = 4
    patch_transformer_ff: int = 1024
    # soft routing mixes the domain heads by classifier probability; hard
    # routing (the release's) takes the argmax domain
    soft_routing: bool = False

    @property
    def min_depth(self) -> float:
        return min(bc.min_depth for bc in self.bin_confs)

    @property
    def max_depth(self) -> float:
        return max(bc.max_depth for bc in self.bin_confs)


def sinusoidal_positions(n: int, dim: int) -> np.ndarray:
    """ZoeDepth PatchTransformerEncoder positional encoding."""
    pos = np.arange(n, dtype=np.float32)[:, None]
    i = np.arange(dim // 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10000, 2 * i / dim)
    enc = np.zeros((n, dim), np.float32)
    enc[:, 0::2] = np.sin(angle)
    enc[:, 1::2] = np.cos(angle)
    return enc


def _up(x: torch.Tensor, size) -> torch.Tensor:
    return resize_nchw(x, tuple(size), "bilinear_ac")


class _SelfAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj,
    out_proj), computed as the JAX package's layer does."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.heads = heads

    def forward(self, x):
        b, s, d = x.shape
        hd = d // self.heads
        q, k, v = F.linear(x, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, s, self.heads, hd) for t in (q, k, v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        out = torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v)
        return self.out_proj(out.reshape(b, s, d))


class TransformerEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer semantics: post-norm, ReLU FF."""

    def __init__(self, dim: int, heads: int, ff_dim: int):
        super().__init__()
        self.self_attn = _SelfAttention(dim, heads)
        self.linear1 = nn.Linear(dim, ff_dim)
        self.linear2 = nn.Linear(ff_dim, dim)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x):
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(F.relu(self.linear1(x))))


class PatchTransformerEncoder(nn.Module):
    """1x1-conv patch embedding, a zero class token in front, sinusoidal
    positions, then the encoder layers: [B, C, h, w] -> [B, 1+h*w, D]."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        d = cfg.patch_transformer_dim
        self.embedding_convPxP = nn.Conv2d(cfg.bottleneck_features, d, 1)
        self.transformer_encoder = nn.Module()
        self.transformer_encoder.layers = nn.ModuleList([
            TransformerEncoderLayer(d, cfg.patch_transformer_heads,
                                    cfg.patch_transformer_ff)
            for _ in range(cfg.patch_transformer_layers)])

    def forward(self, x):
        tokens = self.embedding_convPxP(x).flatten(2).transpose(1, 2)
        tokens = F.pad(tokens, (0, 0, 1, 0))  # the class token
        pos = torch.from_numpy(sinusoidal_positions(
            tokens.shape[1], tokens.shape[2])).to(tokens.device)
        tokens = tokens + pos[None]
        for layer in self.transformer_encoder.layers:
            tokens = layer(tokens)
        return tokens


class ConvMLP(nn.Module):
    """Conv1x1 -> ReLU -> Conv1x1 (-> softplus) under the release's
    `_net` Sequential: the seed-bin regressor, projector and attractor
    block."""

    def __init__(self, in_ch: int, mid: int, out: int,
                 softplus: bool = False):
        super().__init__()
        mods = [nn.Conv2d(in_ch, mid, 1), nn.ReLU(), nn.Conv2d(mid, out, 1)]
        if softplus:
            mods.append(nn.Softplus())
        self._net = nn.Sequential(*mods)

    def forward(self, x):
        return self._net(x)


class ConditionalLogBinomial(nn.Module):
    """Per-pixel log-binomial distribution over n_bins classes, whose p and
    temperature come from a conv MLP on [features, bin embedding]."""

    def __init__(self, in_ch: int, mid: int, n_bins: int,
                 p_eps: float = 1e-4):
        super().__init__()
        self.mlp = nn.Sequential(nn.Conv2d(in_ch, mid, 1), nn.GELU(),
                                 nn.Conv2d(mid, 4, 1), nn.Softplus())
        self.n_bins, self.p_eps = n_bins, p_eps

    def forward(self, feats, condition):
        eps = self.p_eps
        h = self.mlp(torch.cat([feats, condition], dim=1))
        p = h[:, 0] / (h[:, 0] + h[:, 1] + eps)
        t = h[:, 2] / (h[:, 2] + h[:, 3] + eps)
        p = p.clamp(eps, 1.0 - eps)[:, None]
        t = t.clamp(eps, 1.0)[:, None]
        n = self.n_bins
        k = torch.arange(n, dtype=torch.float32,
                         device=feats.device)[None, :, None, None]
        nf = torch.tensor(float(n), device=feats.device)
        # log C(n-1, k) + k log p + (n-1-k) log(1-p), tempered softmax
        log_comb = torch.lgamma(nf) - torch.lgamma(k + 1.0) - torch.lgamma(
            nf - k)
        logits = log_comb + k * torch.log(p) + (n - 1 - k) * torch.log1p(-p)
        return (logits / t).softmax(dim=1)


class ZoeDepthNK(nn.Module):
    """[B, 3, S, S] ImageNet-normalized -> (metric depth [B, S, S], domain
    probabilities [B, n_domains], relative depth [B, S, S])."""

    def __init__(self, cfg: ZoeDepthConfig):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        fc, e = bb.fusion_channels, cfg.bin_embedding_dim
        self.core = nn.Module()
        self.core.core = MidasDPT(bb)
        self.conv2 = nn.Conv2d(fc, cfg.bottleneck_features, 1)
        self.patch_transformer = PatchTransformerEncoder(cfg)
        d = cfg.patch_transformer_dim
        self.mlp_classifier = nn.Sequential(
            nn.Linear(d, d), nn.ReLU(), nn.Linear(d, len(cfg.bin_confs)))
        self.seed_bin_regressors = nn.ModuleDict({
            bc.name: ConvMLP(cfg.bottleneck_features,
                             cfg.bottleneck_features, bc.n_bins,
                             softplus=True) for bc in cfg.bin_confs})
        self.seed_projector = ConvMLP(cfg.bottleneck_features, e, e)
        self.projectors = nn.ModuleList([ConvMLP(fc, e, e)
                                         for _ in cfg.n_attractors])
        self.attractors = nn.ModuleDict({
            bc.name: nn.ModuleList([ConvMLP(e, e, n, softplus=True)
                                    for n in cfg.n_attractors])
            for bc in cfg.bin_confs})
        self.conditional_log_binomial = nn.ModuleDict({
            bc.name: ConditionalLogBinomial(bb.midas_out_channels + e, e,
                                            bc.n_bins)
            for bc in cfg.bin_confs})

    def _attract(self, net, b_embedding, b_prev, prev_b_embedding):
        """Inverse attractor over unnormalized bin centres:
        b_new = b + mean_k (a_k - b) / (1 + alpha |a_k - b|^gamma)."""
        cfg = self.cfg
        size = b_embedding.shape[2:]
        b_embedding = b_embedding + _up(prev_b_embedding, size)
        attractors = net(b_embedding)                    # [B, K, h, w]
        b_prev = _up(b_prev, size)                       # [B, N, h, w]
        delta = attractors[:, :, None] - b_prev[:, None]  # [B, K, N, h, w]
        dx = delta / (1.0 + cfg.attractor_alpha
                      * delta.abs() ** cfg.attractor_gamma)
        return b_prev + dx.mean(dim=1), b_embedding

    def forward(self, x):
        cfg = self.cfg
        rel_depth, feats = self.core.core(x)
        out_feat, btlnck, *x_blocks = feats
        btlnck = self.conv2(btlnck)

        cls = self.patch_transformer(btlnck)[:, 0]
        domain_probs = self.mlp_classifier(cls).softmax(-1)

        depths = []
        for bc in cfg.bin_confs:
            b_prev = self.seed_bin_regressors[bc.name](btlnck)
            prev_emb = self.seed_projector(btlnck)
            for i, xb in enumerate(x_blocks):
                b_prev, prev_emb = self._attract(
                    self.attractors[bc.name][i], self.projectors[i](xb),
                    b_prev, prev_emb)
            size = out_feat.shape[2:]
            probs = self.conditional_log_binomial[bc.name](
                out_feat, _up(prev_emb, size))
            depth = (probs * _up(b_prev, size)).sum(dim=1)
            depths.append(depth.clamp(bc.min_depth, bc.max_depth))

        stacked = torch.stack(depths, dim=1)  # [B, D, S, S]
        if cfg.soft_routing:
            depth = torch.einsum("bdhw,bd->bhw", stacked, domain_probs)
        else:
            choice = domain_probs.argmax(-1)
            depth = stacked[torch.arange(x.shape[0], device=x.device),
                            choice]
        return depth, domain_probs, rel_depth


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


class ZoeDepthModel(nn.Module):
    """model.infer() of the release: [B, 3, H, W] in [0, 1] -> metric
    depth [B, H, W] at the input resolution (resize to the backbone's size,
    ImageNet normalization, the average with the horizontally flipped
    image's depth, resize back, clip). cuDNN runs its deterministic
    algorithms here, so that a depth map is the same bits each call."""

    def __init__(self, config: ZoeDepthConfig, flip_aug: bool = True):
        super().__init__()
        self.config = config
        self.flip_aug = flip_aug
        self.nk = ZoeDepthNK(config)

    def forward(self, img, return_domain: bool = False):
        """With `return_domain`, also the domain probabilities [2B or B,
        D] of the passes (the flipped images' after the originals')."""
        with deterministic_cudnn():
            return self._infer(img, return_domain)

    def _infer(self, img, return_domain: bool):
        cfg = self.config
        size = cfg.backbone.image_size
        x = resize_nchw(img.float(), (size, size), "bilinear_ac")
        mean = torch.tensor(_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(_STD, device=x.device)[:, None, None]
        x = (x - mean) / std
        b = img.shape[0]
        if self.flip_aug:
            d, probs, _ = self.nk(torch.cat([x, x.flip(3)], dim=0))
            depth = 0.5 * (d[:b] + d[b:].flip(2))
        else:
            depth, probs, _ = self.nk(x)
        depth = resize_nchw(depth[:, None], tuple(img.shape[2:]),
                            "bilinear_ac")[:, 0]
        depth = depth.clamp(cfg.min_depth, cfg.max_depth)
        return (depth, probs) if return_domain else depth


@torch.no_grad()
def seeded_init_zoedepth_(model: nn.Module,
                          generator: torch.Generator) -> nn.Module:
    """Seeded random weights as flax initializes the JAX model: LeCun
    truncated-normal kernels, zero biases, unit norm scales, zero class
    token, q/v biases and relative-position tables, unit layer scales."""
    from diffusionhandles_tpu_torch.diffuser import seeded_init_
    seeded_init_(model, generator)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("cls_token", "q_bias", "v_bias", "in_proj_bias",
                    "relative_position_bias_table"):
            p.zero_()
        elif leaf in ("gamma_1", "gamma_2"):
            p.fill_(1.0)
    return model


class DepthEstimator:
    """Service-level interface (the reference's depth-estimator service
    contract, webapp/webapps/depth_estimator_webapp.py)."""

    def estimate_depth(self, img: np.ndarray) -> np.ndarray:
        """img [1, 3, H, W] in [0, 1] -> depth [1, 1, H, W] (metric)."""
        raise NotImplementedError


class ZoeDepthEstimator(DepthEstimator):
    """ZoeDepth-NK on `device` (default: the GPU): weights from `params`
    (a release-named state dict), else from `checkpoint_path` (a release
    .pt), else seeded random. fp32; on the card it does not turn TF32 on
    (set torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False to keep every product
    fp32)."""

    def __init__(self, config: Optional[ZoeDepthConfig] = None, params=None,
                 seed: int = 0, checkpoint_path: Optional[str] = None,
                 device=None):
        self.config = config or ZoeDepthConfig()
        self.device = resolve_device(device)
        with torch.device(self.device):
            self.model = ZoeDepthModel(self.config)
        if params is None and checkpoint_path is not None:
            from diffusionhandles_tpu_torch.models.weights_zoedepth import \
                load_zoedepth_checkpoint
            params = load_zoedepth_checkpoint(checkpoint_path, self.config)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            seeded_init_zoedepth_(self.model, gen)
        else:
            self.model.nk.load_state_dict(params, strict=True)
        self.model.eval().requires_grad_(False)

    @torch.no_grad()
    def estimate_depth(self, img: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.ascontiguousarray(img, np.float32),
                            device=self.device)
        return self.model(x)[:, None].cpu().numpy()


def tiny_zoedepth_config(**overrides) -> ZoeDepthConfig:
    base = dict(
        backbone=tiny_beit_config(),
        bin_confs=(BinConf("nyu", 8, 1e-3, 10.0),
                   BinConf("kitti", 8, 1e-3, 80.0)),
        bin_embedding_dim=16,
        bottleneck_features=16,
        n_attractors=(4, 2, 2, 1),
        patch_transformer_dim=16,
        patch_transformer_heads=2,
        patch_transformer_layers=2,
        patch_transformer_ff=32,
    )
    base.update(overrides)
    return ZoeDepthConfig(**base)
