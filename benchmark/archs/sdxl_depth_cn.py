"""The SDXL family with the depth ControlNet: SDXL base 1.0's U-Net with
four input channels, two text towers whose penultimate states are
concatenated, the pooled text vector and the size ids as added conditions,
and a ControlNet that takes the depth as a control image at image
resolution and adds its residuals to the U-Net's skip connections and mid
block; the VAE. Builds the measured program (`DiffusionHandles` with
`model_paths.model_name` SDXL base 1.0's), the tap at its denoiser (the
ControlNet and U-Net called as one) and the plain reference
(`reference/sdxl.py`), on the same weight tensors.

A configuration of this family (`"arch": "sdxl_depth_cn"`) holds the
published widths under "unet", "controlnet", "vae", "text_encoder" and
"text_encoder_2" (diffusers' and transformers' key names), the
conditioning scale under "controlnet_conditioning_scale", the guided
diffuser's settings under "guided_diffuser" and the depth transform's
mode.

The check reads this family through the SD-2 comparisons of `check.py`,
which call a reference denoiser as `unet(x, t, context)` with x the
latents and the depth input concatenated on the latent grid and three
recorded stacks. `RefDenoiser` keeps that call: the control image enters
as its 8x8 pixel blocks folded into channels (`F.pixel_unshuffle`, exact),
the pooled vector as one more token of the context, and the recorded
stacks as three slots: SDXL records two, which the guidance schedule
weighs with its last two layer weights (`diffuser.guidance_energy`); its
first weight is zero at every step, so the first slot repeats the second
at weight zero. `ControlEditCheck` gives the program's recordings the
same three slots and the reference the control image in place of the
depth channel.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from benchmark import check
from benchmark.reference.pipeline import RefDDIMSchedule, hash_token_ids
from benchmark.reference.sd import RefVAE, RefVAEConfig
from benchmark.reference.sdxl import (OracleControlNet, OracleXLTower,
                                      OracleXLUNet, XLCLIPConfig,
                                      XLUNetConfig)
from benchmark.tap import UNetTap

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}
FAMILY = "stabilityai/stable-diffusion-xl-base-1.0"  # the program's name


def image_res(cfg: dict) -> int:
    """The image's side in pixels."""
    n = len(cfg["vae"]["block_out_channels"])
    return cfg["unet"]["sample_size"] * 2 ** (n - 1)


def _net_fields(cfg: dict, key: str) -> dict:
    """The port's UNetConfig fields of the U-Net ("unet") or of the
    ControlNet ("controlnet")."""
    u = cfg[key]
    out = dict(in_channels=u["in_channels"],
               block_out_channels=tuple(u["block_out_channels"]),
               down_block_types=tuple(u["down_block_types"]),
               layers_per_block=u["layers_per_block"],
               num_heads=tuple(u["attention_head_dim"]),
               cross_attention_dim=u["cross_attention_dim"],
               norm_num_groups=u["norm_num_groups"],
               transformer_layers_per_block=tuple(
                   u["transformer_layers_per_block"]),
               addition_embed_type=u["addition_embed_type"],
               addition_time_embed_dim=u["addition_time_embed_dim"],
               projection_class_embeddings_input_dim=u[
                   "projection_class_embeddings_input_dim"])
    if key == "unet":
        out.update(sample_size=u["sample_size"],
                   out_channels=u["out_channels"],
                   up_block_types=tuple(u["up_block_types"]))
    return out


def _vae_fields(cfg: dict) -> dict:
    v = cfg["vae"]
    return dict(in_channels=v["in_channels"], out_channels=v["out_channels"],
                latent_channels=v["latent_channels"],
                block_out_channels=tuple(v["block_out_channels"]),
                layers_per_block=v["layers_per_block"],
                norm_num_groups=v["norm_num_groups"])


def _tower_fields(cfg: dict, key: str) -> dict:
    c = cfg[key]
    return dict(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                intermediate_size=c["intermediate_size"],
                num_heads=c["num_attention_heads"],
                num_layers=c["num_hidden_layers"],
                max_position_embeddings=c["max_position_embeddings"],
                hidden_act=c["hidden_act"],
                projection_dim=c.get("projection_dim") if key.endswith("_2")
                else None)


def handles_config(cfg: dict):
    """The program's DiffusionHandlesConfig for this configuration."""
    from diffusionhandles_tpu_torch.config import config_from_dict
    return config_from_dict({
        "guided_diffuser": dict(cfg["guided_diffuser"]),
        "depth_transform_mode": cfg["depth_transform_mode"],
        "model_paths": {"model_name": FAMILY}})


def program_modules(cfg: dict):
    """The program's U-Net, ControlNet, VAE and two text towers, built on
    the meta device with this configuration's widths and precisions (the
    towers in float32)."""
    from diffusionhandles_tpu_torch.models.clip_text import (
        CLIPTextConfig, CLIPTextModel, CLIPTextModelWithProjection)
    from diffusionhandles_tpu_torch.models.controlnet import (
        ControlNetConfig, ControlNetModel)
    from diffusionhandles_tpu_torch.models.unet import (UNet2DConditionModel,
                                                        UNetConfig)
    from diffusionhandles_tpu_torch.models.vae import (AutoencoderKL,
                                                       VAEConfig)
    gd = handles_config(cfg).guided_diffuser
    common = dict(dtype=DTYPES[gd.dtype], param_dtype=DTYPES[gd.param_dtype],
                  remat=gd.remat_guidance, flash_attention=gd.flash_attention,
                  **cfg["route"])
    ucfg = UNetConfig(**_net_fields(cfg, "unet"), **common)
    cn_ucfg = UNetConfig(**_net_fields(cfg, "controlnet"), **common)
    c = cfg["controlnet"]
    cncfg = ControlNetConfig(
        conditioning_channels=c["conditioning_channels"],
        conditioning_embedding_out_channels=tuple(
            c["conditioning_embedding_out_channels"]),
        conditioning_scale=cfg["controlnet_conditioning_scale"])
    vcfg = VAEConfig(**_vae_fields(cfg), dtype=common["dtype"],
                     param_dtype=common["param_dtype"],
                     scaling_factor=cfg["vae"]["scaling_factor"])
    c1 = CLIPTextConfig(**_tower_fields(cfg, "text_encoder"),
                        penultimate=True)
    c2 = CLIPTextConfig(**_tower_fields(cfg, "text_encoder_2"),
                        penultimate=True)
    with torch.device("meta"):
        mods = {"unet": UNet2DConditionModel(ucfg),
                "controlnet": ControlNetModel(cn_ucfg, cncfg),
                "vae": AutoencoderKL(vcfg),
                "text_encoder": CLIPTextModel(c1),
                "text_encoder_2": CLIPTextModelWithProjection(c2)}
    return mods, (ucfg, vcfg, c1, c2)


def program_handles(cfg: dict, weights: Dict[str, dict], device):
    """The program's DiffusionHandles on `device`, holding `weights`."""
    from diffusionhandles_tpu_torch.diffuser import SDModels
    from diffusionhandles_tpu_torch.models.tokenizer import load_tokenizer
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
    mods, (ucfg, vcfg, c1, c2) = program_modules(cfg)
    for name, mod in mods.items():
        mod.load_state_dict(weights[name], strict=True, assign=True)
        mod.eval().requires_grad_(False)
    tok = load_tokenizer(None, max_length=c1.max_position_embeddings,
                         vocab_size=c1.vocab_size)
    models = SDModels(mods["unet"], mods["vae"], mods["text_encoder"], tok,
                      ucfg, vcfg, c1, controlnet=mods["controlnet"],
                      text_encoder_2=mods["text_encoder_2"], clip2_config=c2)
    return DiffusionHandles(handles_config(cfg), device=device,
                            models=models)


def warmup_handles(cfg: dict, handles, steps: int = 2):
    """A DiffusionHandles on `handles`' own models whose loops take
    `steps` steps, guidance in the first alone."""
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
    short = json.loads(json.dumps(cfg))
    gd = short["guided_diffuser"]
    gd["num_timesteps"] = steps
    gd["guidance_max_step"] = min(gd["guidance_max_step"], 1)
    return DiffusionHandles(handles_config(short), device=handles.device,
                            models=handles.diffuser.models)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def _ref_unet_config(cfg: dict, key: str) -> XLUNetConfig:
    f = _net_fields(cfg, key)
    u = cfg["unet"]
    return XLUNetConfig(
        sample_size=u["sample_size"], in_channels=f["in_channels"],
        out_channels=u["out_channels"],
        block_out_channels=f["block_out_channels"],
        down_block_types=f["down_block_types"],
        up_block_types=tuple(u["up_block_types"]),
        layers_per_block=f["layers_per_block"], num_heads=f["num_heads"],
        cross_attention_dim=f["cross_attention_dim"],
        norm_num_groups=f["norm_num_groups"],
        transformer_layers_per_block=f["transformer_layers_per_block"],
        addition_time_embed_dim=f["addition_time_embed_dim"],
        projection_class_embeddings_input_dim=f[
            "projection_class_embeddings_input_dim"])


class RefDenoiser(nn.Module):
    """The reference's denoiser call in check.py's form: x [B, 4 + 3 *
    f * f, h, w] (the latents, then the control image's f x f pixel
    blocks folded into channels), a timestep, a context [B, 78, D] (the
    text's 77 tokens, then the pooled vector in the first P entries of one
    more) -> (eps, three activation slots: the first recorded stack
    twice, then the second)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.unet = OracleXLUNet(_ref_unet_config(cfg, "unet"))
        c = cfg["controlnet"]
        self.controlnet = OracleControlNet(
            _ref_unet_config(cfg, "controlnet"),
            tuple(c["conditioning_embedding_out_channels"]),
            cfg["controlnet_conditioning_scale"])
        self.latent_channels = cfg["unet"]["out_channels"]
        self.fold = image_res(cfg) // cfg["unet"]["sample_size"]
        self.pooled_dim = cfg["text_encoder_2"]["projection_dim"]
        r = float(image_res(cfg))
        self.size_ids = (r, r, 0.0, 0.0, r, r)

    def forward(self, x, t, context):
        lat = x[:, :self.latent_channels]
        control = F.pixel_shuffle(x[:, self.latent_channels:], self.fold)
        text = context[:, :-1]
        pooled = context[:, -1, :self.pooled_dim]
        ids = torch.tensor([self.size_ids], device=x.device,
                           dtype=x.dtype).expand(x.shape[0], -1)
        down, mid = self.controlnet(lat, t, text, control, pooled, ids)
        eps, acts = self.unet(lat, t, text, pooled, ids, down, mid)
        return eps, [acts[0]] + list(acts)


def pack_control(disparity: torch.Tensor, fold: int) -> torch.Tensor:
    """The control image of a disparity [B, 1, H, W] (normalised to [0, 1]
    per image, three channels; the ControlNet card's preparation), folded
    into channels on the latent grid: [B, 3 * fold * fold, H / fold, W /
    fold]."""
    d = disparity.float()
    lo = d.amin(dim=(1, 2, 3), keepdim=True)
    hi = d.amax(dim=(1, 2, 3), keepdim=True)
    img = ((d - lo) / (hi - lo)).expand(-1, 3, -1, -1)
    return F.pixel_unshuffle(img, fold)


def pack_context(text: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """[B, 77, D] and [B, P] -> [B, 78, D]: the pooled vector as one more
    token, padded with zeros."""
    tok = torch.zeros_like(text[:, :1])
    tok[:, 0, :pooled.shape[-1]] = pooled
    return torch.cat([text, tok], dim=1)


@dataclasses.dataclass
class Reference:
    """The reference's denoiser and VAE, and the VAE's latent scale."""

    unet: RefDenoiser
    vae: RefVAE
    scaling: float


def reference_models(cfg: dict, weights: Dict[str, dict], device,
                     dtype=torch.float32) -> Reference:
    """The reference's denoiser (ControlNet and U-Net) and VAE on `device`
    in `dtype`, loaded (copied and cast) from the benchmark's weights."""
    with torch.device("meta"):
        den = RefDenoiser(cfg)
        vae = RefVAE(RefVAEConfig(**_vae_fields(cfg)))
    for mod, sd in ((den.unet, weights["unet"]),
                    (den.controlnet, weights["controlnet"]),
                    (vae, weights["vae"])):
        mod.to_empty(device=device).to(dtype)
        mod.load_state_dict(sd, strict=True)
    for mod in (den, vae):
        mod.eval().requires_grad_(False)
    return Reference(den, vae, cfg["vae"]["scaling_factor"])


def prompt_context(cfg: dict, weights: Dict[str, dict], prompt: str,
                   device) -> torch.Tensor:
    """The prompt through the reference's two towers, packed [1, 78, D]
    (`pack_context`), in float32."""
    towers = []
    for key in ("text_encoder", "text_encoder_2"):
        with torch.device("meta"):
            tower = OracleXLTower(XLCLIPConfig(**_tower_fields(cfg, key)))
        tower.to_empty(device=device).float()
        tower.load_state_dict(weights[key], strict=True)
        towers.append(tower.eval().requires_grad_(False))
    c = cfg["text_encoder"]
    ids = torch.tensor([hash_token_ids(prompt, c["vocab_size"],
                                       c["max_position_embeddings"])],
                       device=device)
    with torch.no_grad():
        ctx_l, _ = towers[0](ids)
        ctx_g, pooled = towers[1](ids)
    return pack_context(torch.cat([ctx_l, ctx_g], dim=-1), pooled)


def tap(cfg: dict) -> UNetTap:
    """The tap at `ControlNetDenoiser.__call__(sample, timesteps,
    encoder_hidden_states, control, text_embeds, time_ids)`: the latents
    are the whole sample, and a call records a graph when the sample or
    the text context requires grad."""
    from diffusionhandles_tpu_torch.models.controlnet import \
        ControlNetDenoiser
    names = ("sample", "timesteps", "encoder_hidden_states")

    def parse(args, kwargs):
        a = dict(zip(names, args), **kwargs)
        x = a["sample"]
        return x.detach(), a["timesteps"], (x, a["encoder_hidden_states"])
    return UNetTap(ControlNetDenoiser, parse)


def shared(cfg: dict, weights: Dict[str, dict], prompt: str,
           device) -> check.Shared:
    """The reference's models on `weights`, the prompt through its two
    towers (packed with its pooled vector), the unconditional row's zeros
    and the DDIM schedule."""
    ref = reference_models(cfg, weights, device)
    cond = prompt_context(cfg, weights, prompt, device)
    sched = RefDDIMSchedule(cfg["guided_diffuser"]["num_timesteps"])
    return check.Shared(cfg, ref, sched, cond, torch.zeros_like(cond),
                        torch.device(device))


# ---------------------------------------------------------------------------
# The check and the FLOPs
# ---------------------------------------------------------------------------

def _slots(acts):
    """Two recorded stacks as the reference's three slots."""
    return [acts[0]] + list(acts)


class ControlEditCheck(check.EditCheck):
    """check.EditCheck with the control image, folded into channels, in
    place of the depth channel, and the program's recorded stacks in the
    reference's three slots."""

    def __init__(self, sh, mix, photo, rec_inputs, rec_acts, rec_final,
                 transforms, calls, images, disparities, seed):
        self.fold = image_res(sh.cfg) // sh.latent_res
        super().__init__(sh, mix, photo, rec_inputs, _slots(rec_acts),
                         rec_final, transforms, calls, images, disparities,
                         seed)
        self.GA = [[None if a is None else _slots(a) for a in g]
                   for g in self.GA]
        self.depth64_orig = pack_control(
            check._disparity(photo["depth"]).to(sh.device), self.fold)

    def geometry(self, dtype):
        disp = super().geometry(dtype)
        self.depth64 = pack_control(disp, self.fold)
        return disp


@functools.lru_cache(maxsize=None)
def _meta_denoiser(cfg_json: str) -> RefDenoiser:
    with torch.device("meta"):
        den = RefDenoiser(json.loads(cfg_json)).requires_grad_(False)
    for m in den.modules():
        m.recompute = False  # count the model's FLOPs, not the recompute
    return den


@functools.lru_cache(maxsize=None)
def call_flops(cfg_json: str, batch: int, grad: str) -> float:
    """FLOPs of one denoiser call (ControlNet and U-Net) at `batch`, by
    `torch.utils.flop_counter` on the reference on the meta device. grad:
    "" (forward only) or "latents" (the guidance call: forward, then the
    gradient of the two recorded stacks to the latents, through both
    nets; none to the control image, the text or the weights)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = json.loads(cfg_json)
    den = _meta_denoiser(cfg_json)
    u = cfg["unet"]
    res, dev = u["sample_size"], torch.device("meta")
    full = image_res(cfg)
    with FlopCounterMode(display=False) as counter, torch.enable_grad():
        lat = torch.zeros(batch, u["out_channels"], res, res, device=dev,
                          requires_grad=grad == "latents")
        control = torch.zeros(batch, 3, full, full, device=dev)
        text = torch.zeros(batch, 77, u["cross_attention_dim"], device=dev)
        pooled = torch.zeros(batch, den.pooled_dim, device=dev)
        ids = torch.zeros(batch, 6, device=dev)
        t = torch.zeros((), dtype=torch.long, device=dev)
        down, mid = den.controlnet(lat, t, text, control, pooled, ids)
        _, acts = den.unet(lat, t, text, pooled, ids, down, mid)
        if grad == "latents":
            sum(a.sum() for a in acts).backward()
    return float(counter.get_total_flops())
