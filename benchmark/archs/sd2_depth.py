"""The SD-2-depth family: `UNet2DConditionModel` with the depth as a fifth
input channel, one text tower, no added conditioning; the VAE and the
OpenCLIP-H text encoder. Builds the measured program, the tap at its U-Net
and the plain reference, on the same weight tensors.

A configuration of this family (`"arch": "sd2_depth"`) holds the published
widths under "unet", "vae" and "text_encoder" (diffusers' and
transformers' key names), the U-Net route switches under "route", the
guided diffuser's settings under "guided_diffuser" and the depth
transform's mode. The harness reaches the family only through
`program_modules`, `program_handles`, `image_res`, `tap` and `shared`; the
entries and the control also use `warmup_handles` and `reference_models`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import torch

from benchmark import check
from benchmark.reference.pipeline import RefDDIMSchedule, hash_token_ids
from benchmark.reference.sd import (RefCLIPConfig, RefCLIPText, RefUNet,
                                    RefUNetConfig, RefVAE, RefVAEConfig)
from benchmark.tap import UNetTap

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def image_res(cfg: dict) -> int:
    """The image's side in pixels."""
    n = len(cfg["vae"]["block_out_channels"])
    return cfg["unet"]["sample_size"] * 2 ** (n - 1)


def _unet_fields(cfg: dict) -> dict:
    u = cfg["unet"]
    return dict(sample_size=u["sample_size"], in_channels=u["in_channels"],
                out_channels=u["out_channels"],
                block_out_channels=tuple(u["block_out_channels"]),
                down_block_types=tuple(u["down_block_types"]),
                up_block_types=tuple(u["up_block_types"]),
                layers_per_block=u["layers_per_block"],
                num_heads=tuple(u["attention_head_dim"]),
                cross_attention_dim=u["cross_attention_dim"],
                norm_num_groups=u["norm_num_groups"])


def _vae_fields(cfg: dict) -> dict:
    v = cfg["vae"]
    return dict(in_channels=v["in_channels"], out_channels=v["out_channels"],
                latent_channels=v["latent_channels"],
                block_out_channels=tuple(v["block_out_channels"]),
                layers_per_block=v["layers_per_block"],
                norm_num_groups=v["norm_num_groups"])


def _clip_fields(cfg: dict) -> dict:
    c = cfg["text_encoder"]
    return dict(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                intermediate_size=c["intermediate_size"],
                num_heads=c["num_attention_heads"],
                num_layers=c["num_hidden_layers"],
                max_position_embeddings=c["max_position_embeddings"])


def handles_config(cfg: dict):
    """The program's DiffusionHandlesConfig for this configuration."""
    from diffusionhandles_tpu_torch.config import config_from_dict
    return config_from_dict({
        "guided_diffuser": dict(cfg["guided_diffuser"]),
        "depth_transform_mode": cfg["depth_transform_mode"]})


def program_modules(cfg: dict):
    """The program's U-Net, VAE and text encoder, built on the meta device
    with this configuration's widths, precisions and route switches."""
    from diffusionhandles_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                             CLIPTextModel)
    from diffusionhandles_tpu_torch.models.unet import (UNet2DConditionModel,
                                                        UNetConfig)
    from diffusionhandles_tpu_torch.models.vae import (AutoencoderKL,
                                                       VAEConfig)
    gd = handles_config(cfg).guided_diffuser
    dtype, param_dtype = DTYPES[gd.dtype], DTYPES[gd.param_dtype]
    ucfg = UNetConfig(**_unet_fields(cfg), dtype=dtype,
                      param_dtype=param_dtype, remat=gd.remat_guidance,
                      flash_attention=gd.flash_attention, **cfg["route"])
    vcfg = VAEConfig(**_vae_fields(cfg), dtype=dtype,
                     param_dtype=param_dtype,
                     scaling_factor=cfg["vae"]["scaling_factor"])
    c = _clip_fields(cfg)
    ccfg = CLIPTextConfig(vocab_size=c["vocab_size"],
                          hidden_size=c["hidden_size"],
                          intermediate_size=c["intermediate_size"],
                          num_heads=c["num_heads"],
                          num_layers=c["num_layers"],
                          max_position_embeddings=c[
                              "max_position_embeddings"])
    with torch.device("meta"):
        mods = {"unet": UNet2DConditionModel(ucfg), "vae": AutoencoderKL(vcfg),
                "text_encoder": CLIPTextModel(ccfg)}
    return mods, (ucfg, vcfg, ccfg)


def program_handles(cfg: dict, weights: Dict[str, dict], device):
    """The program's DiffusionHandles on `device`, holding `weights`."""
    from diffusionhandles_tpu_torch.diffuser import SDModels
    from diffusionhandles_tpu_torch.models.tokenizer import load_tokenizer
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
    mods, (ucfg, vcfg, ccfg) = program_modules(cfg)
    for name, mod in mods.items():
        mod.load_state_dict(weights[name], strict=True, assign=True)
        mod.eval().requires_grad_(False)
    tok = load_tokenizer(None, max_length=ccfg.max_position_embeddings,
                         vocab_size=ccfg.vocab_size)
    models = SDModels(mods["unet"], mods["vae"], mods["text_encoder"], tok,
                      ucfg, vcfg, ccfg)
    return DiffusionHandles(handles_config(cfg), device=device,
                            models=models)


def warmup_handles(cfg: dict, handles, steps: int = 2):
    """A DiffusionHandles on `handles`' own models whose loops take
    `steps` steps, guidance in the first alone: it runs every shape of a
    full request in a fraction of its time."""
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
    short = json.loads(json.dumps(cfg))
    gd = short["guided_diffuser"]
    gd["num_timesteps"] = steps
    gd["guidance_max_step"] = min(gd["guidance_max_step"], 1)
    return DiffusionHandles(handles_config(short), device=handles.device,
                            models=handles.diffuser.models)


@dataclasses.dataclass
class Reference:
    """The plain reference's models, and the VAE's latent scale."""

    unet: RefUNet
    vae: RefVAE
    clip: RefCLIPText
    scaling: float


def reference_models(cfg: dict, weights: Dict[str, dict], device,
                     dtype=torch.float32) -> Reference:
    """The reference's U-Net, VAE and text encoder on `device` in `dtype`,
    loaded (copied and cast) from the benchmark's weights."""
    with torch.device("meta"):
        unet = RefUNet(RefUNetConfig(**_unet_fields(cfg)))
        vae = RefVAE(RefVAEConfig(**_vae_fields(cfg)))
        clip = RefCLIPText(RefCLIPConfig(**_clip_fields(cfg)))
    text = {k[len("text_model."):]: v
            for k, v in weights["text_encoder"].items()}
    for mod, sd in ((unet, weights["unet"]), (vae, weights["vae"]),
                    (clip, text)):
        mod.to_empty(device=device).to(dtype)
        mod.load_state_dict(sd, strict=True)
        mod.eval().requires_grad_(False)
    return Reference(unet, vae, clip, cfg["vae"]["scaling_factor"])


def tap(cfg: dict) -> UNetTap:
    """The tap at `UNet2DConditionModel.__call__(sample, timestep,
    encoder_hidden_states)`: the latents are the first `out_channels`
    channels of the sample (the rest is the depth), and a call records a
    graph when the sample or the text context requires grad."""
    from diffusionhandles_tpu_torch.models.unet import UNet2DConditionModel
    channels = cfg["unet"]["out_channels"]

    def parse(args, kwargs):
        x = args[0] if args else kwargs["sample"]
        ctx = args[2] if len(args) > 2 else kwargs.get(
            "encoder_hidden_states")
        t = args[1] if len(args) > 1 else kwargs["timestep"]
        return x.detach()[:, :channels], t, (x, ctx)
    return UNetTap(UNet2DConditionModel, parse)


def shared(cfg: dict, weights: Dict[str, dict], prompt: str,
           device) -> check.Shared:
    """The reference's models on `weights`, the prompt and the empty prompt
    through its text encoder, and the DDIM schedule."""
    ref = reference_models(cfg, weights, device)
    vocab = cfg["text_encoder"]["vocab_size"]
    n = cfg["text_encoder"]["max_position_embeddings"]
    ids = torch.tensor([hash_token_ids(prompt, vocab, n),
                        hash_token_ids("", vocab, n)], device=device)
    with torch.no_grad():
        emb = ref.clip(ids)
    sched = RefDDIMSchedule(cfg["guided_diffuser"]["num_timesteps"])
    return check.Shared(cfg, ref, sched, emb[:1], emb[1:],
                        torch.device(device))
