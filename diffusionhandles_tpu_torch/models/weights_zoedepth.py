"""ZoeDepth-NK weights: the JAX package's parameters and released
checkpoints -> `ZoeDepthNK` state dicts.

The port's modules carry the isl-org/ZoeDepth release names, so

* `zoedepth_state_dict` inverts the key and layout map of the JAX
  package's `models/weights_zoedepth.py` (flax paths under `nk/` back to
  release names; dense kernels [I, O] -> [O, I], conv kernels HWIO ->
  OIHW, transposed-conv kernels un-flipped back to [I, O, kh, kw]);
* `load_zoedepth_checkpoint` is a strict `load_state_dict` of a release
  `.pt` (`{'model': sd}` or bare), less the buffers the JAX package skips
  too (recomputed here), checked as a bijection: a missing or orphan key
  or a wrong shape raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.weights import (_flatten, _params,
                                                       validate_state_dict)

# release buffers that are recomputed, not loaded (as the JAX converter)
SKIP_SUFFIXES = ("relative_position_index", "k_idx", "K_minus_1",
                 "num_batches_tracked", "pos_enc")
_RAW = ("cls_token", "gamma_1", "gamma_2", "q_bias", "v_bias",
        "relative_position_bias_table")
_SUB = {"conv1": "0", "conv2": "2", "mlp_conv1": "0", "mlp_conv2": "2"}


def _module_key(path) -> str:
    """Release module name of a flax module path under nk/."""
    k = "/".join(path)
    rules = [
        (r"^core/backbone/patch_embed$",
         "core.core.pretrained.model.patch_embed.proj"),
        (r"^core/backbone/blocks_(\d+)/attn/(qkv|proj)$",
         r"core.core.pretrained.model.blocks.\1.attn.\2"),
        (r"^core/backbone/blocks_(\d+)/(fc1|fc2)$",
         r"core.core.pretrained.model.blocks.\1.mlp.\2"),
        (r"^core/backbone/blocks_(\d+)/(norm1|norm2)$",
         r"core.core.pretrained.model.blocks.\1.\2"),
        (r"^core/readout_(\d)/project$",
         lambda m: f"core.core.pretrained.act_postprocess"
                   f"{int(m.group(1)) + 1}.0.project.0"),
        (r"^core/reassemble_conv_(\d)$",
         lambda m: f"core.core.pretrained.act_postprocess"
                   f"{int(m.group(1)) + 1}.3"),
        (r"^core/resample_(\d)$",
         lambda m: f"core.core.pretrained.act_postprocess"
                   f"{int(m.group(1)) + 1}.4"),
        (r"^core/(layer\d_rn)$", r"core.core.scratch.\1"),
        (r"^core/(refinenet\d)/out_conv$", r"core.core.scratch.\1.out_conv"),
        (r"^core/(refinenet\d)/(resConfUnit\d)/(conv\d)$",
         r"core.core.scratch.\1.\2.\3"),
        (r"^core/output_conv_(\d)$", r"core.core.scratch.output_conv.\1"),
        (r"^conv2$", "conv2"),
        (r"^patch_transformer/embedding_convPxP$",
         "patch_transformer.embedding_convPxP"),
        (r"^patch_transformer/layers_(\d+)/out_proj$",
         r"patch_transformer.transformer_encoder.layers.\1.self_attn."
         r"out_proj"),
        (r"^patch_transformer/layers_(\d+)/(linear\d|norm\d)$",
         r"patch_transformer.transformer_encoder.layers.\1.\2"),
        (r"^mlp_classifier_(\d)$", r"mlp_classifier.\1"),
        (r"^seed_bin_regressors_(\w+)/(conv\d)$",
         lambda m: f"seed_bin_regressors.{m.group(1)}._net."
                   f"{_SUB[m.group(2)]}"),
        (r"^seed_projector/(conv\d)$",
         lambda m: f"seed_projector._net.{_SUB[m.group(1)]}"),
        (r"^projectors_(\d+)/(conv\d)$",
         lambda m: f"projectors.{m.group(1)}._net.{_SUB[m.group(2)]}"),
        (r"^attractors_(\w+)_(\d+)/_net/(conv\d)$",
         lambda m: f"attractors.{m.group(1)}.{m.group(2)}._net."
                   f"{_SUB[m.group(3)]}"),
        (r"^conditional_log_binomial_(\w+)/(mlp_conv\d)$",
         lambda m: f"conditional_log_binomial.{m.group(1)}.mlp."
                   f"{_SUB[m.group(2)]}"),
    ]
    for pattern, repl in rules:
        if re.match(pattern, k):
            return re.sub(pattern, repl, k)
    raise ValueError(f"unmapped ZoeDepth parameter path {k}")


def zoedepth_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """ZoeDepthModel flax params ({'params': {'nk': ...}}) -> a
    ZoeDepthNK state dict (release names)."""
    out = {}
    for path, value in _flatten(_params(flax_params)["nk"]):
        *mod, leaf = path
        if leaf in _RAW:  # parameters of their own, kept as they are
            if leaf == "cls_token":
                key = "core.core.pretrained.model.cls_token"
            else:
                in_attn = mod[-1] == "attn"
                i = re.match(r"blocks_(\d+)",
                             mod[-2] if in_attn else mod[-1]).group(1)
                key = (f"core.core.pretrained.model.blocks.{i}."
                       f"{'attn.' if in_attn else ''}{leaf}")
            out[key] = torch.from_numpy(np.array(value))
            continue
        if mod[-1] == "in_proj":  # the packed MultiheadAttention input
            i = re.match(r"layers_(\d+)", mod[-2]).group(1)
            base = (f"patch_transformer.transformer_encoder.layers.{i}."
                    "self_attn.in_proj_")
            out[base + ("weight" if leaf == "kernel" else "bias")] = \
                torch.from_numpy(np.array(value.T if leaf == "kernel"
                                          else value))
            continue
        name = _module_key(mod)
        if leaf == "kernel" and value.ndim == 4:
            if re.match(r"resample_[01]$", mod[-1]):
                # flax [kh, kw, I, O], taps flipped on conversion
                value = np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
            else:
                value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
        elif leaf == "kernel":
            value = value.T
        elif leaf not in ("scale", "bias"):
            raise ValueError(f"unhandled ZoeDepth leaf {'/'.join(path)}")
        suffix = "bias" if leaf == "bias" else "weight"
        out[f"{name}.{suffix}"] = torch.from_numpy(np.array(value))
    return out


def load_zoedepth_checkpoint(path: str, config=None
                             ) -> Dict[str, torch.Tensor]:
    """A release ZoeDepth-NK .pt/.bin ({'model': sd} or a bare state dict)
    -> a ZoeDepthNK state dict, the recomputed buffers dropped. With
    `config`, checked as a bijection onto ZoeDepthNK(config): a missing
    or orphan key, or a wrong shape, raises ValueError."""
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    state = {k: v.float() for k, v in sd.items()
             if isinstance(v, torch.Tensor)
             and not any(k.endswith(s) for s in SKIP_SUFFIXES)}
    if config is not None:
        from diffusionhandles_tpu_torch.models.zoedepth import ZoeDepthNK
        with torch.device("meta"):
            model = ZoeDepthNK(config)
        validate_state_dict(state, model.state_dict(), "zoedepth")
    return state

