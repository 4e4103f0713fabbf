"""CLIP weights: the JAX package's parameters and released HF `CLIPModel`
state dicts -> the port's CLIP towers.

The port's image encoder carries the HF names (models/clip_image.py) and
its text encoder those of `CLIPTextModel` (models/clip_text.py), so

* `clip_vision_state_dict` inverts the JAX package's
  `models/weights_clip.py:convert_clip_vision` (flax `block_i` back to
  `vision_model.encoder.layers.i`, dense kernels [I, O] -> [O, I], the
  patch kernel HWIO -> OIHW, the projection [D, P] -> [P, D]);
* `load_clip_checkpoint` reads a full `CLIPModel` state dict (.safetensors
  through the port's own reader, else torch.load with weights only) into
  the two towers' state dicts and the text projection, each checked as a
  bijection onto its model: a missing or unknown key, or a wrong shape,
  raises. The text tower reuses `models/weights.py:clip_state_dict`'s
  names.
"""

from __future__ import annotations

import pathlib
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.clip_image import (CLIPImageConfig,
                                                          CLIPImageEncoder)
from diffusionhandles_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextModel)
from diffusionhandles_tpu_torch.models.weights import (_flatten, _leaf,
                                                       _params,
                                                       load_safetensors,
                                                       validate_state_dict)

# buffers and scalars of a released CLIPModel that no tower here holds
_SKIPPED = ("logit_scale", "text_model.embeddings.position_ids",
            "vision_model.embeddings.position_ids")


def clip_vit_b16() -> Tuple[CLIPImageConfig, CLIPTextConfig]:
    """openai/clip-vit-base-patch16."""
    img = CLIPImageConfig(image_size=224, patch_size=16, hidden_size=768,
                          num_layers=12, num_heads=12, projection_dim=512)
    txt = CLIPTextConfig(hidden_size=512, intermediate_size=2048,
                         num_heads=8, num_layers=12, hidden_act="quick_gelu")
    return img, txt


def clip_vit_l14() -> Tuple[CLIPImageConfig, CLIPTextConfig]:
    """openai/clip-vit-large-patch14."""
    img = CLIPImageConfig(image_size=224, patch_size=14, hidden_size=1024,
                          num_layers=24, num_heads=16, projection_dim=768)
    txt = CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                         num_heads=12, num_layers=12, hidden_act="quick_gelu")
    return img, txt


_TOP = {"class_embedding": "vision_model.embeddings.class_embedding",
        "pos_embed": "vision_model.embeddings.position_embedding.weight"}
_MODULES = {"patch_embed": "vision_model.embeddings.patch_embedding",
            "ln_pre": "vision_model.pre_layrnorm",
            "ln_post": "vision_model.post_layernorm"}
_BLOCK = {"ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1",
          "fc2": "mlp.fc2"}


def clip_vision_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """CLIPImageEncoder flax params -> a CLIPImageEncoder state dict (HF
    `vision_model.*` and `visual_projection.weight` names)."""
    out = {}
    for path, value in _flatten(_params(flax_params)):
        if path == ("visual_projection",):
            out["visual_projection.weight"] = torch.from_numpy(
                np.array(value.T))
            continue
        if len(path) == 1:
            out[_TOP[path[0]]] = torch.from_numpy(np.array(value))
            continue
        *mod, leaf = path
        m = re.match(r"block_(\d+)$", mod[0])
        if m:
            name = _BLOCK.get(mod[1], f"self_attn.{mod[1]}")
            key = f"vision_model.encoder.layers.{m.group(1)}.{name}"
        else:
            key = _MODULES[mod[0]]
        k, t = _leaf(key, leaf, value)
        out[k] = t
    return out


def _read(path: pathlib.Path) -> Dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}


def _expected(module_cls, config) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        return module_cls(config).state_dict()


def load_clip_checkpoint(path: str, image_config: CLIPImageConfig,
                         text_config: CLIPTextConfig):
    """A full HF CLIPModel state dict (.bin/.pt or .safetensors) ->
    (CLIPImageEncoder state dict, CLIPTextModel state dict,
    text_projection [D, P] fp32), as the JAX loader returns the towers'
    params and the projection. A key of no tower, a missing key or a wrong
    shape raises ValueError."""
    state = _read(pathlib.Path(path))
    state = {(k[len("clip."):] if k.startswith("clip.") else k): v.float()
             for k, v in state.items()}
    for k in _SKIPPED:
        state.pop(k, None)
    vision, text, rest = {}, {}, {}
    for k, v in state.items():
        if k.startswith("vision_model.") or k == "visual_projection.weight":
            vision[k] = v
        elif k.startswith("text_model."):
            text[k] = v
        elif k != "text_projection.weight":
            rest[k] = v
    if rest or "text_projection.weight" not in state:
        raise ValueError(
            f"clip checkpoint mismatch: keys of no tower {sorted(rest)[:4]}"
            f", text_projection.weight "
            f"{'present' if 'text_projection.weight' in state else 'missing'}")
    validate_state_dict(vision, _expected(CLIPImageEncoder, image_config),
                        "clip-vision")
    validate_state_dict(text, _expected(CLIPTextModel, text_config),
                        "clip-text")
    return vision, text, state["text_projection.weight"].T.contiguous()
