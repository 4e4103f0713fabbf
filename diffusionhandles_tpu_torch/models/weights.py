"""JAX parameters -> port state dicts.

Converts the JAX package's flax parameter trees (nested dicts of arrays,
as `init_*_params` or `models/weights.py:convert_*` produce them) into this
package's `state_dict`s, loadable with `load_state_dict(..., strict=True)`.
It inverts the key and layout maps of the JAX package's
`models/weights.py:67-160`: flax module paths become diffusers / transformers
names, dense kernels [I, O] become Linear weights [O, I], conv kernels HWIO
become OIHW, and norm `scale`s become `weight`s.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val, np.float32)


def _params(tree: Mapping) -> Mapping:
    return tree["params"] if "params" in tree else tree


def _leaf(module_key: str, leaf: str, value: np.ndarray
          ) -> Tuple[str, torch.Tensor]:
    """(torch key, tensor) of one flax leaf under torch module path
    `module_key`."""
    if leaf == "kernel":
        if value.ndim == 4:
            value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
        elif value.ndim == 2:
            value = value.T  # [I, O] -> [O, I]
        name = "weight"
    elif leaf in ("scale", "embedding"):
        name = "weight"
    elif leaf == "bias":
        name = "bias"
    else:
        raise ValueError(f"unhandled flax leaf {leaf!r} under {module_key}")
    return f"{module_key}.{name}", torch.from_numpy(np.array(value))


def unet_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """UNet2DCondition flax params -> UNet2DConditionModel state dict."""
    out = {}
    for path, value in _flatten(_params(flax_params)):
        k = ".".join(path[:-1])
        k = k.replace("time_embedding_linear_", "time_embedding.linear_")
        k = re.sub(r"(down_blocks|up_blocks|resnets|attentions|"
                   r"downsamplers|upsamplers)_(\d+)", r"\1.\2", k)
        k = k.replace("block0", "transformer_blocks.0")
        k = k.replace("ff_proj", "ff.net.0.proj")
        k = k.replace("ff_out", "ff.net.2")
        k = re.sub(r"\.to_out$", ".to_out.0", k)
        key, tensor = _leaf(k, path[-1], value)
        out[key] = tensor
    return out


def vae_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """AutoencoderKL flax params -> AutoencoderKL state dict."""
    out = {}
    for path, value in _flatten(_params(flax_params)):
        k = ".".join(path[:-1])
        k = re.sub(r"down_(\d+)_resnets_(\d+)", r"down_blocks.\1.resnets.\2",
                   k)
        k = re.sub(r"down_(\d+)_downsample",
                   r"down_blocks.\1.downsamplers.0.conv", k)
        k = re.sub(r"up_(\d+)_resnets_(\d+)", r"up_blocks.\1.resnets.\2", k)
        k = re.sub(r"up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0.conv",
                   k)
        k = re.sub(r"mid_resnets_(\d+)", r"mid_block.resnets.\1", k)
        k = k.replace("mid_attn", "mid_block.attentions.0")
        k = re.sub(r"\.to_out$", ".to_out.0", k)
        key, tensor = _leaf(k, path[-1], value)
        out[key] = tensor
    return out


def clip_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """CLIPTextEncoder flax params -> CLIPTextModel state dict."""
    out = {}
    for path, value in _flatten(_params(flax_params)):
        if path == ("position_embedding",):
            out["text_model.embeddings.position_embedding.weight"] = \
                torch.from_numpy(np.array(value))
            continue
        k = ".".join(path[:-1])
        if k == "token_embedding":
            k = "embeddings.token_embedding"
        k = re.sub(r"^layers_(\d+)", r"encoder.layers.\1", k)
        k = re.sub(r"\.(fc1|fc2)$", r".mlp.\1", k)
        key, tensor = _leaf("text_model." + k, path[-1], value)
        out[key] = tensor
    return out
