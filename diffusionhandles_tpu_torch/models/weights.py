"""JAX parameters -> port state dicts.

Converts the JAX package's flax parameter trees (nested dicts of arrays,
as `init_*_params` or `models/weights.py:convert_*` produce them) into this
package's `state_dict`s, loadable with `load_state_dict(..., strict=True)`.
It inverts the key and layout maps of the JAX package's
`models/weights.py:67-160`: flax module paths become diffusers / transformers
names, dense kernels [I, O] become Linear weights [O, I], conv kernels HWIO
become OIHW, and norm `scale`s become `weight`s.

It also reads a released diffusers checkpoint directory into the port's
modules (`load_checkpoint_into`): the names are already the port's, so
that is a strict `load_state_dict`. `.safetensors` files are read by a
small reader of this module's own (the safetensors package need not be
installed).
"""

from __future__ import annotations

import json
import pathlib
import re
import struct
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


def validate_state_dict(state: Mapping[str, torch.Tensor],
                        expected: Mapping[str, torch.Tensor],
                        what: str) -> None:
    """Raise ValueError unless `state` has exactly `expected`'s keys, each
    with its shape."""
    missing = sorted(set(expected) - set(state))
    orphans = sorted(set(state) - set(expected))
    if missing or orphans:
        raise ValueError(
            f"{what} checkpoint mismatch: {len(missing)} model params "
            f"unassigned (e.g. {missing[:4]}), {len(orphans)} checkpoint "
            f"keys unconsumed (e.g. {orphans[:4]}).")
    bad = [(k, tuple(state[k].shape), tuple(expected[k].shape))
           for k in expected if state[k].shape != expected[k].shape]
    if bad:
        raise ValueError(f"{what} checkpoint shape mismatches: {bad[:4]}")


# ---------------------------------------------------------------------------
# Released checkpoints: a diffusers directory (unet/, vae/, text_encoder/,
# tokenizer/), read without the safetensors package
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64,
                       "I32": torch.int32, "U8": torch.uint8}
# buffers a released text encoder may hold that are not module state here
_SKIPPED_KEYS = ("text_model.embeddings.position_ids",)


def load_safetensors(path) -> Dict[str, torch.Tensor]:
    """Read a .safetensors file: an 8-byte little-endian header length, a
    JSON header {name: {dtype, shape, data_offsets}}, then the raw
    buffers. F32, F16, BF16, I64, I32 and U8 tensors (a text encoder's
    position_ids are I64); anything else raises."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which is not read")
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        if count * itemsize != end - begin or end > len(data):
            raise ValueError(f"{path}: tensor {name} has bad offsets "
                             f"{info['data_offsets']}")
        if not count:
            flat = torch.empty(0, dtype=dtype)
        elif begin % itemsize:  # a misaligned buffer is copied out
            flat = torch.frombuffer(bytearray(data[begin:end]), dtype=dtype)
        else:
            flat = torch.frombuffer(data, dtype=dtype, count=count,
                                    offset=begin)
        out[name] = flat.reshape(info["shape"])
    return out


def load_state_dict_dir(model_dir) -> Dict[str, torch.Tensor]:
    """The state dict of one diffusers submodel directory: its
    *.safetensors files if it has any, else its *.bin files (torch.load,
    weights only), as the JAX package's models/weights.py reads them."""
    model_dir = pathlib.Path(model_dir)
    state: Dict[str, torch.Tensor] = {}
    files = sorted(model_dir.glob("*.safetensors"))
    for f in files:
        state.update(load_safetensors(f))
    if not files:
        files = sorted(model_dir.glob("*.bin"))
        for f in files:
            state.update(torch.load(str(f), map_location="cpu",
                                    weights_only=True))
    if not files:
        raise FileNotFoundError(f"No weight files in {model_dir}")
    return {k: v for k, v in state.items() if k not in _SKIPPED_KEYS}


def load_checkpoint_into(module: torch.nn.Module, model_dir, what: str
                         ) -> None:
    """Strictly load a diffusers submodel directory into `module`: a
    missing or unexpected key, or a wrong shape, raises, naming `what`."""
    try:
        module.load_state_dict(load_state_dict_dir(model_dir), strict=True)
    except RuntimeError as exc:
        raise ValueError(f"{what} checkpoint at {model_dir} does not match "
                         f"the model: {exc}") from exc
