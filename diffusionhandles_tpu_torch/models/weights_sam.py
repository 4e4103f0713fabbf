"""SAM weights: the JAX package's parameters and released
`sam_vit_{b,l,h}_*.pth` files -> `SamModel` state dicts.

The port's modules carry the segment-anything release names, so

* `sam_state_dict` inverts the JAX package's `models/weights_sam.py`
  (flax paths back to `image_encoder.*` / `prompt_encoder.*` /
  `mask_decoder.*`; dense kernels [I, O] -> [O, I], conv kernels HWIO ->
  OIHW, the transposed convs' kernels un-flipped back to [I, O, kh, kw],
  norm scales -> weights, the raw tables and tokens as they are);
* `load_sam_checkpoint` is a strict read of a released .pth (a bare state
  dict), checked as a bijection onto SamModel(config): a missing or
  unknown key, or a wrong shape, raises ValueError, as the JAX package's
  `validate_sam_bijection` does.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.weights import (_flatten, _leaf,
                                                       _params, _rename,
                                                       validate_state_dict)

# flax names of nn.Sequential members -> their release indices
_SEQ = {"neck_conv1": 0, "neck_ln1": 1, "neck_conv2": 2, "neck_ln2": 3,
        "mask_down_conv1": 0, "mask_down_ln1": 1, "mask_down_conv2": 3,
        "mask_down_ln2": 4, "mask_down_conv3": 6}

# flax module path -> release module name
_RULES = [
    (r"^image_encoder/patch_embed$", "image_encoder.patch_embed.proj"),
    (r"^image_encoder/blocks_(\d+)/(norm1|norm2)$",
     r"image_encoder.blocks.\1.\2"),
    (r"^image_encoder/blocks_(\d+)/attn/(qkv|proj)$",
     r"image_encoder.blocks.\1.attn.\2"),
    (r"^image_encoder/blocks_(\d+)/(lin1|lin2)$",
     r"image_encoder.blocks.\1.mlp.\2"),
    (r"^image_encoder/(neck_\w+)$",
     lambda m: f"image_encoder.neck.{_SEQ[m.group(1)]}"),
    (r"^prompt_encoder/(mask_down_\w+)$",
     lambda m: f"prompt_encoder.mask_downscaling.{_SEQ[m.group(1)]}"),
    (r"^mask_decoder/layers_(\d+)/(self_attn|cross_attn_token_to_image|"
     r"cross_attn_image_to_token)/(\w+)$",
     r"mask_decoder.transformer.layers.\1.\2.\3"),
    (r"^mask_decoder/layers_(\d+)/(norm\d)$",
     r"mask_decoder.transformer.layers.\1.\2"),
    (r"^mask_decoder/layers_(\d+)/mlp_(lin\d)$",
     r"mask_decoder.transformer.layers.\1.mlp.\2"),
    (r"^mask_decoder/final_attn_token_to_image/(\w+)$",
     r"mask_decoder.transformer.final_attn_token_to_image.\1"),
    (r"^mask_decoder/norm_final_attn$",
     "mask_decoder.transformer.norm_final_attn"),
    (r"^mask_decoder/upscale_conv1$", "mask_decoder.output_upscaling.0"),
    (r"^mask_decoder/upscale_ln$", "mask_decoder.output_upscaling.1"),
    (r"^mask_decoder/upscale_conv2$", "mask_decoder.output_upscaling.3"),
    (r"^mask_decoder/hyper_(\d)_lin(\d)$",
     r"mask_decoder.output_hypernetworks_mlps.\1.layers.\2"),
    (r"^mask_decoder/iou_lin(\d)$",
     r"mask_decoder.iou_prediction_head.layers.\1"),
]

# raw flax parameters (no kernel/scale/bias leaf) -> release key
_RAW = [
    (r"^image_encoder/pos_embed$", "image_encoder.pos_embed"),
    (r"^image_encoder/blocks_(\d+)/attn/(rel_pos_[hw])$",
     r"image_encoder.blocks.\1.attn.\2"),
    (r"^prompt_encoder/positional_encoding_gaussian_matrix$",
     "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
    (r"^prompt_encoder/point_embed_(\d)$",
     r"prompt_encoder.point_embeddings.\1.weight"),
    (r"^prompt_encoder/(not_a_point_embed|no_mask_embed)$",
     r"prompt_encoder.\1.weight"),
    (r"^mask_decoder/(iou_token|mask_tokens)$", r"mask_decoder.\1.weight"),
]

_CONV_T = ("mask_decoder.output_upscaling.0",
           "mask_decoder.output_upscaling.3")


def sam_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """SamModel flax params ({'params': ...}) -> a SamModel state dict
    (release names)."""
    out = {}
    for path, value in _flatten(_params(flax_params)):
        raw = _rename(_RAW, "/".join(path))
        if raw is not None:
            out[raw] = torch.from_numpy(np.array(value))
            continue
        name = _rename(_RULES, "/".join(path[:-1]))
        if name is None:
            raise ValueError(f"unmapped SAM parameter path {'/'.join(path)}")
        if name in _CONV_T and path[-1] == "kernel":
            # flax [kh, kw, I, O], taps flipped on conversion
            out[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(value[::-1, ::-1], (2, 3, 0, 1))))
            continue
        k, t = _leaf(name, path[-1], value)
        out[k] = t
    return out


def load_sam_checkpoint(path: str, config=None) -> Dict[str, torch.Tensor]:
    """A released SAM .pth (a bare state dict, or one under 'state_dict')
    -> a SamModel state dict, checked as a bijection onto
    SamModel(config) (sam_vit_h() when None)."""
    from diffusionhandles_tpu_torch.models.sam import SamModel, sam_vit_h
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    state = {k: v.float() for k, v in sd.items()
             if isinstance(v, torch.Tensor)}
    with torch.device("meta"):
        expected = SamModel(config or sam_vit_h()).state_dict()
    validate_state_dict(state, expected, "sam")
    return state
