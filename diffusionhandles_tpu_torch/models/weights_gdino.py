"""GroundingDINO weights: the JAX package's parameters and the released
`groundingdino_swint_ogc.pth` -> `GroundingDinoModel` state dicts.

The port's modules carry the IDEA-Research release names, so

* `gdino_state_dict` inverts the JAX package's `models/weights_gdino.py`
  (flax paths back to `backbone.0.*`, `bert.*`, `feat_map`,
  `input_proj.*`, `transformer.*`; dense kernels [I, O] -> [O, I], conv
  kernels HWIO -> OIHW, the packed attention kernels [D, 3D] ->
  `in_proj_weight` [3D, D]), adds the Swin `relative_position_index`
  buffers the release holds, and emits the decoder's box heads under both
  of the release's names (`transformer.decoder.bbox_embed.N.*` and the
  top-level alias `bbox_embed.N.*`, one module in the port);
* `load_gdino_checkpoint` reads `{'model': sd}` (or a bare state dict),
  strips a `module.` prefix, requires each top-level `bbox_embed.*` alias
  to equal its decoder copy, and checks the whole as a bijection onto
  GroundingDinoModel(config): a missing or unknown key, or a wrong shape,
  raises ValueError. BERT's `embeddings.position_ids` buffer, which some
  transformers versions save, is dropped (the port makes its own).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.swin import _rel_pos_index
from diffusionhandles_tpu_torch.models.weights import (_flatten, _leaf,
                                                       _params, _rename,
                                                       validate_state_dict)

_BERT = {"query": "attention.self.query", "key": "attention.self.key",
         "value": "attention.self.value",
         "attention_output_dense": "attention.output.dense",
         "attention_output_LayerNorm": "attention.output.LayerNorm",
         "intermediate_dense": "intermediate.dense",
         "output_dense": "output.dense",
         "output_LayerNorm": "output.LayerNorm"}

# flax module path -> release module name
_RULES = [
    (r"^backbone/patch_embed$", "backbone.0.patch_embed.proj"),
    (r"^backbone/patch_embed_norm$", "backbone.0.patch_embed.norm"),
    (r"^backbone/out_norm_(\d)$", r"backbone.0.norm\1"),
    (r"^backbone/layers_(\d+)_blocks_(\d+)/(norm1|norm2)$",
     r"backbone.0.layers.\1.blocks.\2.\3"),
    (r"^backbone/layers_(\d+)_blocks_(\d+)/attn/(qkv|proj)$",
     r"backbone.0.layers.\1.blocks.\2.attn.\3"),
    (r"^backbone/layers_(\d+)_blocks_(\d+)/(fc1|fc2)$",
     r"backbone.0.layers.\1.blocks.\2.mlp.\3"),
    (r"^backbone/layers_(\d+)_downsample/(reduction|norm)$",
     r"backbone.0.layers.\1.downsample.\2"),
    (r"^bert/embeddings_LayerNorm$", "bert.embeddings.LayerNorm"),
    (r"^bert/pooler$", "bert.pooler.dense"),
    (r"^bert/layer_(\d+)/(\w+)$",
     lambda m: f"bert.encoder.layer.{m.group(1)}.{_BERT[m.group(2)]}"),
    (r"^feat_map$", "feat_map"),
    (r"^input_proj_(\d)_conv$", r"input_proj.\1.0"),
    (r"^input_proj_(\d)_norm$", r"input_proj.\1.1"),
    (r"^enc_layer_(\d+)/self_attn/(\w+)$",
     r"transformer.encoder.layers.\1.self_attn.\2"),
    (r"^enc_layer_(\d+)/(\w+)$", r"transformer.encoder.layers.\1.\2"),
    (r"^text_layer_(\d+)/out_proj$",
     r"transformer.encoder.text_layers.\1.self_attn.out_proj"),
    (r"^text_layer_(\d+)/(\w+)$", r"transformer.encoder.text_layers.\1.\2"),
    (r"^fusion_layer_(\d+)/(layer_norm_[vl])$",
     r"transformer.encoder.fusion_layers.\1.\2"),
    (r"^fusion_layer_(\d+)/(\w+)$",
     r"transformer.encoder.fusion_layers.\1.attn.\2"),
    (r"^dec_layer_(\d+)/cross_attn/(\w+)$",
     r"transformer.decoder.layers.\1.cross_attn.\2"),
    (r"^dec_layer_(\d+)/(self_attn|ca_text)_out_proj$",
     r"transformer.decoder.layers.\1.\2.out_proj"),
    (r"^dec_layer_(\d+)/(\w+)$", r"transformer.decoder.layers.\1.\2"),
    (r"^bbox_embed_(\d+)/layers_(\d)$",
     r"transformer.decoder.bbox_embed.\1.layers.\2"),
    (r"^ref_point_head/layers_(\d)$",
     r"transformer.decoder.ref_point_head.layers.\1"),
    (r"^decoder_norm$", "transformer.decoder.norm"),
    (r"^(enc_output|enc_output_norm)$", r"transformer.\1"),
    (r"^enc_out_bbox_embed/layers_(\d)$",
     r"transformer.enc_out_bbox_embed.layers.\1"),
]

# raw flax parameters -> release key
_RAW = [
    (r"^backbone/layers_(\d+)_blocks_(\d+)/attn/"
     r"relative_position_bias_table$",
     r"backbone.0.layers.\1.blocks.\2.attn.relative_position_bias_table"),
    (r"^bert/(word|position|token_type)_embeddings$",
     r"bert.embeddings.\1_embeddings.weight"),
    (r"^level_embed$", "transformer.level_embed"),
    (r"^tgt_embed$", "transformer.tgt_embed.weight"),
    (r"^fusion_layer_(\d+)/(gamma_[vl])$",
     r"transformer.encoder.fusion_layers.\1.\2"),
]

# packed attention projections (the flax _InProj modules)
_IN_PROJ = [
    (r"^text_layer_(\d+)/in_proj$",
     r"transformer.encoder.text_layers.\1.self_attn"),
    (r"^dec_layer_(\d+)/(self_attn|ca_text)_in_proj$",
     r"transformer.decoder.layers.\1.\2"),
]

_ALIAS = "transformer.decoder.bbox_embed."
_SKIPPED = ("bert.embeddings.position_ids",)



def gdino_state_dict(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """GroundingDinoModel flax params ({'params': ...}) -> a
    GroundingDinoModel state dict with the release's key set (the
    relative_position_index buffers and the bbox_embed alias included)."""
    out = {}
    for path, value in _flatten(_params(flax_params)):
        key = "/".join(path)
        raw = _rename(_RAW, key)
        if raw is not None:
            out[raw] = torch.from_numpy(np.array(value))
            continue
        mod, leaf = "/".join(path[:-1]), path[-1]
        packed = _rename(_IN_PROJ, mod)
        if packed is not None:
            v = value.T if leaf == "kernel" else value
            out[f"{packed}.in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
                ] = torch.from_numpy(np.array(v))
            continue
        name = _rename(_RULES, mod)
        if name is None:
            raise ValueError(f"unmapped GroundingDINO parameter path {key}")
        k, t = _leaf(name, leaf, value)
        out[k] = t
    for k in list(out):
        if k.endswith(".relative_position_bias_table"):
            ws = (int(round(np.sqrt(out[k].shape[0]))) + 1) // 2
            out[k.replace("_bias_table", "_index")] = _rel_pos_index(ws)
        elif k.startswith(_ALIAS):
            out[k[len("transformer.decoder."):]] = out[k]
    return out


def load_gdino_checkpoint(path: str, config=None) -> Dict[str, torch.Tensor]:
    """A released groundingdino_*.pth ({'model': sd} or bare) -> a
    GroundingDinoModel state dict, checked as a bijection onto
    GroundingDinoModel(config) (GroundingDinoConfig() when None)."""
    from diffusionhandles_tpu_torch.models.groundingdino import (
        GroundingDinoConfig, GroundingDinoModel)
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    state = {}
    for k, v in sd.items():
        if not isinstance(v, torch.Tensor):
            continue
        k = k[len("module."):] if k.startswith("module.") else k
        if k not in _SKIPPED:
            state[k] = v.float() if v.is_floating_point() else v
    for k, v in state.items():
        if k.startswith("bbox_embed."):
            twin = state.get("transformer.decoder." + k)
            if twin is not None and not torch.equal(twin, v):
                raise ValueError(f"bbox_embed alias mismatch at {k}: the "
                                 f"release's two names hold one module")
    with torch.device("meta"):
        expected = GroundingDinoModel(config or GroundingDinoConfig()
                                      ).state_dict()
    validate_state_dict(state, expected, "groundingdino")
    return state
