"""big-lama weights: the JAX package's variables and released checkpoints
-> `LamaGenerator` state dicts.

The port's generator carries the release names (`model.<i>.*`), so

* `lama_state_dict` inverts the JAX package's `models/weights_lama.py`
  (flax `m<i>` modules back to `model.<i>`, conv kernels HWIO -> OIHW,
  the transposed convs' kernels un-flipped back to [I, O, kh, kw],
  BatchNorm scale/bias and batch_stats mean/var back to weight/bias and
  running_mean/running_var);
* `load_lama_checkpoint` reads a lightning `best.ckpt` (the generator's
  `generator.*` entries; the discriminator's and the rest are ignored) or
  a bare generator state dict, checked as a bijection onto the model: a
  missing or orphan key, or a wrong shape, raises.

BatchNorm's `num_batches_tracked` counters are not read in eval mode;
where a source lacks them (the JAX package has none) they are set to 0.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.weights import (_flatten,
                                                       validate_state_dict)

# BatchNorm leaves (a bias keeps its name)
_BN_LEAVES = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def _with_counters(state: Dict[str, torch.Tensor], expected: Mapping
                   ) -> Dict[str, torch.Tensor]:
    out = dict(state)
    for k in expected:
        if k.endswith("num_batches_tracked") and k not in out:
            out[k] = torch.tensor(0, dtype=torch.long)
    return out


def _expected(config) -> Dict[str, torch.Tensor]:
    from diffusionhandles_tpu_torch.models.lama import LamaGenerator
    with torch.device("meta"):
        return LamaGenerator(config).state_dict()


def lama_state_dict(flax_variables: Mapping, config
                    ) -> Dict[str, torch.Tensor]:
    """LamaGenerator flax variables ({'params', 'batch_stats'}) -> a
    LamaGenerator state dict for `config`."""
    nd, nb = config.n_downsampling, config.n_blocks
    upconv = {3 + nd + nb + 3 * i for i in range(nd)}
    out = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(flax_variables[coll]):
            *mod, leaf = path
            idx = int(re.match(r"m(\d+)$", mod[0]).group(1))
            name = ".".join([f"model.{idx}"] + mod[1:])
            name = name.replace("convg2g.conv1_conv", "convg2g.conv1.0")
            name = name.replace("convg2g.conv1_bn", "convg2g.conv1.1")
            if leaf == "kernel" and idx in upconv:
                # flax [kh, kw, I, O], taps flipped on conversion
                value = np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
                leaf = "weight"
            elif leaf == "kernel":
                value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
                leaf = "weight"
            elif leaf in _BN_LEAVES:
                leaf = _BN_LEAVES[leaf]
            out[f"{name}.{leaf}"] = torch.from_numpy(np.array(value))
    return _with_counters(out, _expected(config))


def load_lama_checkpoint(path: str, config=None) -> Dict[str, torch.Tensor]:
    """A big-lama checkpoint (lightning `best.ckpt` or a bare generator
    state dict) -> a LamaGenerator state dict, checked as a bijection onto
    LamaGenerator(config) (LamaConfig() when None)."""
    from diffusionhandles_tpu_torch.models.lama import LamaConfig
    raw = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    state = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if any(k.startswith("generator.") for k in state):
        state = {k[len("generator."):]: v for k, v in state.items()
                 if k.startswith("generator.")}
    state = {k: v if k.endswith("num_batches_tracked") else v.float()
             for k, v in state.items()}
    expected = _expected(config or LamaConfig())
    state = _with_counters(state, expected)
    validate_state_dict(state, expected, "lama")
    return state
