"""Seeded random weights, made on the device in a few large calls.

Each parameter gets LeCun-normal values (std 1/sqrt(fan_in)), zero biases,
unit norm scales, and embeddings with std 1/sqrt(width) (positions 0.01).
All parameters of one dtype are drawn by one `torch.randn` from a
`torch.Generator` on the device, then scaled and shifted by per-parameter
factors spread with `repeat_interleave`, and split into views: a handful
of launches whatever the number of parameters. The same seed gives the
same tensors, which the benchmark hands to the measured program and to the
plain reference alike.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _init_rule(module: nn.Module, name: str, p: torch.Tensor):
    """(mean, std) of one parameter."""
    owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
        else module
    leaf = name.rsplit(".", 1)[-1]
    if isinstance(owner, (nn.GroupNorm, nn.LayerNorm)):
        return (1.0, 0.0) if leaf == "weight" else (0.0, 0.0)
    if leaf == "bias":
        return 0.0, 0.0
    if isinstance(owner, nn.Embedding):
        return 0.0, (0.01 if "position" in name
                     else 1.0 / math.sqrt(p.shape[-1]))
    return 0.0, math.sqrt(1.0 / max(1, p[0].numel()))


def seeded_state_dicts(modules: Dict[str, nn.Module], seed: int,
                       device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model name: state dict} for `modules` (built on the meta device;
    each parameter is made in its own dtype) from `seed`."""
    entries = []  # (model, name, shape, dtype, mean, std)
    for model, mod in modules.items():
        for name, p in mod.named_parameters():
            mean, std = _init_rule(mod, name, p)
            entries.append((model, name, tuple(p.shape), p.dtype, mean, std))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in modules}
    for dtype in sorted({e[3] for e in entries}, key=str):
        group = [e for e in entries if e[3] == dtype]
        counts = torch.tensor([math.prod(e[2]) for e in group],
                              device=device)
        buf = torch.randn(int(counts.sum()), generator=gen, device=device,
                          dtype=dtype)
        std = torch.tensor([e[5] for e in group], device=device,
                           dtype=dtype)
        mean = torch.tensor([e[4] for e in group], device=device,
                            dtype=dtype)
        buf.mul_(torch.repeat_interleave(std, counts))
        buf.add_(torch.repeat_interleave(mean, counts))
        views = torch.split(buf, counts.tolist())
        for (model, name, shape, *_), view in zip(group, views):
            out[model][name] = view.view(shape)
    return out
