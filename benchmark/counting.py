"""The yardstick's arithmetic: operations and bytes of a kernel launch from
its shapes, the least time the card could take for them, and the model
FLOPs of a U-Net call.

Rules (a roofline share is bound time over measured kernel time):
* each input byte is read once and each output byte written once, whatever
  the kernel reads again;
* FLOPs are what these inputs need: 2 per multiply-add;
* attention's backward is its four products (dV, dP, dQ, dK), with no
  recomputation of the logits;
* the U-Net's weights are frozen, so a backward computes gradients to its
  inputs only: no weight gradient is counted anywhere.

Model FLOPs are counted by `torch.utils.flop_counter` on the plain
reference run on the meta device at the call's shapes, with the backward
from the same outputs as the program's call: it counts the matrix
products and convolutions that the call needs, and only along the layers
its gradient crosses.
"""

from __future__ import annotations

import functools
import json
import pathlib
import re

import torch

KERNELS = json.loads((pathlib.Path(__file__).parent
                      / "kernels.json").read_text())
PEAK_FLOPS = KERNELS["peaks"]["bf16_flops"]
PEAK_BYTES = KERNELS["peaks"]["hbm_bytes_per_s"]
HALF = 2  # bytes of a bf16 or fp16 element
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card takes: the larger of the operations over
    the peak rate and the bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def attention_fwd(b: int, sq: int, sk: int, h: int, d: int):
    """(flops, bytes) of a flash-attention forward: S = QK^T and O = PV;
    q, k, v in, o and the fp32 log-sum-exp out."""
    flops = 4 * b * h * sq * sk * d
    nbytes = HALF * (2 * b * sq * h * d + 2 * b * sk * h * d) \
        + F32 * b * h * sq
    return flops, nbytes


def attention_bwd(b: int, sq: int, sk: int, h: int, d: int):
    """(flops, bytes) of a flash-attention backward: dV = P^T dO,
    dP = dO V^T, dQ = dS K, dK = dS^T Q; q, k, v, o, dO and the fp32
    log-sum-exp in, dq, dk, dv out."""
    flops = 8 * b * h * sq * sk * d
    nbytes = (HALF * (3 * b * sq * h * d + 2 * b * sk * h * d)
              + F32 * b * h * sq
              + HALF * (b * sq * h * d + 2 * b * sk * h * d))
    return flops, nbytes


def gn_silu_conv3x3_fwd(b: int, h: int, w: int, ci: int, co: int,
                        groups: int):
    """(flops, bytes) of GroupNorm + SiLU + 3x3 conv, forward: the conv's
    products and about 10 elementwise operations per input element; x,
    gamma, beta and w in, y, the normalized input, and the per-group mean
    and inverse deviation out."""
    n = b * h * w
    flops = 2 * 9 * n * ci * co + 10 * n * ci
    nbytes = (HALF * (n * ci + 9 * ci * co) + F32 * 2 * ci
              + HALF * (n * co + n * ci) + F32 * 2 * b * groups)
    return flops, nbytes


def gn_silu_conv3x3_dx(b: int, h: int, w: int, ci: int, co: int,
                       groups: int):
    """(flops, bytes) of its input gradient: the transposed conv's products
    and about 20 elementwise operations per input element; x, gamma, beta,
    w, mean, inverse deviation and dy in, dx out."""
    n = b * h * w
    flops = 2 * 9 * n * ci * co + 20 * n * ci
    nbytes = (HALF * (n * ci + 9 * ci * co + n * co) + F32 * 2 * ci
              + F32 * 2 * b * groups + HALF * n * ci)
    return flops, nbytes


def kernel_matcher(kid: str):
    pats = [re.compile(p) for p in KERNELS["kernels"][kid]["patterns"]]
    return lambda name: any(p.search(name) for p in pats)


def layout_copy_matcher():
    pats = [re.compile(p) for p in KERNELS["layout_copy_patterns"]]
    return lambda name: any(p.search(name) for p in pats)


# ---------------------------------------------------------------------------
# Model FLOPs of a U-Net call and of the VAE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _meta_models(cfg_json: str):
    from benchmark.archs.sd2_depth import _unet_fields, _vae_fields
    from benchmark.reference.sd import (RefUNet, RefUNetConfig, RefVAE,
                                        RefVAEConfig)
    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        unet = RefUNet(RefUNetConfig(**_unet_fields(cfg))).requires_grad_(
            False)
        vae = RefVAE(RefVAEConfig(**_vae_fields(cfg))).requires_grad_(False)
    return unet, vae


def _counted(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def unet_call_flops(cfg_json: str, batch: int, grad: str) -> float:
    """FLOPs of one U-Net call at `batch`. grad: "" (forward only),
    "latents" (the guidance call: forward, then the gradient of the three
    recorded activations to the latents) or "context" (the null-text call:
    forward, then the gradient of eps to the text context)."""
    cfg = json.loads(cfg_json)
    unet, _ = _meta_models(cfg_json)
    u = cfg["unet"]
    res = u["sample_size"]
    dev = torch.device("meta")

    def call():
        x = torch.zeros(batch, u["in_channels"], res, res, device=dev,
                        requires_grad=grad == "latents")
        ctx = torch.zeros(batch, 77, u["cross_attention_dim"], device=dev,
                          requires_grad=grad == "context")
        t = torch.zeros((), dtype=torch.long, device=dev)
        with torch.enable_grad():
            eps, acts = unet(x, t, ctx)
            if grad == "latents":
                sum(a.sum() for a in acts).backward()
            elif grad == "context":
                eps.sum().backward()
    return _counted(call)


@functools.lru_cache(maxsize=None)
def vae_flops(cfg_json: str, part: str) -> float:
    """FLOPs of one VAE decode ("decode") or encode ("encode") of one
    image."""
    cfg = json.loads(cfg_json)
    _, vae = _meta_models(cfg_json)
    res = cfg["unet"]["sample_size"]
    n = len(cfg["vae"]["block_out_channels"])
    dev = torch.device("meta")
    if part == "decode":
        z = torch.zeros(1, cfg["vae"]["latent_channels"], res, res,
                        device=dev)
        return _counted(lambda: vae.decode(z))
    img = torch.zeros(1, 3, res * 2 ** (n - 1), res * 2 ** (n - 1),
                      device=dev)
    return _counted(lambda: vae.encode_mean(img))
