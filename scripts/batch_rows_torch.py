"""Where two equal rows of a batch part on one NVIDIA GPU, and what
running the convolutions image by image costs.

    python3 scripts/batch_rows_torch.py

The batched edit runs the SD-2-depth U-Net at batch B (guidance, forward
and backward) and 2B (the CFG pass). This gives it, with seeded random
weights (bf16, flash attention), inputs whose rows 0 and 2 are equal, at
batch 4 and 8, and prints:
  * for the default U-Net under cuDNN's defaults, cudnn.deterministic and
    cuDNN off: the first leaf module whose output rows 0 and 2 differ, and
    whether eps and the gradient to the latents keep them equal;
  * every Conv2d of the U-Net that, given its own captured input with row
    2 set to row 0, returns rows 0 and 2 apart (shape, max difference,
    and the names of the CUDA kernels the profiler saw it launch);
  * the same twin-row checks for the U-Net with
    UNetConfig.conv_per_image (the batched edit's route), and for the
    U-Net whose 3x3 convs take the conv kernel K7 (conv3x3_kernel, split-K
    in a fixed order) with its other convs on cuDNN;
  * host-clock milliseconds (synchronized, median of 5) of a forward and
    of a forward + backward to the latents for each of the three.
Prints the card's name and power limit, then JSON lines; needs CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffusionhandles_tpu_torch.config import \
    GuidedDiffuserConfig  # noqa: E402
from diffusionhandles_tpu_torch.diffuser import \
    create_sd_models  # noqa: E402
from diffusionhandles_tpu_torch.models.unet import (  # noqa: E402
    Conv2d, UNet2DConditionModel)


def twin_inputs(unet, b: int):
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((b, unet.config.in_channels, 64, 64), generator=gen)
    ctx = torch.randn((b, 77, unet.config.cross_attention_dim),
                      generator=gen)
    x[2], ctx[2] = x[0], ctx[0]
    return x.cuda(), ctx.cuda()


def eps_and_grad(unet, x, ctx):
    lat = x[:, :4].clone().requires_grad_(True)
    eps, acts, _ = unet(torch.cat([lat, x[:, 4:]], 1),
                        torch.tensor(500, device="cuda"), ctx)
    (grad,) = torch.autograd.grad(
        sum(a.float().square().mean() for a in acts), lat)
    return eps, grad


def twin_rows(unet, x, ctx) -> dict:
    outs = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: outs.append((n, o)))
        for n, m in unet.named_modules() if not list(m.children())]
    eps, grad = eps_and_grad(unet, x, ctx)
    for hook in hooks:
        hook.remove()
    first = None
    for name, out in outs:
        out = out[0] if isinstance(out, tuple) else out
        if (isinstance(out, torch.Tensor) and out.shape[0] == x.shape[0]
                and not torch.equal(out[0], out[2])):
            first = {"module": name,
                     "type": type(unet.get_submodule(name)).__name__,
                     "shape": list(out.shape),
                     "max_abs_diff": float((out[0].float()
                                            - out[2].float()).abs().max())}
            break
    return {"first_differing_output": first,
            "eps_rows_bitwise": bool(torch.equal(eps[0], eps[2])),
            "eps_rows_max_abs_diff": float((eps[0] - eps[2]).abs().max()),
            "grad_rows_bitwise": bool(torch.equal(grad[0], grad[2]))}


def kernel_names(fn) -> list:
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


@torch.no_grad()
def differing_convs(unet, x, ctx) -> list:
    """Each Conv2d given its captured input with row 2 := row 0."""
    inputs = {}
    hooks = [m.register_forward_pre_hook(
        lambda m, a, n=n: inputs.setdefault(n, a[0].detach().clone()))
        for n, m in unet.named_modules() if isinstance(m, Conv2d)]
    unet(x, torch.tensor(500, device="cuda"), ctx)
    for hook in hooks:
        hook.remove()
    out = []
    for name, inp in inputs.items():
        conv = unet.get_submodule(name)
        inp[2] = inp[0]
        y = conv(inp)
        if not torch.equal(y[0], y[2]):
            out.append({"module": name, "input": list(inp.shape),
                        "max_abs_diff": float((y[0].float()
                                               - y[2].float()).abs().max()),
                        "kernels": kernel_names(lambda: conv(inp))})
    return out


def ms(fn, repeats: int = 5) -> float:
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    unet = create_sd_models(conf=GuidedDiffuserConfig(), device="cuda").unet

    def copy(**switches):
        cfg = dataclasses.replace(unet.config, **switches)
        with torch.device("meta"):
            other = UNet2DConditionModel(cfg)
        other.load_state_dict(unet.state_dict(), strict=True, assign=True)
        return other.eval().requires_grad_(False)

    per_image, k7 = copy(conv_per_image=True), copy(conv3x3_kernel=True)
    t = torch.tensor(500, device="cuda")
    for b in (4, 8):
        x, ctx = twin_inputs(unet, b)
        for setting, flags in (("cudnn default", {}),
                               ("cudnn.deterministic",
                                {"deterministic": True}),
                               ("cudnn off", {"enabled": False})):
            with torch.backends.cudnn.flags(**{"enabled": True,
                                               "deterministic": False,
                                               **flags}):
                print(json.dumps({"batch": b, "unet": "default",
                                  "setting": setting,
                                  **twin_rows(unet, x, ctx)}), flush=True)
        print(json.dumps({"batch": b, "differing_convs":
                          differing_convs(unet, x, ctx)}), flush=True)
        for name, net in (("conv_per_image", per_image),
                          ("conv3x3_kernel", k7)):
            print(json.dumps({"batch": b, "unet": name,
                              "setting": "cudnn default",
                              **twin_rows(net, x, ctx)}), flush=True)
        timing = {}
        for name, net in (("default", unet), ("conv_per_image", per_image),
                          ("conv3x3_kernel", k7), ("default_again", unet),
                          ("conv_per_image_again", per_image),
                          ("conv3x3_kernel_again", k7)):
            with torch.no_grad():
                fwd = ms(lambda: net(x, t, ctx))
            timing[name] = {"fwd_ms": fwd, "fwd_bwd_ms": ms(
                lambda: eps_and_grad(net, x, ctx))}
        print(json.dumps({"batch": b, "host_ms_synchronized": timing}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
