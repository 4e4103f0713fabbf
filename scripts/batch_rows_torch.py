"""Where two equal rows of a batch part on one NVIDIA GPU.

    python3 scripts/batch_rows_torch.py

The batched edit runs the SD-2-depth U-Net at batch 4. This gives it, with
seeded random weights (bf16, flash attention), a batch-4 input whose rows
0 and 2 are equal, runs the forward and the backward to the latents, and
prints the first leaf module whose output rows 0 and 2 differ, how far
apart the eps and the gradient rows end, once with cuDNN's defaults, once
with torch.backends.cudnn.deterministic and once with cuDNN off. Prints
the card's name and power limit, then JSON lines; needs CUDA.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffusionhandles_tpu_torch.config import \
    GuidedDiffuserConfig  # noqa: E402
from diffusionhandles_tpu_torch.diffuser import \
    create_sd_models  # noqa: E402


def twin_rows(unet, x, ctx) -> dict:
    outs = []
    hooks = [m.register_forward_hook(
        lambda m, i, o, n=n: outs.append((n, o)))
        for n, m in unet.named_modules() if not list(m.children())]
    lat = x[:, :4].clone().requires_grad_(True)
    eps, acts, _ = unet(torch.cat([lat, x[:, 4:]], 1),
                        torch.tensor(500, device="cuda"), ctx)
    for hook in hooks:
        hook.remove()
    first = None
    for name, out in outs:
        out = out[0] if isinstance(out, tuple) else out
        if (isinstance(out, torch.Tensor) and out.shape[0] == 4
                and not torch.equal(out[0], out[2])):
            first = {"module": name,
                     "type": type(unet.get_submodule(name)).__name__,
                     "shape": list(out.shape),
                     "max_abs_diff": float((out[0].float()
                                            - out[2].float()).abs().max())}
            break
    (grad,) = torch.autograd.grad(
        sum(a.float().square().mean() for a in acts), lat)
    return {"first_differing_output": first,
            "eps_rows_bitwise": bool(torch.equal(eps[0], eps[2])),
            "eps_rows_max_abs_diff": float((eps[0] - eps[2]).abs().max()),
            "grad_rows_bitwise": bool(torch.equal(grad[0], grad[2]))}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    unet = create_sd_models(conf=GuidedDiffuserConfig(), device="cuda").unet
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((4, unet.config.in_channels, 64, 64), generator=gen)
    ctx = torch.randn((4, 77, unet.config.cross_attention_dim),
                      generator=gen)
    x[2], ctx[2] = x[0], ctx[0]
    x, ctx = x.cuda(), ctx.cuda()
    for setting, flags in (("cudnn default", {}),
                           ("cudnn.deterministic", {"deterministic": True}),
                           ("cudnn off", {"enabled": False})):
        with torch.backends.cudnn.flags(**{"enabled": True,
                                           "deterministic": False,
                                           **flags}):
            print(json.dumps({"setting": setting,
                              **twin_rows(unet, x, ctx)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
