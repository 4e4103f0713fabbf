"""Time K7's general conv kernel (csrc/conv_general.cu) against cuDNN fp32
at every distinct 3x3 conv of the conv U-Net at 512x512 (B=1, fp32, TF32
off), forward and dx, each direction summed over the 47 convs of one U-Net
forward, and K9's general instances (fp32) at the first site against the
default path (F.group_norm, F.silu, F.conv2d; for dx its autograd backward
to x). Each K7 site also reports its error against the plain version over
2**-14 of the largest value (`err_over_tol`, the fp32 tolerance). Only the
ops' public entries are called, so a copy of this script in an earlier
tree of the package times and checks that tree's kernels the same way.

    python3 scripts/bench_conv_general.py [--label NAME]

Device times are chip_smoke.py's (`_device_ms`: median of 3 windows of 20
calls behind a device sleep), back-to-back host times its `_wall_ms`. One
JSON line per measurement, then the card's name and power limit. Needs a
CUDA card.
"""

import argparse
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from diffusionhandles_tpu_torch.ops import conv, gn_conv  # noqa: E402

F32_CONV_RTOL = 2.0 ** -14  # as chip_smoke.py's


def _times(kernel, other) -> dict:
    return {"kernel_ms": chip_smoke._device_ms(kernel),
            "other_ms": chip_smoke._device_ms(other),
            "kernel_wall_ms": chip_smoke._wall_ms(kernel),
            "other_wall_ms": chip_smoke._wall_ms(other)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="", help="tag of every line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_conv_general: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, scale=1.0, shift=0.0):
        return conv.to_kernel_layout(
            torch.randn(shape, generator=gen, device="cuda") * scale + shift)

    def line(**fields):
        print(json.dumps({"label": args.label, **fields}), flush=True)

    f32 = torch.float32
    sums = {d: dict.fromkeys(("kernel_ms", "other_ms", "kernel_wall_ms",
                              "other_wall_ms"), 0.0) for d in ("fwd", "dx")}
    for (side, ci, co), count in chip_smoke.CONV3_SITE_COUNTS.items():
        x = rand((1, ci, side, side), 1.5, 0.5)
        w = rand((co, ci, 3, 3), (9 * ci) ** -0.5)
        dy = rand((1, co, side, side))
        for d, kernel, plain, lib in (
                ("fwd", lambda: conv.conv3x3_fwd_general(x, w),
                 lambda: conv.conv3x3_fwd_ref(x, w),
                 lambda: F.conv2d(x, w, padding=1)),
                ("dx", lambda: conv.conv3x3_dx_general(dy, w, f32),
                 lambda: conv.conv3x3_dx_ref(dy, w, f32),
                 lambda: torch.nn.grad.conv2d_input(x.shape, w, dy,
                                                    padding=1))):
            want = plain()
            err = (kernel() - want).abs().max().item()
            t = _times(kernel, lib)
            line(bench="conv3x3_general_site", direction=d,
                 site=[side, ci, co], count=count,
                 err_over_tol=err / (F32_CONV_RTOL
                                     * want.abs().max().item()), **t)
            for k, v in t.items():
                sums[d][k] += count * v
    for d, acc in sums.items():
        line(bench="conv3x3_general_per_unet_forward", direction=d,
             **acc, kernel_over_cudnn=acc["kernel_ms"] / acc["other_ms"])

    side, ci, co = next(iter(chip_smoke.CONV3_SITE_COUNTS))
    x = rand((1, ci, side, side), 1.5, 0.5)
    w = rand((co, ci, 3, 3), (9 * ci) ** -0.5)
    dy = rand((1, co, side, side))
    g = 1.0 + 0.1 * torch.randn((ci,), generator=gen, device="cuda")
    beta = 0.1 * torch.randn((ci,), generator=gen, device="cuda")
    _, mean, rsig = gn_conv.gn_silu_conv3x3_fwd_ref(x, g, beta, w, 32, 1e-5)
    xd = x.detach().requires_grad_(True)

    def default_dx():
        z = F.silu(F.group_norm(xd, 32, g, beta, 1e-5))
        torch.autograd.grad(F.conv2d(z, w, padding=1), xd, dy)

    for d, kernel, default in (
            ("fwd", lambda: gn_conv.gn_silu_conv3x3_fwd_general(
                x, g, beta, w, 32, 1e-5),
             lambda: F.conv2d(F.silu(F.group_norm(x, 32, g, beta, 1e-5)), w,
                              padding=1)),
            ("dx", lambda: gn_conv.gn_silu_conv3x3_dx_general(
                x, g, beta, w, mean, rsig, dy, 32), default_dx)):
        line(bench="gn_silu_conv3x3_general", direction=d,
             site=[side, ci, co], **_times(kernel, default))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    line(card=smi.stdout.strip().splitlines()[0],
         kind=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
