"""Per-call cost of the PyTorch port's SD-2-depth U-Net on one NVIDIA GPU.

    python3 scripts/profile_torch_unet.py [--fused] [--conv]

Times the three U-Net call shapes of the main path at 64x64 latents with
seeded random weights (median of repeats, synchronized): the batch-1
forward (DDIM inversion, the null-text conditional pass), the batch-1
forward + backward to the latents (guidance; null-text differentiates to
the embedding instead), and the batch-2 CFG forward. Then one batch-1
forward + backward under torch.profiler: device time by kernel, the count
of device ops (kernels and copies) in the call, the flash kernels' device
ms (each kernel, and their sum), the conv GEMM's (conv.cu: K7, or K9's
GEMMs in the fused U-Net), the GroupNorm kernel's (K8: device ms and
launches) and, for the fused U-Net, K9's (its GEMMs and passes, each
kernel) and K9's share of the device time, the copy kernels (PyTorch's copies, which layout changes and
dtype casts both run, and cuDNN's NCHW <-> NHWC transposes) and their
share of the device time, the inputs K9's and K8's wrappers copied into
their kernels' layouts, and the device's busy share of the wall time
(profiled, and against the unprofiled call). With --fused, the U-Net with
the fused GroupNorm kernels (UNetConfig.fused_gn_conv, fused_gn; same
weights), and
with --conv, the U-Net with the conv kernel (UNetConfig.conv3x3_kernel;
same weights), are timed in turns with the default one and profiled after
it. Prints JSON lines; needs CUDA.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _median_ms(calls, repeats: int = 9) -> dict:
    """Median wall ms of each call, timed round-robin (one warm-up round),
    so that clock ramps and neighbours hit every call alike."""
    times = {name: [] for name in calls}
    for rnd in range(repeats + 1):
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rnd:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def _calls(unet, x, t, ctx, tag: str) -> dict:
    def fwd_b1():
        with torch.no_grad():
            unet(x, t, ctx[:1])

    def fwd_b2():
        with torch.no_grad():
            unet(torch.cat([x, x]), t, ctx)

    def fwd_bwd_b1():
        lat = x.clone().requires_grad_(True)
        acts = unet(lat, t, ctx[:1])[1]
        torch.autograd.grad(sum(a.float().square().mean() for a in acts),
                            lat)

    return {f"{tag}fwd_b1": fwd_b1, f"{tag}fwd_bwd_b1": fwd_bwd_b1,
            f"{tag}fwd_b2": fwd_b2}


def _profile(fwd_bwd, call_ms: float, label: str) -> None:
    """One fwd+bwd under torch.profiler: device time by kernel, and the
    device's busy share. In the fused U-Net (label "fused_...") conv.cu's
    GEMM runs only inside K9."""
    from torch.profiler import ProfilerActivity, profile

    from diffusionhandles_tpu_torch.ops import gn_conv, groupnorm
    fwd_bwd()
    torch.cuda.synchronize()
    copies0 = gn_conv.LAYOUT_COPIES["gn_conv"]
    gn_copies0 = groupnorm.LAYOUT_COPIES["gn"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's device
        # time would count its kernels a second time
        if not str(ev.device_type).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    flash = [r for r in rows if "flash" in r[1]]
    # conv.cu's GEMM and split-K sum (K7's, or K9's GEMMs); K9's own passes
    # are gnconv::, K8's gn::
    conv_us = sum(r[0] for r in rows
                  if re.search(r"\bconv::(conv3x3|splitk_sum)_kernel", r[1]))
    gnconv = [r for r in rows if re.search(r"\bgnconv::", r[1])]
    gn = [r for r in rows if re.search(r"\bgn::", r[1])]
    gn_us = sum(r[0] for r in gn)
    k9 = gnconv + ([r for r in rows if re.search(r"\bconv::", r[1])]
                   if label.startswith("fused_") else [])
    k9_us = sum(r[0] for r in k9)
    # copy kernels: PyTorch's (layout changes and dtype casts alike) and
    # cuDNN's own NCHW <-> NHWC transposes
    layout = [r for r in rows if any(k in r[1].lower() for k in (
        "copy_kernel", "nchwtonhwc", "nhwctonchw"))]
    layout_us = sum(r[0] for r in layout)
    print(json.dumps({
        label: {
            "wall_ms": wall * 1e3, "device_ms": total_us / 1e3,
            "device_ops": sum(r[2] for r in rows),
            "device_busy_share": total_us / 1e3 / (wall * 1e3),
            # the profiler slows the host; against the unprofiled call:
            "device_busy_share_unprofiled": total_us / 1e3 / call_ms,
            "flash_kernels_ms": sum(r[0] for r in flash) / 1e3,
            "flash_kernels": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                              for us, k, n in flash],
            "conv3x3_kernels_ms": conv_us / 1e3,
            "gn_kernels_ms": gn_us / 1e3,
            "gn_kernel_launches": sum(r[2] for r in gn),
            "gn_conv_kernels_ms": k9_us / 1e3,
            "gn_conv_share": k9_us / total_us,
            "gn_conv_kernels": [{"kernel": k[:90], "ms": us / 1e3,
                                 "count": n} for us, k, n in k9],
            # inputs K9's wrappers copied into its layout (channels-last)
            "gn_conv_layout_copies": (gn_conv.LAYOUT_COPIES["gn_conv"]
                                      - copies0),
            # inputs K8's wrappers copied into its layout
            "gn_layout_copies": groupnorm.LAYOUT_COPIES["gn"] - gn_copies0,
            "layout_copies_ms": layout_us / 1e3,
            "layout_copies_share": layout_us / total_us,
            "layout_copies": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                              for us, k, n in layout],
            "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                    for us, k, n in rows[:15]]}}))


def main() -> None:
    from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig
    from diffusionhandles_tpu_torch.diffuser import create_sd_models
    from diffusionhandles_tpu_torch.models.unet import UNet2DConditionModel

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    unet = create_sd_models(conf=GuidedDiffuserConfig(),
                            device="cuda").unet
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 5, 64, 64), generator=gen).cuda()
    ctx = torch.randn((2, 77, 1024), generator=gen).cuda()
    t = torch.tensor(500, device="cuda")

    calls = _calls(unet, x, t, ctx, "")
    variants = {"fused_": dict(fused_gn_conv=True, fused_gn=True),
                "conv_": dict(conv3x3_kernel=True)}
    tags = [tag for tag in variants if f"--{tag[:-1]}" in sys.argv[1:]]
    for tag in tags:
        cfg = dataclasses.replace(unet.config, **variants[tag])
        with torch.device("cuda"):
            other = UNet2DConditionModel(cfg)
        other.load_state_dict(unet.state_dict(), strict=True)
        other.eval().requires_grad_(False)
        calls.update(_calls(other, x, t, ctx, tag))
    call_ms = _median_ms(calls)
    print(json.dumps({"unet_call_ms": call_ms}))
    for tag in [""] + tags:
        _profile(calls[f"{tag}fwd_bwd_b1"], call_ms[f"{tag}fwd_bwd_b1"],
                 f"{tag}fwd_bwd_b1_profiled")


if __name__ == "__main__":
    main()
