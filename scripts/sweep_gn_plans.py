"""Every plan of the GroupNorm kernel (K8) at the U-Net's GroupNorm sites,
forward and backward, on one NVIDIA GPU.

    python3 scripts/sweep_gn_plans.py

For each site of chip_smoke.py's GN_SHAPES, each batch of its BATCHES and
each layout of its GN_LAYOUTS, every plan csrc/gn.cu can run there (each
cluster size of ops/groupnorm.py's CLUSTERS whose slab fits, and the
streaming plan), forced through the private `_fwd_stats` / `_bwd_uv`, is
held to the plain versions (chip_smoke.py's GN_RTOL) and timed
device-ahead (chip_smoke.py's `_device_ms`), beside the plan `plan_gn`
picks. These are the readings the planner's cost model (US_PER_KB,
CLUSTER_US) was fitted to. Prints one JSON line per site and direction,
then the card's name and power limit. Exits non-zero when a plan
disagrees or no GPU is present.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _plans(gn, x, bwd):
    """{key: plan} of every plan that fits x, forward or backward."""
    import torch
    b, c = x.shape[:2]
    cl = gn.memory_format_of(x) == torch.channels_last
    plans = {}
    for force in [{"cluster": k} for k in gn.CLUSTERS] + [{"stream": True}]:
        try:
            plan = gn.plan_gn(b, c, x[0, 0].numel(), 32, x.dtype, x.dtype,
                              cl, bwd, card=True, **force)
        except ValueError:
            continue
        plans[f"c{plan.cluster}" + ("_stream" if plan.streaming else "")] = (
            plan)
    return plans


def main() -> int:
    import torch

    from diffusionhandles_tpu_torch.ops import groupnorm as gn

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def rand(shape, scale=1.0, shift=0.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    ok = True
    for c, side, act, eps in cs.GN_SHAPES:
        for b in cs.BATCHES:
            shape = (b, c, side, side)
            x_nchw, dy_nchw = rand(shape, 1.5, 0.5), rand(shape)
            g = (1.0 + 0.1 * rand((c,), dtype=torch.float32)).to(bf16)
            beta = (0.1 * rand((c,), dtype=torch.float32)).to(bf16)
            for layout in cs.GN_LAYOUTS:
                fmt = (torch.channels_last if layout == "channels_last"
                       else torch.contiguous_format)
                x = x_nchw.contiguous(memory_format=fmt)
                dy = dy_nchw.contiguous(memory_format=fmt)
                y_ref, mean, rsig = gn.gn_silu_fwd_ref(x, g, beta, 32, eps,
                                                       act, bf16)
                stats = torch.stack((mean, rsig))
                want = gn.gn_silu_bwd_ref(x, dy, g, beta, mean, rsig, 32,
                                          act)
                for bwd in (False, True):
                    picked = gn.plan_gn(b, c, side * side, 32, bf16, bf16,
                                        layout == "channels_last", bwd,
                                        card=True)
                    times, errs = {}, {}
                    for key, plan in _plans(gn, x, bwd).items():
                        if bwd:
                            def call(plan=plan):
                                return gn._bwd_uv(
                                    x, dy, g, beta, stats[0].data_ptr(),
                                    stats[1].data_ptr(), 32, act,
                                    "gn_silu_bwd", plan)
                            dx, uv = call()
                            pairs = [(dx, want[0]), (uv[0], want[1]),
                                     (uv[1], want[2])]
                        else:
                            def call(plan=plan):
                                return gn._fwd_stats(x, g, beta, 32, eps,
                                                     act, bf16,
                                                     "gn_silu_fwd", plan)
                            y, got = call()
                            pairs = [(y, y_ref), (got, stats)]
                        err_tol = [cs._rel_err(p, q, cs.GN_RTOL)
                                   for p, q in pairs]
                        good = all(e <= t for e, t in err_tol)
                        ok &= good
                        errs[key] = max(e / t for e, t in err_tol if t)
                        times[key] = cs._device_ms(call)
                    print(json.dumps({
                        "shape": list(shape), "act": act, "layout": layout,
                        "direction": "bwd" if bwd else "fwd",
                        "picked": f"c{picked.cluster}" + (
                            "_stream" if picked.streaming else ""),
                        "ms": times, "err_over_tol": errs}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
