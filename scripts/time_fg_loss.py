"""Time the foreground guidance term on the card: the plain expression
(advanced indexing, autograd's index_put backward) against the kernel pair
(`ops/fg_loss.py`), at SD-2's and SDXL's term shapes, on the correspondences
of the benchmark's set-up photo under a few of its `edit` transforms.

    python3 scripts/time_fg_loss.py [--out build/fg_loss_times.json]

Per family and stack width it prints one JSON line: the live slots of each
transform; the whole term (forward and backward to the pooled map, one
call as an edit's guidance iteration makes it) on each route, by CUDA
events over 50 calls, in turns plain, kernel, kernel, plain; each kernel
alone; the device time of the plain route's ATen kernels by name (one
profiled call); and the bound of the kernel pair: f2 read and its gradient
written once, the orig rows and slot fields at the live slots, at
3.35 TB/s. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import traffic  # noqa: E402
from diffusionhandles_tpu_torch import guidance  # noqa: E402
from diffusionhandles_tpu_torch.diffuser import \
    GuidedStableDiffuser  # noqa: E402
from diffusionhandles_tpu_torch.geometry.transform import \
    transform_depth_pc_processed  # noqa: E402
from diffusionhandles_tpu_torch.ops import fg_loss  # noqa: E402

# family: (image side, latent side, recorded stacks' channels)
FAMILIES = {"sd2": (512, 64, (1280, 640, 320)),
            "sdxl": (1024, 128, (1280, 640))}
HBM_BYTES_PER_S = 3.35e12
SEED = 2147483777


def _pcs(res, lat, dev, count=3):
    mix = json.loads((ROOT / "benchmark/traffic/edit.json").read_text())
    photo = traffic.photo(mix, res, SEED, 0)
    out = []
    for k in range(1, count + 1):
        (tr,) = traffic.transforms(mix, SEED, k)
        _, pc = transform_depth_pc_processed(
            photo["depth"], photo["bg_depth"], photo["fg_mask"],
            GuidedStableDiffuser.get_depth_intrinsics(),
            rot_angle=tr["rotation_angle"], rot_axis=tr["rotation_axis"],
            translation=tr["translation"], latent_res=lat, device=dev)
        out.append(pc)
    return out


def _plain(pc, f1g, act):
    """The parent's term: gather, L1, weighted channel sum, and the
    gradient to the pooled map."""
    f2 = act.clone().requires_grad_(True)
    d = (f1g - f2[:, pc.corr_ty, pc.corr_tx].T).abs()
    per = (d * pc.corr_w[:, None]).sum(0) / (pc.corr_w.sum() + guidance.EPS)
    return torch.autograd.grad(per.mean(), f2)[0]


def _kernel(pc, f1s, order, act):
    f2 = act.clone().requires_grad_(True)
    per = fg_loss.fg_l1(f2, f1s, order.cells, order.weights,
                        order.offsets) / (pc.corr_w.sum() + guidance.EPS)
    return torch.autograd.grad(per.mean(), f2)[0]


def _ms(fn, n=50):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _device_ops(fn):
    """Device ms of one call by kernel name, largest first."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    return sorted(rows, key=lambda r: -r[1])[:8]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="build/fg_loss_times.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = []
    for family, (res, lat, widths) in FAMILIES.items():
        pcs = _pcs(res, lat, dev)
        orders = [guidance.fg_slot_order(pc, (lat, lat)) for pc in pcs]
        live = [int(o.offsets[-1]) for o in orders]
        pc, order, n = pcs[0], orders[0], live[0]
        for ch in widths:
            gen = torch.Generator().manual_seed(ch)
            f1, act = (torch.randn(ch, lat, lat, generator=gen).to(dev)
                       for _ in range(2))
            f1g = f1[:, pc.corr_oy, pc.corr_ox].T
            f1s = f1[:, pc.corr_oy[order.slots],
                     pc.corr_ox[order.slots]].contiguous()
            plain = lambda: _plain(pc, f1g, act)  # noqa: E731
            kernel = lambda: _kernel(pc, f1s, order, act)  # noqa: E731
            turns = [_ms(plain), _ms(kernel), _ms(kernel), _ms(plain)]
            f2 = act.clone()
            g = torch.full((ch,), 1.0 / ch, device=dev)
            fwd = _ms(lambda: fg_loss.fg_l1_fwd_cuda(
                f1s, f2, order.cells, order.weights, order.offsets), 200)
            bwd = _ms(lambda: fg_loss.fg_l1_bwd_cuda(
                f1s, f2, order.weights, order.offsets, g), 200)
            nbytes = (2 * ch * lat * lat * 4 + ch * n * 4 + n * 8
                      + (lat * lat + 1) * 4)
            line = dict(
                family=family, channels=ch, latent=lat, max_corr=
                pc.corr_w.numel(), live_slots=live,
                term_ms=dict(plain=[turns[0], turns[3]],
                             kernel=[turns[1], turns[2]]),
                kernel_ms=dict(fg_l1_fwd=fwd, fg_l1_bwd=bwd),
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                plain_device_ms=_device_ops(plain),
                kernel_device_ms=_device_ops(kernel), card=card.strip())
            print(json.dumps(line), flush=True)
            lines.append(line)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
