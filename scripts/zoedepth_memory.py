"""Which modules of ZoeDepth-NK (and big-LaMa) take the device memory, on
one NVIDIA GPU.

    python3 scripts/zoedepth_memory.py

Builds ZoeDepthEstimator and LamaInpainter at their release widths with
seeded weights (fp32, TF32 off), runs one ZoeDepth-NK pass at 384 with the
flip batch of 2 and one big-LaMa pass at 512x512, and prints, per leaf
module, the peak bytes allocated while it ran above the bytes allocated
when it started (activations, temporaries and cuDNN workspace), the ten
largest of each model, and each model's whole peak. Prints the card's name
and power limit, then JSON lines; needs CUDA.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from diffusionhandles_tpu_torch.models.lama import LamaInpainter  # noqa
from diffusionhandles_tpu_torch.models.zoedepth import \
    ZoeDepthEstimator  # noqa: E402


def module_peaks(model: torch.nn.Module, run) -> dict:
    """Run `run()` once with hooks on every leaf module of `model`."""
    peaks, start = {}, {}

    def pre(name):
        def hook(_m, _a):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start[name] = torch.cuda.memory_allocated()
        return hook

    def post(name):
        def hook(_m, _a, _o):
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - start[name]
            peaks[name] = max(peaks.get(name, 0), extra)
        return hook

    handles = []
    for name, mod in model.named_modules():
        if not list(mod.children()):
            handles += [mod.register_forward_pre_hook(pre(name)),
                        mod.register_forward_hook(post(name))]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return peaks


def whole_peak(run) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with torch.no_grad():
        run()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - before


def main() -> int:
    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    img = np.random.RandomState(0).rand(1, 3, 512, 512).astype(np.float32)
    mask = np.zeros((1, 1, 512, 512), np.float32)
    mask[..., 170:341, 170:341] = 1.0
    zoe = ZoeDepthEstimator(device="cuda")
    lama = LamaInpainter(device="cuda")
    x = torch.from_numpy(img).cuda()
    runs = {"zoedepth": (zoe.model, lambda: zoe.model(x)),
            "lama": (lama.model,
                     lambda: lama.remove_foreground(img, mask, dilation=3))}
    for name, (model, run) in runs.items():
        with torch.no_grad():
            run()  # first use
        whole = whole_peak(run)
        peaks = module_peaks(model, run)
        top = sorted(peaks.items(), key=lambda kv: -kv[1])[:10]
        print(json.dumps({"model": name, "peak_bytes": whole,
                          "largest_modules": [
                              {"module": k, "peak_bytes": v,
                               "type": type(model.get_submodule(k)).__name__}
                              for k, v in top]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
