"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written CUDA kernels from csrc/;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the shapes the U-Net gives it, with errors and median times;
  4. edit: one full 512x512 DiffusionHandles(variant="sd2") edit through
     the four public steps (seeded random weights), with per-step seconds,
     the kernels' launch counts, output checks and peak device memory;
     then the U-Net once with the kernels and once with dense attention on
     the same input, which must agree.
The next-to-last line is a JSON object with one entry per kernel, the last
line the JSON result. Exits non-zero, with no result line, on any failure
or when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# Tolerances of kernel vs plain version, bf16 inputs. The forward rounds p
# to bf16 relative to a running row max where the plain version uses the
# global max, and both round O to bf16: O may differ by ~2 bf16 ulps of its
# largest value. Each side's row sum l is a sum of terms each rounded by at
# most 2**-9 relative, so each l is within 2**-9 of the exact sum and the
# two lse = m + log(l) differ by at most 2 * 2**-9 = 2**-8. The
# backward kernels sum in another order and round ds to bf16 from p
# computed with a fast exp, so an occasional ds differs by one bf16 ulp;
# with the bf16 rounding of the outputs, 2**-6 of the largest gradient.
FWD_O_RTOL = 2.0 ** -7
FWD_LSE_ATOL = 2.0 ** -8
BWD_RTOL = 2.0 ** -6
# U-Net eps with the kernels vs with dense attention, bf16 end to end.
UNET_RTOL = 5e-2

FWD_SHAPES = [(1, 4096, 5, 64), (2, 4096, 5, 64), (1, 1024, 10, 64),
              (2, 1024, 10, 64)]
BWD_SHAPES = [(1, 4096, 5, 64), (1, 1024, 10, 64)]
REPLACES = {
    "flash_fwd": "diffusionhandles_tpu/ops/attention.py:115",
    "flash_bwd": "diffusionhandles_tpu/ops/attention.py:333",
}
SOURCES = {
    "flash_fwd": "diffusionhandles_tpu_torch/csrc/flash_fwd.cu",
    "flash_bwd": "diffusionhandles_tpu_torch/csrc/flash_bwd.cu",
}


def _line(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _median_ms(fn, repeats: int = 10) -> float:
    import torch
    fn()  # warm-up
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _line("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)


def phase_build():
    from diffusionhandles_tpu_torch.ops import attention
    from diffusionhandles_tpu_torch.utils.cuda_build import build_log
    start = time.perf_counter()
    attention.kernel_library()
    seconds = time.perf_counter() - start
    report = [ln.strip() for ln in build_log(
        "flash_attention", attention.KERNEL_SOURCES).splitlines()
        if "registers" in ln or "spill" in ln]
    _line("build", seconds=seconds, ptxas=report)


def phase_kernels():
    """Each kernel vs its plain version at the main path's shapes; returns
    {name: {"max_abs_err", "ms", "plain_ms"}} (worst error over shapes,
    times at the first, largest-token shape)."""
    import torch

    from diffusionhandles_tpu_torch.ops import attention as att
    gen = torch.Generator(device="cpu").manual_seed(0)
    results = {}

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            "cuda", torch.bfloat16)

    for shape in FWD_SHAPES:
        q, k, v = rand(shape, 1.5), rand(shape, 1.5), rand(shape)
        o, lse = att.flash_fwd_cuda(q, k, v)
        o_ref, lse_ref = att.flash_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        tol_o = FWD_O_RTOL * o_ref.float().abs().max().item()
        ms = _median_ms(lambda: att.flash_fwd_cuda(q, k, v))
        plain_ms = _median_ms(lambda: att.flash_fwd_ref(q, k, v))
        ok = err_o <= tol_o and err_l <= FWD_LSE_ATOL
        _line("kernel", name="flash_fwd", shape=list(shape),
              max_abs_err_o=err_o, tol_o=tol_o, max_abs_err_lse=err_l,
              tol_lse=FWD_LSE_ATOL, ms=ms, plain_ms=plain_ms, ok=ok)
        if not ok:
            raise AssertionError(f"flash_fwd disagrees at {shape}")
        entry = results.setdefault("flash_fwd", {"max_abs_err": 0.0,
                                                 "ms": ms,
                                                 "plain_ms": plain_ms})
        entry["max_abs_err"] = max(entry["max_abs_err"], err_o, err_l)

    for shape in BWD_SHAPES:
        q, k, v = rand(shape, 1.5), rand(shape, 1.5), rand(shape)
        do = rand(shape)
        o, lse = att.flash_fwd_ref(q, k, v)
        got = att.flash_bwd_cuda(q, k, v, o, lse, do)
        want = att.flash_bwd_ref(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        errs, tols = [], []
        for g_, w_ in zip(got, want):
            errs.append((g_.float() - w_.float()).abs().max().item())
            tols.append(BWD_RTOL * w_.float().abs().max().item())
        ms = _median_ms(lambda: att.flash_bwd_cuda(q, k, v, o, lse, do))
        plain_ms = _median_ms(lambda: att.flash_bwd_ref(q, k, v, o, lse, do))
        ok = all(e <= t for e, t in zip(errs, tols))
        _line("kernel", name="flash_bwd", shape=list(shape),
              max_abs_err_dq_dk_dv=errs, tol=tols, ms=ms, plain_ms=plain_ms,
              ok=ok)
        if not ok:
            raise AssertionError(f"flash_bwd disagrees at {shape}")
        entry = results.setdefault("flash_bwd", {"max_abs_err": 0.0,
                                                 "ms": ms,
                                                 "plain_ms": plain_ms})
        entry["max_abs_err"] = max(entry["max_abs_err"], *errs)
    return results


def _sample(res: int = 512, seed: int = 0):
    """A box foreground in front of a sloped background depth, and a
    seeded random image (NCHW numpy)."""
    import numpy as np
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    depth = (2.0 + 0.01 * yy).astype(np.float32)
    fg = ((yy >= res // 3) & (yy < 2 * res // 3)
          & (xx >= res // 3) & (xx < 2 * res // 3))
    depth_fg = depth.copy()
    depth_fg[fg] -= 0.4
    img = np.random.RandomState(seed).rand(1, 3, res, res).astype(np.float32)
    return dict(img=img, depth=depth_fg[None, None],
                bg_depth=depth[None, None],
                fg_mask=fg.astype(np.float32)[None, None])


def phase_edit(num_timesteps: int = 50):
    """One full edit through the four public steps; returns the kernels'
    launch counts of that run."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.config import DiffusionHandlesConfig
    from diffusionhandles_tpu_torch.ops import attention
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles

    conf = DiffusionHandlesConfig()
    conf.guided_diffuser.num_timesteps = num_timesteps
    start = time.perf_counter()
    handles = DiffusionHandles(conf, variant="sd2", device="cuda")
    torch.cuda.synchronize()
    _line("edit_setup", seconds=time.perf_counter() - start,
          num_timesteps=num_timesteps, image_res=handles.img_res)
    sample = _sample(handles.img_res)
    prompt = "a toy cube on a table"

    torch.cuda.reset_peak_memory_stats()
    attention.reset_launch_counts()
    steps = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t0
        return out

    null, noise = timed(
        "invert_input_image", lambda: handles.invert_input_image(
            sample["img"], sample["depth"], prompt))
    null, noise, acts, latents = timed(
        "generate_input_image", lambda: handles.generate_input_image(
            sample["depth"], prompt, null, noise))
    bg = timed("set_foreground", lambda: handles.set_foreground(
        sample["depth"], sample["fg_mask"], sample["bg_depth"]))
    edited, disparity = timed(
        "transform_foreground", lambda: handles.transform_foreground(
            depth=sample["depth"], prompt=prompt, fg_mask=sample["fg_mask"],
            bg_depth=bg, null_text_emb=null, init_noise=noise,
            activations=acts, rot_angle=20.0, rot_axis=[0.0, 1.0, 0.0],
            translation=[0.0, 0.0, 0.1]))
    launches = dict(attention.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    res = handles.img_res
    edited = np.asarray(edited)
    disparity = np.asarray(disparity)
    checks = {
        "edited_shape": list(edited.shape) == [1, 3, res, res],
        "disparity_shape": list(disparity.shape) == [1, 1, res, res],
        "edited_finite": bool(np.isfinite(edited).all()),
        "disparity_finite": bool(np.isfinite(disparity).all()),
        "edited_in_0_1": bool(edited.min() >= 0.0 and edited.max() <= 1.0),
        "activations_finite": all(bool(torch.isfinite(torch.as_tensor(
            a)).all()) for a in acts),
        "kernels_launched": all(n > 0 for n in launches.values()),
    }
    _line("edit", seconds=steps, total_seconds=sum(steps.values()),
          launches=launches, peak_bytes=peak, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"edit checks failed: {checks}")
    return handles, launches


def phase_unet_reference(handles):
    """The sd2 U-Net on one input with the kernels, then with dense
    attention: eps must agree (bf16 end to end)."""
    import torch

    from diffusionhandles_tpu_torch.models.unet import Attention
    unet = handles.diffuser.models.unet
    attns = [m for m in unet.modules() if isinstance(m, Attention)]
    gen = torch.Generator(device="cpu").manual_seed(1)
    res = handles.diffuser.latent_res
    x = torch.randn((1, unet.config.in_channels, res, res),
                    generator=gen).to("cuda")
    ctx = torch.randn((1, 77, unet.config.cross_attention_dim),
                      generator=gen).to("cuda")
    t = torch.tensor([500], device="cuda")
    with torch.no_grad():
        eps_k = unet(x, t, ctx)[0].float()
        for m in attns:
            m.use_flash = False
        eps_d = unet(x, t, ctx)[0].float()
        for m in attns:
            m.use_flash = True
    err = (eps_k - eps_d).abs().max().item()
    tol = UNET_RTOL * eps_d.abs().max().item()
    ok = bool(torch.isfinite(eps_k).all()) and err <= tol
    _line("unet_reference", max_abs_err=err, tol=tol, ok=ok)
    if not ok:
        raise AssertionError("U-Net with kernels disagrees with dense")


def main() -> int:
    try:
        import torch

        # the port itself first: without the repo around the script this
        # fails before any phase prints
        import diffusionhandles_tpu_torch.pipeline  # noqa: F401
        phase_device()
        phase_build()
        kernels = phase_kernels()
        handles, launches = phase_edit()
        phase_unet_reference(handles)
    except Exception as exc:  # report and fail, with no result line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"]}
        for name in ("flash_fwd", "flash_bwd")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
