"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the hand-written CUDA kernels from csrc/ (one nvcc per
     source, all started together);
  3. kernels: each kernel route against its plain PyTorch version on the
     card, at every shape the 512x512 U-Net gives it (the attention routes
     also at one query length != key length, and on q, k, v sliced from
     one [B, S, 3, H, D] tensor), with errors, device times (CUDA events,
     the device kept ahead of the host), the plain version's and, where one
     PyTorch call computes the same function, that call's time, and the
     card's bound; for the attention kernels also back-to-back host-clock
     times of the kernel and SDPA, a check that a second backward call
     gives the same bits, and those times summed over the U-Net's ten
     self-attention sites (flash_per_unet); for the conv kernel (K7) also
     each site's plan, its and cuDNN's back-to-back host-clock times per
     call, those times summed over the 47 convs of one U-Net forward, and a
     check at two ragged shapes; for the GroupNorm kernels (K8, K9) also
     back-to-back times beside F.group_norm's and the unfused default
     path's, and their plans; K8 on channels-last and NCHW x, with a check
     that a second call gives the same bits and nothing is copied into
     another layout; K1 and K2 also at the batched edit's shapes (B 4 and
     8), where two equal rows must give equal bits;
  4. edit: one 512x512 DiffusionHandles(variant="sd2") edit through the four
     public steps with the default U-Net (seeded random weights),
     EDIT_TIMESTEPS timesteps, with per-step seconds, the kernels' launch
     counts, output checks and peak device memory;
  4a. edit_paths: on those handles, transform_foreground with
     save_denoising_steps (T decoded step pairs; the final image bitwise
     the flag-off run's), the packed [N, 4] host correspondence path
     against the device binning (the same slots, the same image), and the
     mesh-mode transform (seconds, peak memory, big faces; held to the
     port on the CPU within MESH_*) and edit;
  4b. edit_batched: edit_batch on those handles, one transform at batch
     1 (bitwise the single edit), then 3 transforms (two identical) in a
     chunk of 4 with remat off and 'dots': seconds per edit beside the
     single edit's, peak memory, K1/K2 launches (remat reruns the
     guidance forward); twin rows bitwise, with cuDNN on; rows against
     the single edit and remat against off within the distance a
     rounding-level nudge gives (BATCH_*); and a batch-4 U-Net with twin
     rows bitwise, cuDNN off, and with conv_per_image (the batched edit's
     route), cuDNN on;
  4f. unet_conv_modes (after 4b, on the default handles): one guidance
     forward + backward of that U-Net at 512x512 with each
     UNetConfig.conv3x3_kernel value (False, True, 'hybrid', 'mixed') on
     its weights: eps and the latents' gradient against the default's,
     K7's forward and dx launches of the call (conv 47 / 47, hybrid 0 /
     47, mixed 47 / 0), no general route, the median device ms;
  4g. multi_gpu: a world of one over NCCL joined in this process under the
     env contract (DIFFHANDLES_COORDINATOR, ...), edit_batch of 4b's
     transforms with mesh=make_mesh(1) bitwise the mesh=None images;
     then TP_RANKS_ON_CARD ranks spawned over gloo on this card, the sd2
     U-Net sharded over a model axis of 2 (parallel/sharding.py): one
     guidance forward + backward in fp32 (TF32 off) against the
     replicated U-Net in the bands of tests/test_tensor_parallel.py, one
     with bf16 compute within UNET_RTOL, each rank's parameter bytes,
     replicated attentions and K1/K2 launches; the process groups are
     destroyed after; and the number of cards;
  4c. testset: the test-set path at full width on seeded inputs at 512x512
     written with the port's image_io: ZoeDepthEstimator (ZoeDepth-NK,
     BEiT-L-384, the flip batch of 2) and LamaInpainter (big-LaMa), each
     with its seconds and peak memory, held to the same port model on the
     CPU on the same weights (ZoeDepth: the same domain per pass and
     ZOE_DEPTH_RTOL of max_depth, with the domain probabilities and the
     share of pixels at a clip bound; LaMa: LAMA_ATOL, known pixels
     bitwise the input); preprocess.estimate_depth through the port's EXR;
     then test_diffusion_handles over one sample with two transforms on
     those handles, with both estimators and the identity cache, twice:
     the second run reads the cache and writes the first run's images bit
     for bit; K1 and K2 launch; the per-sample seconds split, the recon
     PSNR/SSIM (seeded weights: not fidelity figures), and the identity
     npz loaded back equal to the tensors the inversion made;
  4e. service (after 4c, on the default handles): the five services of
     diffusionhandles_tpu_torch.service in this process on free loopback
     ports (the core on the default handles, depth on 4c's ZoeDepth-NK,
     the remover on its big-LaMa, the selector on a seeded CLIPSegmenter
     at ViT-B/16 widths, text2img on a seeded TEXT2IMG_STEPS-step SD-2),
     driven over HTTP by DiffhandlesPipeline on the test-set sample:
     set_input_image, set_foreground from the selector and then from the
     mask, the core's set_foreground with export_meshes,
     transform_foreground (K1 and K2 counted in that request alone), the
     depth and rgb previews, and a text2img generate. Every response must
     be bitwise the same call made in the process on the same objects,
     and the identity npz must load to the request's inversion tensors;
     per request, the wall seconds split into the handler's and the
     encode + transport + decode rest, and the body bytes; the previews'
     seconds and the peak memory. Then rasterize_k (K = SOFT_K, softmax
     blending) on the rgb preview's 512x512 scene, timed with its peak and
     held to the port on the CPU (differing fragments counted against
     SOFT_FID_SHARE), and LPIPS at 512x512 held to the CPU (LPIPS_RTOL);
  4d. foreground (after 6, with the edit's models freed): the text-prompted
     foreground path and text2img on seeded weights at release widths, fp32
     with TF32 off but text2img, on the test-set sample: CLIPSegmenter at
     clip_vit_b16() widths (the similarity map and mask), SAM ViT-H at 1024
     (embed and a box-prompted decode, each timed with its peak memory;
     the predictor's mask and IoU), GroundingDinoGrounder (Swin-T OGC, 512
     input: logits, boxes, the 900 selected proposals, predict_boxes), each
     held to the same model on the CPU (FG_*); then estimate_foreground
     through LangSamSegmenter(grounder, SAM) writing a mask.png, and
     StableText2Img on SD-2 at 512x512, bf16, TEXT2IMG_STEPS steps: finite,
     repeatable bitwise, K1 launched at each of the U-Net's ten
     self-attention sites per call and no general route;
  5. unet_reference: that U-Net once with the flash kernels and once with
     dense attention on the same input, which must agree;
  6. unet_flash_bwd_modes: that U-Net forward + backward to the latents with
     DIFFHANDLES_FLASH_BWD unset, "twopass" and "fold": each launches its
     own backward route (K2, K3, K6), and the gradients agree;
  7. attention_forward_entries: the forward-only entries at the U-Net's
     attention shapes, flash_attention (K1), flash_attention with a short
     block_k (K4) and flash_fwd_impl(fold=False) (K5), against dense
     attention;
  8. edit_fused: the same edit, FUSED_EDIT_TIMESTEPS timesteps, through the
     U-Net with the fused GroupNorm kernels (UNetConfig.fused_gn_conv and
     fused_gn) on the same seeded weights; all six kernels must launch, and
     K8's wrappers copy no input into another layout;
  9. unet_fused_reference: the fused U-Net and a default one with the same
     weights on one input: eps and the gradient to the latents must agree;
 10. edit_conv: the EDIT_TIMESTEPS edit through the U-Net whose resnet and
     upsampler convs take the conv kernel (UNetConfig.conv3x3_kernel), on
     the same seeded weights: K7 launches once per eligible conv per U-Net
     call;
 11. unet_conv_reference: that U-Net against a default one, as in 9;
 12. fp32_routes: the default U-Net of GuidedDiffuserConfig(dtype=
     "float32") (flash on), then the fused and conv U-Nets on its weights,
     one 512x512 forward and backward to the latents each (the default one
     also with DIFFHANDLES_FLASH_BWD "twopass" and "fold"), then the
     three U-Nets in fp16, one forward each: no call raises; in fp32 every
     kernel op on the path runs its general route on the card, counted
     (`<kernel>_general`: the general kernels, csrc/flash_general.cu and
     conv_general.cu, and the fp32 instances of gn.cu and gn_conv.cu), and
     no Hopper kernel launches; in fp16 the flash, conv and fused kernels
     run their fp16 instances and K8 its general one; eps and the gradient
     agree with the fp32 default U-Net's.
The bf16 paths (4, 6, 7, 8, 10) must run no general route; the fused edit
holds K9's and K8's launches to their sites per U-Net call, as the conv
edit holds K7's. The kernels phase also checks the Hopper kernels' fp16
instances and every general route against its plain version (fp32, timed,
at a U-Net site; fp16; bf16 at a head dim or channel count the Hopper
kernels are not built for; the flash routes also fp32 at head dim 160),
the fp32 flash routes within the fp32 tolerance their 3xTF32 products
meet (F32_O_RTOL), with back-to-back times of kernel and SDPA, also
timed at head dim 80 in fp32 and bf16 (two head-dim chunks), the fp32
bound the smaller of the CUDA cores' time and three TF32 passes on the
tensor cores (the CUDA cores' kept as `bound_fp32_cores_ms`), and the
forward entries (7) run once more in fp32, on the general kernels.
Each edit runs with only its own models on the card, so that its peak
memory is its own. Each path's launch counts are set to 0 just before it
and read just after.
The next-to-last line is a JSON object with one entry per kernel, the last
line the JSON result. Exits non-zero, with no result line, on any failure
or when no CUDA device is present. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

# Timesteps of the two edits: the default U-Net's edit is cut to keep the
# run short; the fused edit runs the configuration's full 50.
EDIT_TIMESTEPS = 10
FUSED_EDIT_TIMESTEPS = 50

# Tolerances of kernel vs plain version, bf16 inputs. The forward rounds p
# to bf16 relative to a running row max where the plain version uses the
# global max (K1, K5) or the max of block_k chunks (K4), and both round O
# to bf16: O may differ by ~2 bf16 ulps of its largest value. For K1 each
# side's row sum l is a sum of terms each rounded by at most 2**-9
# relative, so each l is within 2**-9 of the exact sum and the two
# lse = m + log(l) differ by at most 2 * 2**-9 = 2**-8. For K4 and K5 both
# sides sum fp32 p: they differ by fp32 summation order, the fast exp and
# the online rescale, ~1e-6 relative, so lse to 2**-12 (which K1's bf16 sum,
# 6e-4-1e-3 away, would fail). The backward kernels sum in another order
# and round ds to bf16 from p computed with a fast exp, so an occasional ds
# differs by one bf16 ulp; with the bf16 rounding of the outputs, 2**-6 of
# the largest gradient (K2, K3, K6 alike).
FWD_O_RTOL = 2.0 ** -7
FWD_LSE_ATOL = 2.0 ** -8
FWD_F32_LSE_ATOL = 2.0 ** -12
BWD_RTOL = 2.0 ** -6
# The fp32 general flash routes against their plain versions (fp32, full
# fp32 products): the kernels multiply on the tensor cores as 3xTF32 (x =
# hi + lo, both tf32, each product lo.hi' + hi.lo' + hi.hi' in fp32),
# which drops below 2**-21 of a product; a logit (40-160 products, q
# pre-scaled) moves by < 2**-17, p and lse by as much, O and the gradients
# by ~2**-17 of their largest value. 2**-14 leaves 8x, and one TF32 pass
# (2**-11 a product) misses it: lse by ~2**-11, the gradients through
# dp by ~2**-11 of their largest value (tests/test_torch_flash_tf32_recipe.py,
# where the emulated recipes land at <= 0.07x and >= 12x of it).
F32_O_RTOL = 2.0 ** -14
F32_LSE_ATOL = 2.0 ** -14
F32_BWD_RTOL = 2.0 ** -14
# The fp32 general conv routes (K7 general, and K9 general through its
# GEMM) against their plain versions: 3xTF32 products too, each within
# 2**-21, so an output (a sum of 9 * Ci of them) lands ~2**-21 of the
# largest value away; one TF32 pass lands ~2**-12 away and misses 2**-14
# (tests/test_torch_conv_tf32_recipe.py: the emulated recipe at
# 0.007-0.010x of it, one TF32 pass at 4.7-5.1x, at K up to 11520).
F32_CONV_RTOL = 2.0 ** -14
# The forward-only entries against dense attention, which rounds the
# normalized probabilities to bf16 where the kernels round the unnormalized
# p: O may differ by a few bf16 ulps (2**-8) of its largest value.
ENTRY_RTOL = 2.0 ** -6
# The GroupNorm kernels follow their plain versions' recipe step for step:
# the same fp32 values, summed in another order, with SiLU through another
# exp, are rounded once to bf16, so an element may land one bf16 ulp
# (2**-8 relative) away; 2**-7 of the largest value bounds that. The fused
# conv adds fp32 tap sums in another order before its one rounding, as
# does the plain conv (K7).
GN_RTOL = 2.0 ** -7
# U-Net eps (and its gradient) with the kernels vs without, bf16 end to
# end: the two differ in rounding points at every layer.
UNET_RTOL = 5e-2

# Clock cycles of the sleep that _device_ms queues before a timed window
# (~5 ms at an H100's SM clock), and the longest it stretches that sleep
# to when the host's enqueue of a window outlasts it.
DEVICE_AHEAD_CYCLES = 10_000_000
MAX_AHEAD_CYCLES = 40 * DEVICE_AHEAD_CYCLES

# The card's published peaks (H100 SXM, dense): bf16 tensor cores, fp32
# outside them, TF32 tensor cores, device memory.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12

FWD_SHAPES = [(1, 4096, 5, 64), (2, 4096, 5, 64), (1, 1024, 10, 64),
              (2, 1024, 10, 64)]
BWD_SHAPES = [(1, 4096, 5, 64), (1, 1024, 10, 64)]
# K1 and K2 at the batched edit's shapes: its guidance runs a batch-4
# U-Net forward + backward (3 transforms in a chunk of 4), its CFG step a
# batch-8 forward
BATCHED_FWD_SHAPES = [(4, 4096, 5, 64), (4, 1024, 10, 64),
                      (8, 4096, 5, 64), (8, 1024, 10, 64)]
BATCHED_BWD_SHAPES = [(4, 4096, 5, 64), (4, 1024, 10, 64)]
# one query length != key length (ragged 64-row tiles): (B, Sq, Sk, H, D)
CROSS_SHAPE = (2, 1000, 4096, 5, 64)
# K4's chunk of keys in the kernels phase and the forward-entries path
STREAM_BLOCK_K = 512
# GroupNorm sites at 512x512: (channels, side, SiLU, eps) of the 16
# transformer norms, then conv_norm_out
GN_SHAPES = [(320, 64, False, 1e-6), (640, 32, False, 1e-6),
             (1280, 16, False, 1e-6), (1280, 8, False, 1e-6),
             (320, 64, True, 1e-5)]
# resnet halves that take the fused kernel at 512x512: (side, Ci, Co)
CONV_SHAPES = [(64, 320, 320), (32, 320, 640), (32, 640, 640),
               (32, 960, 640), (32, 1280, 640), (16, 640, 1280),
               (16, 1280, 1280), (8, 1280, 1280)]
# the 16 distinct 3x3 convs of the conv3x3_kernel U-Net at 512x512 (44
# resnet halves and 3 upsamplers, all eligible): (side, Ci, Co) -> how many
# of the 47 convs of one U-Net forward have that shape
CONV3_SITE_COUNTS = {
    (64, 320, 320): 7, (64, 640, 320): 2, (64, 640, 640): 1,
    (64, 960, 320): 1, (32, 320, 640): 1, (32, 640, 640): 6,
    (32, 960, 640): 1, (32, 1280, 640): 1, (32, 1280, 1280): 1,
    (32, 1920, 640): 1, (16, 640, 1280): 1, (16, 1280, 1280): 7,
    (16, 1920, 1280): 1, (16, 2560, 1280): 2, (8, 1280, 1280): 11,
    (8, 2560, 1280): 3}
# K7 at ragged pixel boxes and channel tiles (checked, not part of the
# U-Net's sums): (side, Ci, Co)
CONV3_RAGGED_SHAPES = [(12, 48, 80), (5, 64, 96)]
BATCHES = (1, 2)
# K8's two layouts: channels-last (the fused U-Net's) first, then NCHW
GN_LAYOUTS = ("channels_last", "nchw")

KERNELS = {
    "flash_fwd": ("diffusionhandles_tpu_torch/csrc/flash_fwd.cu",
                  "diffusionhandles_tpu/ops/attention.py:115"),
    "flash_bwd": ("diffusionhandles_tpu_torch/csrc/flash_bwd.cu",
                  "diffusionhandles_tpu/ops/attention.py:333"),
    "gn_silu_fwd": ("diffusionhandles_tpu_torch/csrc/gn.cu",
                    "diffusionhandles_tpu/ops/groupnorm.py:64"),
    "gn_silu_bwd": ("diffusionhandles_tpu_torch/csrc/gn.cu",
                    "diffusionhandles_tpu/ops/groupnorm.py:117"),
    "gn_silu_conv3x3_fwd": ("diffusionhandles_tpu_torch/csrc/gn_conv.cu",
                            "diffusionhandles_tpu/ops/gn_conv.py:94"),
    "gn_silu_conv3x3_dx": ("diffusionhandles_tpu_torch/csrc/gn_conv.cu",
                           "diffusionhandles_tpu/ops/gn_conv.py:121"),
    "flash_fwd_unfolded": ("diffusionhandles_tpu_torch/csrc/flash_fwd.cu",
                           "diffusionhandles_tpu/ops/attention.py:136"),
    "flash_fwd_stream": ("diffusionhandles_tpu_torch/csrc/flash_fwd.cu",
                         "diffusionhandles_tpu/ops/attention.py:80"),
    "flash_bwd_twopass": ("diffusionhandles_tpu_torch/csrc/flash_bwd.cu",
                          "diffusionhandles_tpu/ops/attention.py:282"),
    "flash_bwd_fold": ("diffusionhandles_tpu_torch/csrc/flash_bwd.cu",
                       "diffusionhandles_tpu/ops/attention.py:375"),
    "conv3x3_fwd": ("diffusionhandles_tpu_torch/csrc/conv.cu",
                    "diffusionhandles_tpu/ops/conv.py:35"),
    "conv3x3_dx": ("diffusionhandles_tpu_torch/csrc/conv.cu",
                   "diffusionhandles_tpu/ops/conv.py:35"),
}
# The general route of each kernel (`<name>_general`): fp32, fp16 and the
# shapes the Hopper kernels are not built for, through the general kernels
GENERAL_SOURCES = {
    "flash_fwd": "flash_general.cu", "flash_fwd_unfolded": "flash_general.cu",
    "flash_fwd_stream": "flash_general.cu",
    "flash_bwd": "flash_general_bwd.cu",
    "flash_bwd_twopass": "flash_general_bwd.cu",
    "flash_bwd_fold": "flash_general_bwd.cu", "conv3x3_fwd": "conv_general.cu",
    "conv3x3_dx": "conv_general.cu", "gn_silu_fwd": "gn.cu",
    "gn_silu_bwd": "gn.cu", "gn_silu_conv3x3_fwd": "gn_conv.cu",
    "gn_silu_conv3x3_dx": "gn_conv.cu"}
KERNELS.update({
    f"{name}_general": (f"diffusionhandles_tpu_torch/csrc/{src}",
                        KERNELS[name][1])
    for name, src in GENERAL_SOURCES.items()})
BWD_MODES = {None: "flash_bwd", "twopass": "flash_bwd_twopass",
             "fold": "flash_bwd_fold"}


def _line(phase: str, **fields) -> None:
    host_bound = [k for k, v in fields.items()
                  if getattr(v, "host_bound", False)]
    if host_bound:
        fields["host_bound"] = host_bound
    print(json.dumps({"phase": phase, **fields}), flush=True)


class _Ms(float):
    """A device time in ms. `host_bound`: even behind the longest sleep,
    the host took longer to enqueue the timed calls than the sleep lasted,
    so the reading includes time the device waited for the host."""
    host_bound = False


def _device_ms(fn, repeats: int = 20, windows: int = 3) -> _Ms:
    """Device ms of one call: the median over `windows` timed windows, each
    CUDA events around `repeats` calls, after a warm-up call. A device-side
    sleep queued before each window keeps the card busy while the host
    enqueues the calls, so that a call shorter than its host-side launch
    cost is timed by the device, not by the host. The host's enqueue time
    (its clock, from before the sleep's launch) is held to the sleep's
    device time: where it is longer, the device may have waited, and the
    window is timed again behind a sleep stretched to twice the enqueue
    time, up to MAX_AHEAD_CYCLES. The median drops a window that a stall
    of the card inflates."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles, times, host_bound = DEVICE_AHEAD_CYCLES, [], False
    for _ in range(windows):
        while True:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            t0 = time.perf_counter()
            ev[0].record()
            torch.cuda._sleep(cycles)
            ev[1].record()
            for _ in range(repeats):
                fn()
            ev[2].record()
            enqueue_ms = (time.perf_counter() - t0) * 1e3
            ev[2].synchronize()
            sleep_ms = ev[0].elapsed_time(ev[1])
            if enqueue_ms < sleep_ms or cycles >= MAX_AHEAD_CYCLES:
                break
            cycles = min(MAX_AHEAD_CYCLES,
                         int(cycles * 2 * enqueue_ms / sleep_ms) + 1)
        host_bound |= enqueue_ms >= sleep_ms
        times.append(ev[1].elapsed_time(ev[2]) / repeats)
    ms = _Ms(sorted(times)[len(times) // 2])
    ms.host_bound = host_bound
    return ms


def _wall_ms(fn, repeats: int = 20, windows: int = 3) -> float:
    """Host-clock ms of one call issued back to back with the others, from
    an idle device to the last call's end: what a caller pays per call
    when the host's launch cost, not the device, sets the pace. The median
    over `windows`."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / repeats)
    return sorted(times)[len(times) // 2]


def _bound(flops: float, nbytes: float, peak: float):
    """(ms, "operations" | "bytes"): the least time for the work on this
    card, the larger of flops over the peak rate and bytes over the memory
    rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _kernel_modules():
    from diffusionhandles_tpu_torch.ops import (attention, conv, gn_conv,
                                                groupnorm)
    return attention, groupnorm, gn_conv, conv


def reset_launch_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    counts = {}
    for mod in _kernel_modules():
        counts.update(mod.LAUNCHES)
    return counts


def layout_copies() -> dict:
    """Inputs K8's (`gn`) and K9's (`gn_conv`) wrappers copied into their
    kernels' layouts so far."""
    _, gn, gc, _ = _kernel_modules()
    return {**gn.LAYOUT_COPIES, **gc.LAYOUT_COPIES}


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
    from diffusionhandles_tpu_torch.utils.cuda_build import build_log
    attention, groupnorm, _, conv = _kernel_modules()
    libs = (("flash_attention", attention), ("groupnorm", groupnorm),
            ("conv3x3", conv))
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(mod.kernel_library) for _, mod in libs]:
            fut.result()
    seconds = time.perf_counter() - start
    report = []
    for name, mod in libs:
        report += [ln.strip() for ln in build_log(
            name, mod.KERNEL_SOURCES).splitlines()
            if "registers" in ln or "spill" in ln]
    _line("build", seconds=seconds, ptxas=report)


class _Results:
    """Per kernel: the worst error over its shapes, and the times and bound
    at its first (largest) shape."""

    def __init__(self):
        self.rows = {}

    def add(self, name, err, ms, plain_ms, bound, library_ms=None):
        row = self.rows.get(name)
        if row is None:
            self.rows[name] = {"max_abs_err": err, "ms": ms,
                               "plain_ms": plain_ms, "bound_ms": bound[0],
                               "bound_by": bound[1],
                               "library_ms": library_ms}
        else:
            row["max_abs_err"] = max(row["max_abs_err"], err)


def _check(name, shape, errs, tols, **fields):
    ok = all(e <= t for e, t in zip(errs, tols))
    _line("kernel", name=name, shape=list(shape), max_abs_err=errs, tol=tols,
          ok=ok, **fields)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{shape}")


def _rel_err(got, want, rtol):
    err = (got.float() - want.float()).abs().max().item()
    return err, rtol * want.float().abs().max().item()


def _qkv(rand, b, sq, sk, h, d):
    return (rand((b, sq, h, d), 1.5), rand((b, sk, h, d), 1.5),
            rand((b, sk, h, d)))


def _qkv_strided(rand, b, s, h, d):
    """q, k, v as the slices [:, :, i] of one [B, S, 3, H, D] tensor (a
    fused projection's layout): read in place, strides 3*H*D apart."""
    qkv = rand((b, s, 3, h, d))
    qkv[:, :, :2] *= 1.5  # q and k at _qkv's scale
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


# The U-Net's ten self-attention sites per call: five at 64x64 latents
# (4096 tokens, 5 heads) and five at 32x32 (1024 tokens, 10 heads).
FLASH_SITES = {(4096, 5, 64): 5, (1024, 10, 64): 5}


def _flash_site(b, sq, sk, h, d):
    """The U-Net site key of a self-attention shape, or None."""
    return (b, sq, h, d) if sq == sk and (sq, h, d) in FLASH_SITES else None


def _kernels_flash_fwd(res, rand, per_site):
    """K1, K5 and K4 against their plain versions; SDPA is the library
    call of all three. Device and back-to-back host-clock times of K1 and
    SDPA at the U-Net's sites go to `per_site`. Then each route on q, k, v
    sliced from one [B, S, 3, H, D] tensor, read in place (no layout copy)
    and held to its plain version."""
    import torch
    import torch.nn.functional as F
    att = _kernel_modules()[0]
    routes = [
        ("flash_fwd", att.flash_fwd_cuda, att.flash_fwd_ref, FWD_LSE_ATOL),
        ("flash_fwd_unfolded", att.flash_fwd_unfolded_cuda,
         att.flash_fwd_unfolded_ref, FWD_F32_LSE_ATOL),
        ("flash_fwd_stream",
         att.flash_fwd_stream_cuda,
         lambda q, k, v: att.flash_fwd_stream_ref(q, k, v, STREAM_BLOCK_K),
         FWD_F32_LSE_ATOL)]
    shapes = [(b, s, s, h, d) for b, s, h, d in FWD_SHAPES] + [CROSS_SHAPE]
    for b, sq, sk, h, d in shapes:
        q, k, v = _qkv(rand, b, sq, sk, h, d)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt)

        lib_ms, lib_wall_ms = _device_ms(sdpa), _wall_ms(sdpa)
        bound = _bound(4.0 * b * h * sq * sk * d,
                       (2 * sq + 2 * sk) * b * h * d * 2 + b * h * sq * 4,
                       PEAK_BF16)
        plan = att.plan_flash(b, h, sq, sk)
        for name, kernel, plain, lse_tol in routes:
            o, lse = kernel(q, k, v)
            o_ref, lse_ref = plain(q, k, v)
            torch.cuda.synchronize()
            err_o, tol_o = _rel_err(o, o_ref, FWD_O_RTOL)
            err_l = (lse - lse_ref).abs().max().item()
            ms = _device_ms(lambda: kernel(q, k, v))
            wall_ms = _wall_ms(lambda: kernel(q, k, v))
            plain_ms = _device_ms(lambda: plain(q, k, v))
            _check(name, (b, sq, sk, h, d), [err_o, err_l], [tol_o, lse_tol],
                   ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   wall_ms=wall_ms, library_wall_ms=lib_wall_ms,
                   bound_ms=bound[0],
                   plan={"warpgroups": plan.warpgroups,
                         "block_n": plan.block_n, "grid": plan.grid})
            res.add(name, max(err_o, err_l), ms, plain_ms, bound, lib_ms)
            site = _flash_site(b, sq, sk, h, d)
            if name == "flash_fwd" and site:
                per_site[site] = {"fwd_ms": ms, "fwd_wall_ms": wall_ms,
                                  "sdpa_ms": lib_ms,
                                  "sdpa_wall_ms": lib_wall_ms}
    copies = att.LAYOUT_COPIES["flash"]
    for b, s, h, d in FWD_SHAPES[::2]:
        q, k, v = _qkv_strided(rand, b, s, h, d)
        for name, kernel, plain, lse_tol in routes:
            o, lse = kernel(q, k, v)
            o_ref, lse_ref = plain(q, k, v)
            err_o, tol_o = _rel_err(o, o_ref, FWD_O_RTOL)
            err_l = (lse - lse_ref).abs().max().item()
            _check(name, (b, s, s, h, d), [err_o, err_l], [tol_o, lse_tol],
                   strided="[B,S,3,H,D]",
                   layout_copies=att.LAYOUT_COPIES["flash"] - copies)
            res.rows[name]["max_abs_err"] = max(
                res.rows[name]["max_abs_err"], err_o, err_l)
    if att.LAYOUT_COPIES["flash"] != copies:
        raise AssertionError("strided q, k, v were copied, not read in "
                             "place")


def _kernels_flash_bwd(res, rand, per_site):
    """K2, K3 and K6 against their plain versions; SDPA forward + backward
    is the library call of all three. Each route runs twice on the same
    inputs and must give the same bits (no atomics, a fixed order). Device
    and back-to-back times of K2 and SDPA forward + backward at the U-Net's
    sites go to `per_site`. Then each route on q, k, v sliced from one
    [B, S, 3, H, D] tensor, held to its plain version."""
    import torch
    import torch.nn.functional as F
    att = _kernel_modules()[0]
    routes = [("flash_bwd", att.flash_bwd_cuda, att.flash_bwd_ref),
              ("flash_bwd_twopass", att.flash_bwd_twopass_cuda,
               att.flash_bwd_twopass_ref),
              ("flash_bwd_fold", att.flash_bwd_fold_cuda,
               att.flash_bwd_fold_ref)]
    shapes = [(b, s, s, h, d) for b, s, h, d in BWD_SHAPES] + [CROSS_SHAPE]
    for b, sq, sk, h, d in shapes:
        q, k, v = _qkv(rand, b, sq, sk, h, d)
        do = rand(q.shape)
        o, lse = att.flash_fwd_ref(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        lib_ms, lib_wall_ms = _device_ms(sdpa_fwd_bwd), _wall_ms(sdpa_fwd_bwd)
        # the function's five products (the kernels recompute two more)
        bound = _bound(10.0 * b * h * sq * sk * d,
                       (4 * sq + 4 * sk) * b * h * d * 2 + b * h * sq * 4,
                       PEAK_BF16)
        for name, kernel, plain in routes:
            got = kernel(q, k, v, o, lse, do)
            again = kernel(q, k, v, o, lse, do)
            want = plain(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            errs, tols = zip(*(_rel_err(g_, w_, BWD_RTOL)
                               for g_, w_ in zip(got, want)))
            repeatable = all(torch.equal(x, y) for x, y in zip(got, again))
            ms = _device_ms(lambda: kernel(q, k, v, o, lse, do))
            wall_ms = _wall_ms(lambda: kernel(q, k, v, o, lse, do))
            plain_ms = _device_ms(lambda: plain(q, k, v, o, lse, do))
            _check(name, (b, sq, sk, h, d), list(errs), list(tols), ms=ms,
                   plain_ms=plain_ms, library_ms_fwd_bwd=lib_ms,
                   wall_ms=wall_ms, library_wall_ms_fwd_bwd=lib_wall_ms,
                   bound_ms=bound[0], bitwise_repeatable=repeatable)
            if not repeatable:
                raise AssertionError(f"{name} gave other bits on a second "
                                     f"call at {(b, sq, sk, h, d)}")
            res.add(name, max(errs), ms, plain_ms, bound, lib_ms)
            site = _flash_site(b, sq, sk, h, d)
            if name == "flash_bwd" and site:
                per_site[site].update(bwd_ms=ms, bwd_wall_ms=wall_ms,
                                      sdpa_fwd_bwd_ms=lib_ms,
                                      sdpa_fwd_bwd_wall_ms=lib_wall_ms)
    for b, s, h, d in BWD_SHAPES:
        q, k, v = _qkv_strided(rand, b, s, h, d)
        do = rand(q.shape)
        o, lse = att.flash_fwd_ref(q, k, v)
        for name, kernel, plain in routes:
            errs, tols = zip(*(_rel_err(g_, w_, BWD_RTOL) for g_, w_ in zip(
                kernel(q, k, v, o, lse, do), plain(q, k, v, o, lse, do))))
            _check(name, (b, s, s, h, d), list(errs), list(tols),
                   strided="[B,S,3,H,D]")
            res.rows[name]["max_abs_err"] = max(res.rows[name]["max_abs_err"],
                                                *errs)


def _flash_per_unet(per_site):
    """K1 against SDPA summed over the U-Net's ten self-attention sites,
    device and back-to-back wall ms, at each batch; where the backward was
    timed (B=1), K2 against SDPA forward + backward too."""
    for b in BATCHES:
        sums = {}
        for (sq, h, d), count in FLASH_SITES.items():
            for key, ms in per_site[(b, sq, h, d)].items():
                sums[key] = sums.get(key, 0.0) + count * ms
        ratios = {"fwd_over_sdpa": sums["fwd_ms"] / sums["sdpa_ms"],
                  "fwd_wall_over_sdpa": (sums["fwd_wall_ms"]
                                         / sums["sdpa_wall_ms"])}
        if "bwd_ms" in sums:
            ratios["bwd_over_sdpa_fwd_bwd"] = (sums["bwd_ms"]
                                               / sums["sdpa_fwd_bwd_ms"])
            ratios["bwd_wall_over_sdpa_fwd_bwd"] = (
                sums["bwd_wall_ms"] / sums["sdpa_fwd_bwd_wall_ms"])
        _line("flash_per_unet", batch=b, sites=sum(FLASH_SITES.values()),
              **sums, **ratios)


def _kernels_flash_batched(res, rand):
    """K1 and K2 against their plain versions at the batched edit's shapes,
    with device times beside the plain version's and SDPA's. Rows 0 and 2
    of the inputs are equal: their outputs must be bitwise equal (the
    kernels grid over B*H and read no other row)."""
    import torch
    import torch.nn.functional as F
    att = _kernel_modules()[0]

    def twin(*xs):
        for x in xs:
            x[2] = x[0]
        return xs

    for b, s, h, d in BATCHED_FWD_SHAPES:
        q, k, v = twin(*_qkv(rand, b, s, s, h, d))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        o, lse = att.flash_fwd_cuda(q, k, v)
        o_ref, lse_ref = att.flash_fwd_ref(q, k, v)
        torch.cuda.synchronize()
        err_o, tol_o = _rel_err(o, o_ref, FWD_O_RTOL)
        err_l = (lse - lse_ref).abs().max().item()
        lse = lse.view(b, h, s)
        rows_equal = torch.equal(o[0], o[2]) and torch.equal(lse[0], lse[2])
        bound = _bound(4.0 * b * h * s * s * d,
                       4 * s * b * h * d * 2 + b * h * s * 4, PEAK_BF16)
        _check("flash_fwd", (b, s, s, h, d), [err_o, err_l],
               [tol_o, FWD_LSE_ATOL], batched=True, rows_equal=rows_equal,
               ms=_device_ms(lambda: att.flash_fwd_cuda(q, k, v)),
               plain_ms=_device_ms(lambda: att.flash_fwd_ref(q, k, v)),
               library_ms=_device_ms(
                   lambda: F.scaled_dot_product_attention(qt, kt, vt)),
               bound_ms=bound[0], bound_by=bound[1])
        if not rows_equal:
            raise AssertionError(f"flash_fwd mixed rows at {(b, s, h, d)}")
        res.rows["flash_fwd"]["max_abs_err"] = max(
            res.rows["flash_fwd"]["max_abs_err"], err_o, err_l)
    for b, s, h, d in BATCHED_BWD_SHAPES:
        q, k, v = _qkv(rand, b, s, s, h, d)
        do = rand(q.shape)
        q, k, v, do = twin(q, k, v, do)
        o, lse = att.flash_fwd_ref(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt)
            torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))

        got = att.flash_bwd_cuda(q, k, v, o, lse, do)
        want = att.flash_bwd_ref(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        errs, tols = zip(*(_rel_err(g_, w_, BWD_RTOL)
                           for g_, w_ in zip(got, want)))
        rows_equal = all(torch.equal(g_[0], g_[2]) for g_ in got)
        bound = _bound(10.0 * b * h * s * s * d,
                       8 * s * b * h * d * 2 + b * h * s * 4, PEAK_BF16)
        _check("flash_bwd", (b, s, s, h, d), list(errs), list(tols),
               batched=True, rows_equal=rows_equal,
               ms=_device_ms(lambda: att.flash_bwd_cuda(q, k, v, o, lse,
                                                        do)),
               plain_ms=_device_ms(lambda: att.flash_bwd_ref(q, k, v, o,
                                                             lse, do)),
               library_ms_fwd_bwd=_device_ms(sdpa_fwd_bwd),
               bound_ms=bound[0], bound_by=bound[1])
        if not rows_equal:
            raise AssertionError(f"flash_bwd mixed rows at {(b, s, h, d)}")
        res.rows["flash_bwd"]["max_abs_err"] = max(
            res.rows["flash_bwd"]["max_abs_err"], *errs)


def _gn_plan_fields(plan) -> dict:
    return {"slab": plan.slab, "cluster": plan.cluster, "ppc": plan.ppc,
            "chunk": plan.chunk, "streaming": plan.streaming,
            "smem": plan.smem, "grid": plan.grid}


def _kernels_gn(res, rand):
    """K8 forward and backward against their plain versions at every
    GroupNorm site, B 1 and 2, on channels-last x (the fused U-Net's
    layout) and on NCHW x, with bf16 parameters (the U-Net's): each
    direction's plan, a check that a second call gives the same bits and
    that nothing was copied into another layout, device and back-to-back
    times of the kernel, of its one-call library on NCHW where there is no
    SiLU (F.group_norm; native_group_norm_backward), of the default path's
    composition (fp32 GroupNorm, SiLU, cast; forward) and of the plain
    version. (Every plan's time: scripts/sweep_gn_plans.py.)"""
    import torch
    import torch.nn.functional as F
    gn = _kernel_modules()[1]
    bf16 = torch.bfloat16
    for c, side, act, eps in GN_SHAPES:
        for b in BATCHES:
            shape = (b, c, side, side)
            n = b * c * side * side
            x_nchw = rand(shape, 1.5, 0.5)
            dy_nchw = rand(shape)
            g = (1.0 + 0.1 * rand((c,), dtype=torch.float32)).to(bf16)
            beta = (0.1 * rand((c,), dtype=torch.float32)).to(bf16)
            # one PyTorch call computes the same function where there is
            # no SiLU: F.group_norm (its CUDA kernel reduces in fp32), on
            # NCHW, its layout
            lib_fwd = lib_bwd = None
            if not act:
                def lib_fwd():
                    return F.group_norm(x_nchw, 32, g, beta, eps)
                _, m_, r_ = torch.ops.aten.native_group_norm(
                    x_nchw, g, beta, b, c, side * side, 32, eps)

                def lib_bwd():
                    return torch.ops.aten.native_group_norm_backward(
                        dy_nchw, x_nchw, m_, r_, g, b, c, side * side, 32,
                        [True, True, True])
            lib = {"fwd": (None, None), "bwd": (None, None)}
            if not act:
                lib = {"fwd": (_device_ms(lib_fwd), _wall_ms(lib_fwd)),
                       "bwd": (_device_ms(lib_bwd), _wall_ms(lib_bwd))}
            for layout in GN_LAYOUTS:
                fmt = (torch.channels_last if layout == "channels_last"
                       else torch.contiguous_format)
                x = x_nchw.contiguous(memory_format=fmt)
                dy = dy_nchw.contiguous(memory_format=fmt)
                copies = gn.LAYOUT_COPIES["gn"]
                y, mean, rsig = gn.gn_silu_fwd_cuda(x, g, beta, 32, eps, act,
                                                    bf16)
                y_ref, mean_ref, rsig_ref = gn.gn_silu_fwd_ref(
                    x, g, beta, 32, eps, act, bf16)
                got = gn.gn_silu_bwd_cuda(x, dy, g, beta, mean_ref,
                                          rsig_ref, 32, act)
                want = gn.gn_silu_bwd_ref(x, dy, g, beta, mean_ref, rsig_ref,
                                          32, act)
                repeat = (all(torch.equal(p, q) for p, q in zip(
                    (y, mean, rsig), gn.gn_silu_fwd_cuda(
                        x, g, beta, 32, eps, act, bf16)))
                    and all(torch.equal(p, q) for p, q in zip(
                        got, gn.gn_silu_bwd_cuda(x, dy, g, beta, mean_ref,
                                                 rsig_ref, 32, act))))
                torch.cuda.synchronize()
                in_layout = (y.is_contiguous(memory_format=fmt)
                             and got[0].is_contiguous(memory_format=fmt)
                             and gn.LAYOUT_COPIES["gn"] == copies)
                case = shape + (act, layout)

                def kernel_fwd():
                    return gn.gn_silu_fwd_cuda(x, g, beta, 32, eps, act,
                                               bf16)

                def default_fwd():
                    return F.silu(F.group_norm(x.float(), 32, g.float(),
                                               beta.float(), eps)).to(bf16)

                def kernel_bwd():
                    return gn.gn_silu_bwd_cuda(x, dy, g, beta, mean_ref,
                                               rsig_ref, 32, act)

                errs, tols = zip(*(_rel_err(p, q, GN_RTOL) for p, q in
                                   zip((y, mean, rsig),
                                       (y_ref, mean_ref, rsig_ref))))
                ms = _device_ms(kernel_fwd)
                plain_ms = _device_ms(lambda: gn.gn_silu_fwd_ref(
                    x, g, beta, 32, eps, act, bf16))
                # read x, write y; ~9 fp32 operations an element
                bound = _bound(9.0 * n, 4 * n + 4 * c, PEAK_FP32)
                plan = gn.plan_gn(b, c, side * side, 32, bf16, bf16,
                                  layout == "channels_last", False,
                                  card=True)
                _check("gn_silu_fwd", case, list(errs), list(tols), ms=ms,
                       plain_ms=plain_ms, library_ms=lib["fwd"][0],
                       default_ms=_device_ms(default_fwd), bound_ms=bound[0],
                       bound_by=bound[1], wall_ms=_wall_ms(kernel_fwd),
                       library_wall_ms=lib["fwd"][1],
                       default_wall_ms=_wall_ms(default_fwd),
                       plan=_gn_plan_fields(plan),
                       bitwise_repeatable=repeat, in_layout=in_layout)
                res.add("gn_silu_fwd", max(errs), ms, plain_ms, bound,
                        lib["fwd"][0])

                errs, tols = zip(*(_rel_err(p, q, GN_RTOL)
                                   for p, q in zip(got, want)))
                ms = _device_ms(kernel_bwd)
                plain_ms = _device_ms(lambda: gn.gn_silu_bwd_ref(
                    x, dy, g, beta, mean_ref, rsig_ref, 32, act))
                # read x and dy, write dx; ~17 fp32 operations an element
                bound = _bound(17.0 * n, 6 * n + 4 * c, PEAK_FP32)
                plan = gn.plan_gn(b, c, side * side, 32, bf16, bf16,
                                  layout == "channels_last", True, card=True)
                _check("gn_silu_bwd", case, list(errs), list(tols), ms=ms,
                       plain_ms=plain_ms, library_ms=lib["bwd"][0],
                       bound_ms=bound[0], bound_by=bound[1],
                       wall_ms=_wall_ms(kernel_bwd),
                       library_wall_ms=lib["bwd"][1],
                       plan=_gn_plan_fields(plan),
                       bitwise_repeatable=repeat, in_layout=in_layout)
                res.add("gn_silu_bwd", max(errs), ms, plain_ms, bound,
                        lib["bwd"][0])
                if not (repeat and in_layout):
                    raise AssertionError(
                        f"K8 at {case}: bitwise_repeatable={repeat}, "
                        f"in_layout={in_layout}")


def _kernels_gn_conv(res, rand):
    """K9 forward and dx against their plain versions at the fused U-Net's
    eight shapes, B 1 and 2, on channels-last x, w and dy (the fused U-Net
    holds its weights channels-last), with each direction's plan; device
    and back-to-back times of the kernels and of the default path's
    unfused composition on NCHW tensors (fp32 GroupNorm, SiLU, a cast, a
    cuDNN bf16 conv; for dx its autograd backward to x): default_ms,
    default_wall_ms. No one PyTorch call computes the fused function."""
    import torch
    import torch.nn.functional as F
    gc, conv = _kernel_modules()[2:]
    bf16 = torch.bfloat16
    for side, ci, co in CONV_SHAPES:
        for b in BATCHES:
            shape = (b, ci, side, side)
            x = rand(shape, 1.5, 0.5)
            w = rand((co, ci, 3, 3), (9 * ci) ** -0.5)
            dy = rand((b, co, side, side))
            xl, wl, dyl = (conv.to_kernel_layout(t) for t in (x, w, dy))
            g = 1.0 + 0.1 * rand((ci,), dtype=torch.float32)
            beta = 0.1 * rand((ci,), dtype=torch.float32)
            y, mean, rsig = gc.gn_silu_conv3x3_fwd_cuda(xl, g, beta, wl, 32,
                                                        1e-5)
            y_ref, mean_ref, rsig_ref = gc.gn_silu_conv3x3_fwd_ref(
                x, g, beta, w, 32, 1e-5)
            dx = gc.gn_silu_conv3x3_dx_cuda(xl, g, beta, wl, mean_ref,
                                            rsig_ref, dyl, 32)
            dx_ref = gc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean_ref,
                                               rsig_ref, dy, 32)
            torch.cuda.synchronize()
            flops = 2.0 * b * side * side * 9 * ci * co
            act_bytes = 2 * b * side * side * (ci + co)
            w_bytes = 2 * 9 * ci * co

            def default_fwd():
                z = F.silu(F.group_norm(x.float(), 32, g, beta, 1e-5))
                return F.conv2d(z.to(bf16), w, padding=1)

            xg = x.detach().requires_grad_(True)

            def default_dx():
                z = F.silu(F.group_norm(xg.float(), 32, g, beta, 1e-5))
                out = F.conv2d(z.to(bf16), w, padding=1)
                torch.autograd.grad(out, xg, dy)

            def kernel_fwd():
                return gc.gn_silu_conv3x3_fwd_cuda(xl, g, beta, wl, 32, 1e-5)

            def kernel_dx():
                return gc.gn_silu_conv3x3_dx_cuda(xl, g, beta, wl, mean_ref,
                                                  rsig_ref, dyl, 32)

            plans = {"fwd": conv.plan_conv3x3(b, side, side, ci, co),
                     "dx": conv.plan_conv3x3(b, side, side, co, ci,
                                             f32_out=True)}
            errs, tols = zip(_rel_err(y, y_ref, GN_RTOL),
                             _rel_err(rsig, rsig_ref, GN_RTOL))
            ms = _device_ms(kernel_fwd)
            plain_ms = _device_ms(lambda: gc.gn_silu_conv3x3_fwd_ref(
                x, g, beta, w, 32, 1e-5))
            bound = _bound(flops, act_bytes + w_bytes, PEAK_BF16)
            _check("gn_silu_conv3x3_fwd", shape + (co,), list(errs),
                   list(tols), ms=ms, plain_ms=plain_ms,
                   default_ms=_device_ms(default_fwd), bound_ms=bound[0],
                   bound_by=bound[1], wall_ms=_wall_ms(kernel_fwd),
                   default_wall_ms=_wall_ms(default_fwd),
                   plan=_plan_fields(plans["fwd"]))
            res.add("gn_silu_conv3x3_fwd", max(errs), ms, plain_ms, bound)

            err, tol = _rel_err(dx, dx_ref, GN_RTOL)
            again = kernel_dx()
            repeatable = torch.equal(dx, again)
            ms = _device_ms(kernel_dx)
            plain_ms = _device_ms(lambda: gc.gn_silu_conv3x3_dx_ref(
                x, g, beta, w, mean_ref, rsig_ref, dy, 32))
            # read x, dy and w, write dx
            bound = _bound(flops, act_bytes + 2 * b * side * side * ci
                           + w_bytes, PEAK_BF16)
            _check("gn_silu_conv3x3_dx", shape + (co,), [err], [tol], ms=ms,
                   plain_ms=plain_ms, default_ms=_device_ms(default_dx),
                   bound_ms=bound[0], bound_by=bound[1],
                   wall_ms=_wall_ms(kernel_dx),
                   default_wall_ms=_wall_ms(default_dx),
                   plan=_plan_fields(plans["dx"]),
                   bitwise_repeatable=repeatable)
            if not repeatable:
                raise AssertionError("gn_silu_conv3x3_dx gave other bits on "
                                     f"a second call at {shape + (co,)}")
            res.add("gn_silu_conv3x3_dx", err, ms, plain_ms, bound)


def _plan_fields(plan) -> dict:
    return {"warpgroups": plan.warpgroups, "block_n": plan.block_n,
            "box": list(plan.box), "splits": plan.splits, "grid": plan.grid}


def _kernels_conv(res, rand):
    """K7 forward and dx at every distinct conv of the conv3x3_kernel U-Net,
    on channels-last activations and a weight held channels-last, as the
    U-Net gives them. The library calls are cuDNN's bf16 conv and its input
    gradient on the same tensors (library_ms), and on NCHW copies of them
    (library_nchw_ms, the layout of earlier measurements). Each direction's
    times are also summed over the 47 convs of one U-Net forward. Then both
    directions are checked (not timed) at ragged pixel boxes and channel
    tiles, from NCHW inputs. Beside the device times, the kernel's and the
    library call's back-to-back host-clock times per call (wall_ms,
    library_wall_ms), which include each call's host cost."""
    import torch
    import torch.nn.functional as F
    conv = _kernel_modules()[3]
    bf16 = torch.bfloat16
    per_call = {(d, b): {"kernel_ms": 0.0, "library_ms": 0.0,
                         "library_nchw_ms": 0.0, "bound_ms": 0.0,
                         "kernel_wall_ms": 0.0, "library_wall_ms": 0.0,
                         "worst_site_over_library": 0.0,
                         "host_bound_readings": 0}
                for d in ("fwd", "dx") for b in BATCHES}
    for (side, ci, co), count in CONV3_SITE_COUNTS.items():
        for b in BATCHES:
            x = conv.to_kernel_layout(rand((b, ci, side, side)))
            w = conv.to_kernel_layout(rand((co, ci, 3, 3), (9 * ci) ** -0.5))
            dy = conv.to_kernel_layout(rand((b, co, side, side)))
            xn, wn, dyn = x.contiguous(), w.contiguous(), dy.contiguous()
            y = conv.conv3x3_fwd_cuda(x, w)
            y_ref = conv.conv3x3_fwd_ref(x, w)
            dx = conv.conv3x3_dx_cuda(dy, w, bf16)
            dx_ref = conv.conv3x3_dx_ref(dy, w, bf16)
            torch.cuda.synchronize()
            flops = 2.0 * b * side * side * 9 * ci * co
            # read the activation and w, write the output
            bound = _bound(flops, 2 * b * side * side * (ci + co)
                           + 2 * 9 * ci * co, PEAK_BF16)
            shape = (b, ci, side, side, co)
            directions = (
                ("fwd", "conv3x3_fwd", y, y_ref, ci, co,
                 lambda: conv.conv3x3_fwd_cuda(x, w),
                 lambda: conv.conv3x3_fwd_ref(x, w),
                 lambda: F.conv2d(x, w, padding=1),
                 lambda: F.conv2d(xn, wn, padding=1)),
                ("dx", "conv3x3_dx", dx, dx_ref, co, ci,
                 lambda: conv.conv3x3_dx_cuda(dy, w, bf16),
                 lambda: conv.conv3x3_dx_ref(dy, w, bf16),
                 lambda: torch.nn.grad.conv2d_input(x.shape, w, dy,
                                                    padding=1),
                 lambda: torch.nn.grad.conv2d_input(xn.shape, wn, dyn,
                                                    padding=1)))
            for d, name, got, want, kch, nch, kernel, plain, lib, lib_nchw \
                    in directions:
                if not conv.in_kernel_layout(got):
                    raise AssertionError(f"{name} output at {shape} is not "
                                         "channels-last")
                err, tol = _rel_err(got, want, GN_RTOL)
                ms, plain_ms = _device_ms(kernel), _device_ms(plain)
                lib_ms, nchw_ms = _device_ms(lib), _device_ms(lib_nchw)
                wall_ms, lib_wall_ms = _wall_ms(kernel), _wall_ms(lib)
                _check(name, shape, [err], [tol], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_nchw_ms=nchw_ms,
                       wall_ms=wall_ms, library_wall_ms=lib_wall_ms,
                       bound_ms=bound[0], bound_by=bound[1],
                       plan=_plan_fields(conv.plan_conv3x3(
                           b, side, side, kch, nch)))
                res.add(name, err, ms, plain_ms, bound, lib_ms)
                acc = per_call[(d, b)]
                acc["kernel_ms"] += count * ms
                acc["library_ms"] += count * lib_ms
                acc["library_nchw_ms"] += count * nchw_ms
                acc["bound_ms"] += count * bound[0]
                acc["kernel_wall_ms"] += count * wall_ms
                acc["library_wall_ms"] += count * lib_wall_ms
                acc["host_bound_readings"] += sum(
                    t.host_bound for t in (ms, lib_ms, nchw_ms))
                acc["worst_site_over_library"] = max(
                    acc["worst_site_over_library"], ms / lib_ms)
    for side, ci, co in CONV3_RAGGED_SHAPES:
        for b in BATCHES:
            x = rand((b, ci, side, side))
            w = rand((co, ci, 3, 3), (9 * ci) ** -0.5)
            dy = rand((b, co, side, side))
            for name, got, want in (
                    ("conv3x3_fwd", conv.conv3x3_fwd_cuda(x, w),
                     conv.conv3x3_fwd_ref(x, w)),
                    ("conv3x3_dx", conv.conv3x3_dx_cuda(dy, w, bf16),
                     conv.conv3x3_dx_ref(dy, w, bf16))):
                err, tol = _rel_err(got, want, GN_RTOL)
                _check(name, (b, ci, side, side, co), [err], [tol],
                       ragged=True)
                row = res.rows[name]  # the sites above made the row
                row["max_abs_err"] = max(row["max_abs_err"], err)
    for (d, b), acc in per_call.items():
        _line("conv3x3_per_unet_forward", direction=d, batch=b,
              sites=sum(CONV3_SITE_COUNTS.values()), **acc,
              kernel_over_library=acc["kernel_ms"] / acc["library_ms"],
              kernel_over_library_nchw=(acc["kernel_ms"]
                                        / acc["library_nchw_ms"]),
              kernel_over_library_wall=(acc["kernel_wall_ms"]
                                        / acc["library_wall_ms"]))


# The general flash routes' checks: (dtype, (B, Sq, Sk, H, D), timed).
# The first, fp32 at a U-Net site at B=1, gives the kernels line its row;
# fp16, bf16 and fp32 at head dims the Hopper kernels are not built for
# (160 in three head-dim chunks) are checked; SD-1.x's 32x32 site (head
# dim 80, two chunks, where the backward spills) is also timed in fp32
# and bf16.
GENERAL_FLASH = [("float32", (1, 4096, 4096, 5, 64), True),
                 ("float16", (2, 1024, 1024, 10, 64), False),
                 ("bfloat16", (1, 1000, 1500, 8, 40), False),
                 ("float32", (2, 300, 700, 2, 160), False),
                 ("float32", (1, 1024, 1024, 8, 80), True),
                 ("bfloat16", (1, 1024, 1024, 8, 80), True)]
# (dtype, (B, side, Ci, Co, groups))
GENERAL_CONV = [("float32", (1, 64, 320, 320, 32)),
                ("float16", (2, 32, 640, 640, 32)),
                ("bfloat16", (2, 12, 100, 36, 4))]


def _general_flash_tols(dtype):
    """(O rtol, lse atol, gradient rtol) of a general flash route in
    `dtype`: fp32's (its 3xTF32 products), or the half dtypes' (K1's lse
    tolerance; K4/K5 sum fp32 p and are held to FWD_F32_LSE_ATOL)."""
    import torch
    if dtype == torch.float32:
        return F32_O_RTOL, F32_LSE_ATOL, F32_BWD_RTOL
    return FWD_O_RTOL, FWD_LSE_ATOL, BWD_RTOL


def _general_bound(flops, nbytes, dtype):
    """(bound, fields) of a general flash or conv call: fp32 work at the
    smaller of the CUDA cores' fp32 time and the tensor cores' time for
    three TF32 passes (the kernels' recipe), the CUDA cores' figure kept in
    fields as `bound_fp32_cores_ms`; a half dtype's at one pass of its
    own."""
    import torch
    if dtype != torch.float32:
        return _bound(flops, nbytes, PEAK_BF16), {}
    cores = _bound(flops, nbytes, PEAK_FP32)
    return (min(cores, _bound(3 * flops, nbytes, PEAK_TF32)),
            {"bound_fp32_cores_ms": cores[0]})


def _kernels_general_flash(res, rand):
    """The general flash kernels (every forward and backward variant)
    against their plain versions on the same card tensors; SDPA (forward,
    and forward + backward) in the same dtype is the library call. A timed
    check also takes back-to-back host-clock times of kernel and SDPA."""
    import torch
    import torch.nn.functional as F
    att = _kernel_modules()[0]
    fwd = [("flash_fwd", att.flash_fwd_ref, False),
           ("flash_fwd_unfolded", att.flash_fwd_unfolded_ref, True),
           ("flash_fwd_stream",
            lambda q, k, v: att.flash_fwd_stream_ref(q, k, v, STREAM_BLOCK_K),
            True)]
    bwd = [("flash_bwd", att.flash_bwd_ref),
           ("flash_bwd_twopass", att.flash_bwd_twopass_ref),
           ("flash_bwd_fold", att.flash_bwd_fold_ref)]
    for dt, (b, sq, sk, h, d), timed in GENERAL_FLASH:
        dtype = getattr(torch, dt)
        o_tol, lse_tol, g_tol = _general_flash_tols(dtype)
        q, k, v = (rand(sh, dtype=dtype) for sh in
                   ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d)))
        do = rand((b, sq, h, d), dtype=dtype)
        es = torch.finfo(dtype).bits // 8
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        shape = (dt, b, sq, sk, h, d)
        lib_fields = {}
        if timed:
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt)
            lib_fields = dict(library_ms=_device_ms(sdpa),
                              library_wall_ms=_wall_ms(sdpa))
        bound, bound_fields = _general_bound(
            4.0 * b * h * sq * sk * d,
            (2 * sq + 2 * sk) * b * h * d * es + b * h * sq * 4, dtype)
        for name, plain, f32_sum in fwd:
            kernel = getattr(att, f"{name}_general")
            o, lse = kernel(q, k, v)
            o_ref, lse_ref = plain(q, k, v)
            err_o, tol_o = _rel_err(o, o_ref, o_tol)
            err_l = (lse - lse_ref).abs().max().item()
            l_tol = (FWD_F32_LSE_ATOL if f32_sum and dtype != torch.float32
                     else lse_tol)
            fields = {}
            if timed:
                fields = dict(ms=_device_ms(lambda: kernel(q, k, v)),
                              wall_ms=_wall_ms(lambda: kernel(q, k, v)),
                              plain_ms=_device_ms(lambda: plain(q, k, v)),
                              bound_ms=bound[0], **bound_fields,
                              **lib_fields)
            _check(f"{name}_general", shape, [err_o, err_l],
                   [tol_o, l_tol], **fields)
            _add_general(res, f"{name}_general", max(err_o, err_l), fields,
                         bound)
        o, lse = att.flash_fwd_ref(q, k, v)
        if timed:
            qg, kg, vg = (x.detach().requires_grad_(True)
                          for x in (qt, kt, vt))

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(qg, kg, vg)
                torch.autograd.grad(out, (qg, kg, vg), do.transpose(1, 2))

            lib_fields = dict(library_ms=_device_ms(sdpa_fwd_bwd),
                              library_wall_ms=_wall_ms(sdpa_fwd_bwd))
        bound, bound_fields = _general_bound(
            10.0 * b * h * sq * sk * d,
            (4 * sq + 4 * sk) * b * h * d * es + b * h * sq * 4, dtype)
        for name, plain in bwd:
            kernel = getattr(att, f"{name}_general")
            got = kernel(q, k, v, o, lse, do)
            want = plain(q, k, v, o, lse, do)
            errs, tols = zip(*(_rel_err(g_, w_, g_tol)
                               for g_, w_ in zip(got, want)))
            repeatable = all(torch.equal(g_, a_) for g_, a_ in
                             zip(got, kernel(q, k, v, o, lse, do)))
            fields = {}
            if timed:
                fields = dict(
                    ms=_device_ms(lambda: kernel(q, k, v, o, lse, do)),
                    wall_ms=_wall_ms(lambda: kernel(q, k, v, o, lse, do)),
                    plain_ms=_device_ms(lambda: plain(q, k, v, o, lse, do)),
                    bound_ms=bound[0], **bound_fields,
                    **lib_fields)
            _check(f"{name}_general", shape, list(errs), list(tols),
                   bitwise_repeatable=repeatable, **fields)
            if not repeatable:
                raise AssertionError(f"{name}_general gave other bits on a "
                                     f"second call at {shape}")
            _add_general(res, f"{name}_general", max(errs), fields, bound)


def _general_conv_rtol(dtype):
    """K7's and K9's general tolerance in `dtype`: fp32's (3xTF32
    products), or a half dtype's one rounding."""
    import torch
    return F32_CONV_RTOL if dtype == torch.float32 else GN_RTOL


def _kernels_general_gn_conv(res, rand):
    """The general instances of K7 (conv_general.cu), K8 and K9 against
    their plain versions on the same card tensors: K7 and K9 at
    _general_conv_rtol, K8 at GN_RTOL; K7's and K9's dx bitwise
    repeatable. The first case (fp32 at [1,320,64,64]->320) is timed,
    device and back to back: the library calls are cuDNN's conv (forward,
    input gradient) and, for K8 (run without SiLU), F.group_norm and
    native_group_norm_backward, in the same dtype; K9 has none, and its
    comparison is the default path in fp32 (F.group_norm, F.silu, cuDNN's
    F.conv2d, TF32 off; for dx its autograd backward to x): default_ms,
    default_wall_ms."""
    import torch
    import torch.nn.functional as F
    _, gn, gc, conv = _kernel_modules()
    for i, (dt, (b, side, ci, co, groups)) in enumerate(GENERAL_CONV):
        dtype = getattr(torch, dt)
        timed = i == 0
        es = torch.finfo(dtype).bits // 8
        x = rand((b, ci, side, side), 1.5, 0.5, dtype=dtype)
        w = rand((co, ci, 3, 3), (9 * ci) ** -0.5, dtype=dtype)
        dy = rand((b, co, side, side), dtype=dtype)
        dxin = rand((b, ci, side, side), dtype=dtype)
        g = 1.0 + 0.1 * rand((ci,), dtype=torch.float32)
        beta = 0.1 * rand((ci,), dtype=torch.float32)
        xl, wl, dyl = (conv.to_kernel_layout(t) for t in (x, w, dy))
        shape = (dt, b, ci, side, side, co)
        px = b * side * side
        flops = 2.0 * px * 9 * ci * co
        rtol = _general_conv_rtol(dtype)
        conv_bound = _general_bound(
            flops, es * (px * (ci + co) + 9 * ci * co), dtype)
        xg = xl.detach().requires_grad_(True)
        y_lib = F.conv2d(xg, wl, padding=1)
        default_fwd = default_dx = None
        if timed:
            xd = x.detach().requires_grad_(True)

            def default_fwd():
                z = F.silu(F.group_norm(x, groups, g, beta, 1e-5))
                return F.conv2d(z, w, padding=1)

            def default_dx():
                z = F.silu(F.group_norm(xd, groups, g, beta, 1e-5))
                torch.autograd.grad(F.conv2d(z, w, padding=1), xd, dy)

        # (name, kernel, plain, library call, default path, (bound,
        # fields), tolerance, checked for repeatable bits)
        cases = [
            ("conv3x3_fwd_general", lambda: conv.conv3x3_fwd_general(xl, wl),
             lambda: conv.conv3x3_fwd_ref(x, w),
             lambda: F.conv2d(xl, wl, padding=1), None, conv_bound, rtol,
             False),
            ("conv3x3_dx_general",
             lambda: conv.conv3x3_dx_general(dyl, wl, dtype),
             lambda: conv.conv3x3_dx_ref(dy, w, dtype),
             lambda: torch.autograd.grad(y_lib, xg, dyl, retain_graph=True),
             None, conv_bound, rtol, True),
            ("gn_silu_conv3x3_fwd_general",
             lambda: gc.gn_silu_conv3x3_fwd_general(xl, g, beta, wl, groups,
                                                    1e-5)[0],
             lambda: gc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, groups,
                                                1e-5)[0],
             None, default_fwd, conv_bound, rtol, False)]
        mean, rsig = gc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, groups,
                                                1e-5)[1:]
        cases.append((
            "gn_silu_conv3x3_dx_general",
            lambda: gc.gn_silu_conv3x3_dx_general(xl, g, beta, wl, mean,
                                                  rsig, dyl, groups),
            lambda: gc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean, rsig, dy,
                                              groups),
            None, default_dx,
            _general_bound(flops, es * (px * (2 * ci + co) + 9 * ci * co),
                           dtype), rtol, True))
        if side * side % 8 == 0:
            # K8 without SiLU (the transformer norms), so that one PyTorch
            # call computes the same function: F.group_norm and its
            # backward in the same dtype
            gn_bytes = es * b * ci * side * side
            gm, gr = gn.gn_silu_fwd_ref(x, g, beta, groups, 1e-6, False,
                                        dtype)[1:]
            lib_fwd = lib_bwd = None
            if timed:
                _, m_, r_ = torch.ops.aten.native_group_norm(
                    x, g, beta, b, ci, side * side, groups, 1e-6)

                def lib_fwd():
                    return F.group_norm(x, groups, g, beta, 1e-6)

                def lib_bwd():
                    return torch.ops.aten.native_group_norm_backward(
                        dxin, x, m_, r_, g, b, ci, side * side, groups,
                        [True, True, True])
            cases += [
                ("gn_silu_fwd_general",
                 lambda: gn.gn_silu_fwd_general(x, g, beta, groups, 1e-6,
                                                False, dtype)[0],
                 lambda: gn.gn_silu_fwd_ref(x, g, beta, groups, 1e-6, False,
                                            dtype)[0],
                 lib_fwd, None, (_bound(9.0 * gn_bytes / es, 2 * gn_bytes,
                                        PEAK_FP32), {}), GN_RTOL, False),
                ("gn_silu_bwd_general",
                 lambda: gn.gn_silu_bwd_general(x, dxin, g, beta, gm, gr,
                                                groups, False)[0],
                 lambda: gn.gn_silu_bwd_ref(x, dxin, g, beta, gm, gr,
                                            groups, False)[0],
                 lib_bwd, None, (_bound(17.0 * gn_bytes / es, 3 * gn_bytes,
                                        PEAK_FP32), {}), GN_RTOL, False)]
        for (name, kernel, plain, lib, default, (bound, bound_fields), tol_r,
             repeat) in cases:
            got = kernel()
            err, tol = _rel_err(got, plain(), tol_r)
            fields = {}
            if repeat:
                fields["bitwise_repeatable"] = torch.equal(got, kernel())
            if timed:
                fields.update(ms=_device_ms(kernel), wall_ms=_wall_ms(kernel),
                              plain_ms=_device_ms(plain),
                              library_ms=(None if lib is None
                                          else _device_ms(lib)),
                              bound_ms=bound[0], bound_by=bound[1],
                              **bound_fields)
                if lib is not None:
                    fields["library_wall_ms"] = _wall_ms(lib)
                if default is not None:
                    fields.update(default_ms=_device_ms(default),
                                  default_wall_ms=_wall_ms(default))
            _check(name, shape, [err], [tol], dtype_out=str(got.dtype),
                   **fields)
            if got.dtype != dtype:
                raise AssertionError(f"{name} wrote {got.dtype}, not {dtype}")
            if repeat and not fields["bitwise_repeatable"]:
                raise AssertionError(f"{name} gave other bits on a second "
                                     f"call at {shape}")
            _add_general(res, name, err, fields, bound)


def _kernels_general_conv_sites(res, rand):
    """K7's general kernel in fp32 at every distinct conv of the conv U-Net
    (CONV3_SITE_COUNTS, B=1), forward and dx, against its plain version
    (F32_CONV_RTOL; bitwise repeatable) and against cuDNN fp32 (TF32 off:
    F.conv2d, conv2d_input) on the same channels-last tensors, device and
    back-to-back times, with the planner's plan; each direction's times
    summed over the 47 convs of one U-Net forward
    (conv3x3_general_per_unet_forward)."""
    import torch
    import torch.nn.functional as F
    conv = _kernel_modules()[3]
    f32 = torch.float32
    per_call = {d: {"kernel_ms": 0.0, "library_ms": 0.0,
                    "kernel_wall_ms": 0.0, "library_wall_ms": 0.0,
                    "bound_ms": 0.0, "bound_fp32_cores_ms": 0.0,
                    "worst_site_over_library": 0.0,
                    "host_bound_readings": 0}
                for d in ("fwd", "dx")}
    for (side, ci, co), count in CONV3_SITE_COUNTS.items():
        x = conv.to_kernel_layout(rand((1, ci, side, side), 1.5, 0.5,
                                       dtype=f32))
        w = conv.to_kernel_layout(rand((co, ci, 3, 3), (9 * ci) ** -0.5,
                                       dtype=f32))
        dy = conv.to_kernel_layout(rand((1, co, side, side), dtype=f32))
        bound, bound_fields = _general_bound(
            2.0 * side * side * 9 * ci * co,
            4 * (side * side * (ci + co) + 9 * ci * co), f32)
        shape = ("float32", 1, ci, side, side, co)
        for d, name, kch, nch, kernel, plain, lib in (
                ("fwd", "conv3x3_fwd_general", ci, co,
                 lambda: conv.conv3x3_fwd_general(x, w),
                 lambda: conv.conv3x3_fwd_ref(x, w),
                 lambda: F.conv2d(x, w, padding=1)),
                ("dx", "conv3x3_dx_general", co, ci,
                 lambda: conv.conv3x3_dx_general(dy, w, f32),
                 lambda: conv.conv3x3_dx_ref(dy, w, f32),
                 lambda: torch.nn.grad.conv2d_input(x.shape, w, dy,
                                                    padding=1))):
            got = kernel()
            err, tol = _rel_err(got, plain(), F32_CONV_RTOL)
            repeatable = torch.equal(got, kernel())
            ms, lib_ms = _device_ms(kernel), _device_ms(lib)
            wall_ms, lib_wall_ms = _wall_ms(kernel), _wall_ms(lib)
            _check(name, shape, [err], [tol], ms=ms, library_ms=lib_ms,
                   wall_ms=wall_ms, library_wall_ms=lib_wall_ms,
                   bound_ms=bound[0], bound_by=bound[1], **bound_fields,
                   bitwise_repeatable=repeatable,
                   plan=_plan_fields(conv.plan_conv3x3_general(
                       1, side, side, kch, nch)))
            if not repeatable:
                raise AssertionError(f"{name} gave other bits on a second "
                                     f"call at {shape}")
            row = res.rows[name]  # _kernels_general_gn_conv made the row
            row["max_abs_err"] = max(row["max_abs_err"], err)
            acc = per_call[d]
            acc["kernel_ms"] += count * ms
            acc["library_ms"] += count * lib_ms
            acc["kernel_wall_ms"] += count * wall_ms
            acc["library_wall_ms"] += count * lib_wall_ms
            acc["bound_ms"] += count * bound[0]
            acc["bound_fp32_cores_ms"] += count * bound_fields[
                "bound_fp32_cores_ms"]
            acc["host_bound_readings"] += sum(
                t.host_bound for t in (ms, lib_ms))
            acc["worst_site_over_library"] = max(
                acc["worst_site_over_library"], ms / lib_ms)
    for d, acc in per_call.items():
        _line("conv3x3_general_per_unet_forward", direction=d, batch=1,
              sites=sum(CONV3_SITE_COUNTS.values()), **acc,
              kernel_over_library=acc["kernel_ms"] / acc["library_ms"],
              kernel_over_library_wall=(acc["kernel_wall_ms"]
                                        / acc["library_wall_ms"]))


def _kernels_fp16(res, rand):
    """The Hopper kernels' fp16 instances against their plain versions at
    one main-path shape each, with the bf16 instances' tolerances, and
    their device ms there (on the kernel line, beside the bf16 instance's
    on its own); the worst error joins the kernel's row."""
    import torch
    att, _, gc, conv = _kernel_modules()
    f16 = torch.float16

    def check(name, shape, pairs, rtol, fn):
        errs, tols = zip(*(_rel_err(g_, w_, rtol) for g_, w_ in pairs))
        _check(name, ("float16",) + shape, list(errs), list(tols),
               ms=_device_ms(fn))
        res.rows[name]["max_abs_err"] = max(res.rows[name]["max_abs_err"],
                                            *errs)

    b, s_, h, d = FWD_SHAPES[0]
    q, k, v = (rand((b, s_, h, d), dtype=f16) for _ in range(3))
    for name, plain in (
            ("flash_fwd", att.flash_fwd_ref),
            ("flash_fwd_unfolded", att.flash_fwd_unfolded_ref),
            ("flash_fwd_stream", lambda q, k, v: att.flash_fwd_stream_ref(
                q, k, v, STREAM_BLOCK_K))):
        kernel = getattr(att, f"{name}_cuda")
        o, lse = kernel(q, k, v)
        o_ref, lse_ref = plain(q, k, v)
        if o.dtype != f16:
            raise AssertionError(f"{name} wrote {o.dtype}")
        check(name, (b, s_, s_, h, d), [(o, o_ref)], FWD_O_RTOL,
              lambda: kernel(q, k, v))
    b, s_, h, d = BWD_SHAPES[1]
    q, k, v, do = (rand((b, s_, h, d), dtype=f16) for _ in range(4))
    o, lse = att.flash_fwd_ref(q, k, v)
    for name in ("flash_bwd", "flash_bwd_twopass", "flash_bwd_fold"):
        kernel = getattr(att, f"{name}_cuda")
        got = kernel(q, k, v, o, lse, do)
        want = getattr(att, f"{name}_ref")(q, k, v, o, lse, do)
        check(name, (b, s_, s_, h, d), list(zip(got, want)), BWD_RTOL,
              lambda: kernel(q, k, v, o, lse, do))
    side, ci, co = CONV_SHAPES[0]
    x = rand((1, ci, side, side), 1.5, 0.5, dtype=f16)
    w = rand((co, ci, 3, 3), (9 * ci) ** -0.5, dtype=f16)
    dy = rand((1, co, side, side), dtype=f16)
    g = 1.0 + 0.1 * rand((ci,), dtype=torch.float32)
    beta = 0.1 * rand((ci,), dtype=torch.float32)
    shape = (1, ci, side, side, co)
    xl, wl, dyl = (conv.to_kernel_layout(t) for t in (x, w, dy))
    check("conv3x3_fwd", shape, [(conv.conv3x3_fwd_cuda(xl, wl),
                                  conv.conv3x3_fwd_ref(x, w))], GN_RTOL,
          lambda: conv.conv3x3_fwd_cuda(xl, wl))
    check("conv3x3_dx", shape, [(conv.conv3x3_dx_cuda(dyl, wl, f16),
                                 conv.conv3x3_dx_ref(dy, w, f16))], GN_RTOL,
          lambda: conv.conv3x3_dx_cuda(dyl, wl, f16))
    y, mean, rsig = gc.gn_silu_conv3x3_fwd_cuda(xl, g, beta, wl, 32, 1e-5)
    y_ref, mean_ref, rsig_ref = gc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, 32,
                                                           1e-5)
    check("gn_silu_conv3x3_fwd", shape, [(y, y_ref)], GN_RTOL,
          lambda: gc.gn_silu_conv3x3_fwd_cuda(xl, g, beta, wl, 32, 1e-5))
    check("gn_silu_conv3x3_dx", shape, [(
        gc.gn_silu_conv3x3_dx_cuda(xl, g, beta, wl, mean_ref, rsig_ref, dyl,
                                   32),
        gc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean_ref, rsig_ref, dy,
                                  32))], GN_RTOL,
          lambda: gc.gn_silu_conv3x3_dx_cuda(xl, g, beta, wl, mean_ref,
                                             rsig_ref, dyl, 32))


def _add_general(res, name, err, fields, bound):
    """A general kernel's row: the worst error over its checks, the times
    and bounds of its first check (timed, fp32)."""
    first = name not in res.rows
    res.add(name, err, fields.get("ms"), fields.get("plain_ms"), bound,
            fields.get("library_ms"))
    if first and "bound_fp32_cores_ms" in fields:
        res.rows[name]["bound_fp32_cores_ms"] = fields["bound_fp32_cores_ms"]


def phase_kernels() -> dict:
    """Each kernel vs its plain version at the main path's shapes; returns
    {name: {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
    "library_ms"}} (worst error over shapes, the rest at the first,
    largest shape)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(shape, scale=1.0, shift=0.0, dtype=torch.bfloat16):
        x = torch.randn(shape, generator=gen, device="cuda") * scale + shift
        return x.to(dtype)

    res = _Results()
    per_site = {}
    _kernels_flash_fwd(res, rand, per_site)
    _kernels_flash_bwd(res, rand, per_site)
    _flash_per_unet(per_site)
    _kernels_flash_batched(res, rand)
    _kernels_gn(res, rand)
    _kernels_gn_conv(res, rand)
    _kernels_conv(res, rand)
    _kernels_fp16(res, rand)
    _kernels_general_flash(res, rand)
    _kernels_general_gn_conv(res, rand)
    _kernels_general_conv_sites(res, rand)
    return res.rows


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


def _swapped_unet(unet, **switches):
    """A U-Net built on `unet`'s config with `switches` set (UNetConfig
    fields), holding the same weight tensors."""
    import torch

    from diffusionhandles_tpu_torch.models.unet import UNet2DConditionModel
    cfg = dataclasses.replace(unet.config, **switches)
    with torch.device("meta"):
        other = UNet2DConditionModel(cfg)
    other.load_state_dict(unet.state_dict(), strict=True, assign=True)
    return other.eval().requires_grad_(False)


def _swapped_models(conf, **switches):
    """The seeded sd2 models with the U-Net swapped for one built on the
    config with `switches` set, holding the same weight tensors."""
    from diffusionhandles_tpu_torch.diffuser import create_sd_models

    models = create_sd_models(conf=conf, device="cuda")
    unet = _swapped_unet(models.unet, **switches)
    return dataclasses.replace(models, unet=unet, unet_config=unet.config)


def _handles(num_timesteps: int, **switches):
    """A 512x512 sd2 DiffusionHandles on the card with seeded random
    weights; with `switches`, its U-Net is built on the config with them
    set (UNetConfig fields)."""
    from diffusionhandles_tpu_torch.config import DiffusionHandlesConfig
    from diffusionhandles_tpu_torch.pipeline import DiffusionHandles

    conf = DiffusionHandlesConfig()
    conf.guided_diffuser.num_timesteps = num_timesteps
    models = (_swapped_models(conf.guided_diffuser, **switches)
              if switches else None)
    return DiffusionHandles(conf, variant="sd2", device="cuda", models=models)


def _count_unet_calls(unet) -> dict:
    """Count the U-Net's calls, those that record a graph for a backward
    (grad mode on and an input that requires grad), and the calls of its
    conv-kernel 3x3 convs whose input passes the conv gate."""
    import torch

    from diffusionhandles_tpu_torch.models.unet import Conv3x3
    from diffusionhandles_tpu_torch.ops.conv import conv3x3_ok
    calls = {"forward": 0, "with_grad": 0, "conv3x3_eligible": 0}

    def unet_hook(_module, args, kwargs):
        calls["forward"] += 1
        inputs = list(args) + list(kwargs.values())
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in inputs):
            calls["with_grad"] += 1

    def conv_hook(mod, args):
        b, ci, h, w = args[0].shape
        calls["conv3x3_eligible"] += conv3x3_ok(
            (b, h, w, ci), (3, 3, ci, mod.out_channels),
            dtype_bytes=torch.finfo(mod.compute_dtype).bits // 8)

    unet.register_forward_pre_hook(unet_hook, with_kwargs=True)
    for mod in unet.modules():
        if isinstance(mod, Conv3x3) and mod.kernel:
            mod.register_forward_pre_hook(conv_hook)
    return calls


EDIT_PROMPT = "a toy cube on a table"
EDIT_TRANSFORM = dict(rot_angle=20.0, rot_axis=[0.0, 1.0, 0.0],
                      translation=[0.0, 0.0, 0.1])


def phase_edit(name: str, num_timesteps: int, kernels: tuple, **switches):
    """One edit through the four public steps; returns the handles, the
    kernels' launch counts of that run (each of `kernels` must be > 0),
    the U-Net's call counts, the inputs the GroupNorm wrappers copied
    into their kernels' layouts in that run, and transform_foreground's
    inputs and result (`edit`)."""
    import numpy as np
    import torch

    start = time.perf_counter()
    handles = _handles(num_timesteps, **switches)
    torch.cuda.synchronize()
    _line(f"{name}_setup", seconds=time.perf_counter() - start,
          num_timesteps=num_timesteps, image_res=handles.img_res,
          unet_config={k: getattr(handles.diffuser.models.unet_config, k)
                       for k in ("fused_gn_conv", "fused_gn",
                                 "conv3x3_kernel", "flash_attention")})
    sample = _sample(handles.img_res)
    prompt = EDIT_PROMPT
    calls = _count_unet_calls(handles.diffuser.models.unet)

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    copies0 = layout_copies()
    reset_launch_counts()
    steps = {}

    def timed(step, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[step] = time.perf_counter() - t0
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
            activations=acts, **EDIT_TRANSFORM))
    launches = launch_counts()
    copies = {k: n - copies0[k] for k, n in layout_copies().items()}
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
        "kernels_launched": all(launches[k] > 0 for k in kernels),
        # bf16 at the U-Net's shapes: every call on a Hopper kernel
        "no_general_route": not any(n for k, n in launches.items()
                                    if k.endswith("_general")),
    }
    _line(name, seconds=steps, total_seconds=sum(steps.values()),
          launches=launches, layout_copies=copies, unet_calls=calls,
          peak_bytes=peak, resident_bytes=resident, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"{name} checks failed: {checks}")
    edit = dict(inputs=dict(depth=sample["depth"], prompt=prompt,
                            fg_mask=sample["fg_mask"], bg_depth=bg,
                            null_text_emb=null, init_noise=noise,
                            activations=acts),
                edited=edited, disparity=disparity)
    return handles, launches, calls, copies, edit


def _timed(fn):
    """(fn(), host seconds to its end on the card)."""
    import torch
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


# The mesh transform on the card against the port on the CPU. Its geometry
# is elementwise fp32 (no matmul, so no TF32; the intrinsics inverted on the
# host), so the two differ only where a reduction sums in another order:
# the foreground centroid, whose last-bit shift moves the foreground's z by
# ~1e-7 relative and can flip a face only at a near-exact tie of two faces'
# z. Bounds: faces flipped at <= 1e-3 of the pixels, zbuf within 1e-5 of
# the largest z, disparity within 1e-5 of 255 except at flipped pixels, and
# <= 1e-3 of the correspondence rows different.
MESH_FACE_SHARE = 1e-3
MESH_ZBUF_RTOL = 1e-5
MESH_CORR_SHARE = 1e-3


def _mesh_on(device, inputs, intrinsics):
    """The 512x512 merged depth mesh of the edit (background grid +
    transformed foreground) rasterized on `device`: (raster, faces, big
    faces)."""
    from diffusionhandles_tpu_torch.geometry.mesh import depth_to_mesh
    from diffusionhandles_tpu_torch.geometry.mesh_transform import \
        merge_meshes
    from diffusionhandles_tpu_torch.geometry.transform import \
        transform_points
    from diffusionhandles_tpu_torch.ops.rasterize import (big_faces,
                                                          project_verts,
                                                          rasterize)
    res = inputs["depth"].shape[-1]
    fg = inputs["fg_mask"].reshape(res, res) > 0.5
    fg_mesh = depth_to_mesh(inputs["depth"], intrinsics, mask=fg,
                            device=device)
    fg_mesh.verts = transform_points(
        fg_mesh.verts, EDIT_TRANSFORM["rot_angle"],
        EDIT_TRANSFORM["rot_axis"], EDIT_TRANSFORM["translation"])
    mesh = merge_meshes(depth_to_mesh(inputs["bg_depth"], intrinsics,
                                      device=device), fg_mesh)
    verts_px = project_verts(mesh.verts, intrinsics, res, res)
    return (rasterize(verts_px, mesh.faces, res, res),
            int(mesh.faces.shape[0]),
            int(big_faces(verts_px, mesh.faces).numel()))


def _rows_differ(a, b) -> float:
    """Share of correspondence rows in one [N, 4] set and not the other."""
    sa, sb = set(map(tuple, a.tolist())), set(map(tuple, b.tolist()))
    return len(sa ^ sb) / max(len(sa), len(sb), 1)


def phase_edit_paths(handles, edit) -> float:
    """The edit's other entry points on the default handles, at 512x512:
    save_denoising_steps, the [N, 4] host correspondence path against the
    device binning, and the mesh-mode transform (against the port on the
    CPU) and edit. Returns the single edit's seconds."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.geometry import mesh_transform
    from diffusionhandles_tpu_torch.geometry.transform import (
        transform_depth, transform_depth_pc_processed)
    d = handles.diffuser
    gconf = handles.conf.guided_diffuser
    inputs = edit["inputs"]
    res, steps_t = handles.img_res, d.schedule.num_inference_steps
    reset_launch_counts()

    # save_denoising_steps: T decoded (post-opt, post-CFG) pairs, and the
    # same guided loop as with the flag off
    (off_img, off_disp), off_s = _timed(lambda: handles.transform_foreground(
        **inputs, **EDIT_TRANSFORM))
    gconf.save_denoising_steps = True
    try:
        (img, disp, steps), on_s = _timed(
            lambda: handles.transform_foreground(**inputs, **EDIT_TRANSFORM))
    finally:
        gconf.save_denoising_steps = False
    pairs = steps["opt"]
    flat = [x for pair in pairs for x in pair]
    checks = {
        "steps": set(steps) == {"opt"} and len(pairs) == steps_t,
        "step_shapes": all(x.shape == (1, res, res, 3) for x in flat),
        "steps_finite": all(bool(np.isfinite(x).all()) for x in flat),
        "steps_in_0_1": all(x.min() >= 0.0 and x.max() <= 1.0
                            for x in flat),
        "image_bitwise_flag_off": bool(np.array_equal(img, off_img)),
        "disparity_bitwise_flag_off": bool(np.array_equal(disp, off_disp)),
    }
    _line("edit_paths_save_steps", seconds_flag_off=off_s,
          seconds_flag_on=on_s, step_pairs=len(pairs),
          image_max_abs_diff=float(np.abs(img - off_img).max()),
          same_as_edit_phase=bool(np.array_equal(off_img, edit["edited"])),
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"save_denoising_steps checks failed: {checks}")

    # the packed [N, 4] host path against the device binning: the same
    # (cell pair, weight) slots in the same order, so the same guided loop
    intrinsics = d.get_depth_intrinsics()
    geo = (inputs["depth"], inputs["bg_depth"], inputs["fg_mask"],
           intrinsics)
    (disp_h, corr), host_s = _timed(lambda: transform_depth(
        *geo, device="cuda", **EDIT_TRANSFORM))
    pc_h = d.process_correspondences(corr, res, gconf.bg_erosion)
    (disp_d, pc_d), dev_s = _timed(lambda: transform_depth_pc_processed(
        *geo, bg_erosion=gconf.bg_erosion,
        max_corr=gconf.max_correspondences, latent_res=d.latent_res,
        device="cuda", **EDIT_TRANSFORM))

    def slots(pc):
        live = pc.corr_w > 0
        rows = torch.stack([pc.corr_ox, pc.corr_oy, pc.corr_tx, pc.corr_ty,
                            pc.corr_w.long()], 1)[live]
        return set(map(tuple, rows.tolist()))

    host_img, host_edit_s = _timed(lambda: d.guided_inference(
        latents=inputs["init_noise"], depth=disp_h,
        uncond_embeddings=inputs["null_text_emb"], prompt=inputs["prompt"],
        activations_orig=inputs["activations"], correspondences=corr))
    host_img = host_img.cpu().numpy()
    checks = {
        "disparity_equal": bool(torch.equal(disp_h, disp_d)),
        "slots_equal_as_sets": slots(pc_h) == slots(pc_d),
        "slots_equal_in_order": all(torch.equal(
            getattr(pc_h, f).to(getattr(pc_d, f).dtype), getattr(pc_d, f))
            for f in pc_d._fields),
        # identical slots in identical order: the same computation
        "image_bitwise": bool(np.array_equal(host_img, off_img)),
    }
    _line("edit_paths_host_correspondences", rows=int(len(corr)),
          slots=len(slots(pc_h)), transform_seconds_host=host_s,
          transform_seconds_device=dev_s, edit_seconds=host_edit_s,
          image_max_abs_diff=float(np.abs(host_img - off_img).max()),
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"host correspondence checks failed: {checks}")

    # mesh mode: the transform alone (peak memory its own), against the
    # port on the CPU, then the whole edit
    _free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    (m_disp, m_corr), mesh_s = _timed(
        lambda: mesh_transform.transform_depth_mesh(
            *geo, device="cuda", **EDIT_TRANSFORM))
    mesh_peak = torch.cuda.max_memory_allocated() - resident
    _, mesh_s_again = _timed(lambda: mesh_transform.transform_depth_mesh(
        *geo, device="cuda", **EDIT_TRANSFORM))
    start = time.perf_counter()
    c_disp, c_corr = mesh_transform.transform_depth_mesh(
        *geo, device="cpu", **EDIT_TRANSFORM)
    cpu_s = time.perf_counter() - start
    raster_gpu, faces, big_gpu = _mesh_on("cuda", inputs, intrinsics)
    raster_cpu, _, big_cpu = _mesh_on("cpu", inputs, intrinsics)
    fid_g, fid_c = raster_gpu.face_id.cpu(), raster_cpu.face_id
    both = (fid_g >= 0) & (fid_c >= 0)
    z_g, z_c = raster_gpu.zbuf.cpu()[both], raster_cpu.zbuf[both]
    face_share = float((fid_g != fid_c).float().mean())
    zbuf_err = float((z_g - z_c).abs().max()) if both.any() else 0.0
    disp_diff = (m_disp.cpu() - c_disp)[0, 0]
    same_face = (fid_g == fid_c)
    corr_share = _rows_differ(m_corr, c_corr)
    handles.conf.depth_transform_mode = "mesh"
    try:
        (mesh_img, mesh_edit_disp), mesh_edit_s = _timed(
            lambda: handles.transform_foreground(**inputs, **EDIT_TRANSFORM))
    finally:
        handles.conf.depth_transform_mode = "pc"
    checks = {
        "big_faces_same": big_gpu == big_cpu,
        "face_ids": face_share <= MESH_FACE_SHARE,
        "zbuf": zbuf_err <= MESH_ZBUF_RTOL * float(z_c.max()),
        "disparity": float(disp_diff[same_face].abs().max())
        <= MESH_ZBUF_RTOL * 255.0,
        "correspondences": corr_share <= MESH_CORR_SHARE,
        "edit_disparity_is_transform's": bool(np.array_equal(
            mesh_edit_disp, m_disp.cpu().numpy())),
        "edit_finite": bool(np.isfinite(mesh_img).all()),
        "edit_in_0_1": bool(mesh_img.min() >= 0.0 and mesh_img.max() <= 1.0),
        "edit_shape": list(mesh_img.shape) == [1, 3, res, res],
    }
    _line("edit_paths_mesh", transform_seconds=mesh_s,
          transform_seconds_again=mesh_s_again, transform_peak_bytes=mesh_peak,
          cpu_transform_seconds=cpu_s, faces=faces, big_faces=big_gpu, rows=int(len(m_corr)),
          rows_cpu=int(len(c_corr)), face_id_differ_share=face_share,
          zbuf_max_abs_err=zbuf_err,
          disparity_max_abs_err=float(disp_diff.abs().max()),
          correspondence_rows_differ_share=corr_share,
          edit_seconds=mesh_edit_s, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"mesh checks failed: {checks}")
    launches = launch_counts()
    checks = {"kernels_launched": all(launches[k] > 0 for k in (
        "flash_fwd", "flash_bwd")), "no_general_route": _no_general(launches)}
    _line("edit_paths_launches", flash_fwd=launches["flash_fwd"],
          flash_bwd=launches["flash_bwd"], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"edit paths launches off: {checks}")
    return off_s


# The batched edit against the single edit. At batch 1 it runs the single
# edit's kernels on the same shapes and must give its bits. At batch 4 it
# runs its convolutions image by image (UNetConfig.conv_per_image: at
# batch > 1 cuDNN may sum two equal rows in different orders), so twin
# rows must give equal bits; but its other products round in another
# order than the single edit's, and the random-weight edit is chaotic at
# that level: a 2**-16 relative nudge of the initial latents, far below
# bf16's 2**-8, moves the image as far as any rounding change does (on an
# H100 at 700 W: correlation 0.9645, mean abs 0.0417; PERF.md). So a
# batched row against the single edit, and the remat run against remat
# off, are held to the distance such a nudge gives in the same run:
# correlation no lower by more than BATCH_CORR_MARGIN, mean abs difference
# at most BATCH_MEAN_RATIO times.
BATCH_NUDGE = 2.0 ** -16
BATCH_CORR_MARGIN = 0.005
BATCH_MEAN_RATIO = 1.2
# edit_batch's guidance U-Net recompute, read when its runner is built
BATCHED_REMAT_ENV = "DIFFHANDLES_BATCHED_REMAT"


def _agree(a, b) -> dict:
    import numpy as np
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return {"corr": float(np.corrcoef(a, b)[0, 1]),
            "max_abs_diff": float(np.abs(a - b).max()),
            "mean_abs_diff": float(np.abs(a - b).mean()),
            "bitwise": bool(np.array_equal(a, b))}


def _within(m: dict, ref: dict) -> bool:
    """`m` no farther apart than the nudged edit `ref`, with the margins."""
    return (m["corr"] >= ref["corr"] - BATCH_CORR_MARGIN
            and m["mean_abs_diff"] <= BATCH_MEAN_RATIO * ref["mean_abs_diff"])


def _unet_twin_rows(handles) -> dict:
    """One batch-4 U-Net forward + backward to the latents with rows 0 and
    2 equal: with cuDNN off (its conv algorithms are the part that may
    differ by batch position) the port's own ops and kernels must give
    those rows the same bits; with cuDNN on, so must the U-Net with
    conv_per_image, the batched edit's route."""
    import torch
    unet = handles.diffuser.models.unet
    gen = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn((4, unet.config.in_channels, 64, 64), generator=gen)
    ctx = torch.randn((4, 77, unet.config.cross_attention_dim),
                      generator=gen)
    x[2], ctx[2] = x[0], ctx[0]
    x, ctx = x.to("cuda"), ctx.to("cuda")
    t = torch.tensor(500, device="cuda")
    with torch.backends.cudnn.flags(enabled=False):
        eps, grad = _latents_grad(unet, x, t, ctx)
    eps_pi, grad_pi = _latents_grad(
        _swapped_unet(unet, conv_per_image=True), x, t, ctx)
    return {"eps_rows_bitwise": bool(torch.equal(eps[0], eps[2])),
            "grad_rows_bitwise": bool(torch.equal(grad[0], grad[2])),
            "conv_per_image_cudnn_on_eps_rows_bitwise": bool(
                torch.equal(eps_pi[0], eps_pi[2])),
            "conv_per_image_cudnn_on_grad_rows_bitwise": bool(
                torch.equal(grad_pi[0], grad_pi[2]))}


def phase_edit_batched(handles, edit, single_seconds: float):
    """edit_batch on the default handles: one transform at batch 1 (the
    single edit's bits), then 3 transforms (the first and the last
    identical) in a chunk of 4, EDIT_TIMESTEPS steps, with remat off and
    then 'dots'. Returns edit_batch's positional arguments, the
    transforms and the remat-off run's images."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.parallel.batch import edit_batch
    inputs = edit["inputs"]
    single = edit["edited"][0]
    conf = handles.conf.guided_diffuser
    tr0 = {"rotation_angle": EDIT_TRANSFORM["rot_angle"],
           "rotation_axis": EDIT_TRANSFORM["rot_axis"],
           "translation": EDIT_TRANSFORM["translation"]}
    transforms = [tr0, {"rotation_angle": -15.0, "rotation_axis": [0, 1, 0],
                        "translation": [0.05, 0.0, 0.0]}, tr0]
    args = (inputs["depth"], inputs["prompt"], inputs["fg_mask"],
            inputs["bg_depth"], inputs["null_text_emb"],
            inputs["init_noise"], inputs["activations"])
    steps_t = handles.diffuser.schedule.num_inference_steps
    guided_calls = min(conf.guidance_max_step, steps_t) * conf.num_optsteps
    sites = sum(FLASH_SITES.values())
    saved = os.environ.pop(BATCHED_REMAT_ENV, None)

    # the references: batch 1, and the single edit nudged at rounding level
    one = edit_batch(handles, *args, [tr0])
    gen = torch.Generator(device="cpu").manual_seed(5)
    noise = inputs["init_noise"]
    signs = torch.randn(noise.shape, generator=gen).sign().to(noise.device)
    nudged, _ = handles.transform_foreground(
        **{**inputs, "init_noise": noise * (1.0 + BATCH_NUDGE * signs)},
        **EDIT_TRANSFORM)
    ref = _agree(nudged[0], single)
    twins = _unet_twin_rows(handles)
    checks = {"batch1_bitwise_single_edit": bool(np.array_equal(one[0],
                                                                single)),
              **twins}
    _line("edit_batched_references", batch1_vs_single=_agree(one[0], single),
          nudged_vs_single=ref, nudge=BATCH_NUDGE, unet_twin_rows=twins,
          cudnn_enabled=torch.backends.cudnn.enabled, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"batched references failed: {checks}")

    runs = {}
    for remat in (False, "dots"):
        if remat:
            os.environ[BATCHED_REMAT_ENV] = remat
        _free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launch_counts()
        imgs, seconds = _timed(lambda: edit_batch(handles, *args, transforms,
                                                  chunk=4))
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # one launch a site per U-Net call; remat reruns the guidance
        # forward's blocks (all ten sites) in the backward
        want_fwd = sites * (guided_calls * (2 if remat else 1) + steps_t)
        row0, twin = _agree(imgs[0], single), _agree(imgs[2], imgs[0])
        vs_off = _agree(imgs, runs[False]["imgs"]) if remat else None
        checks = {
            "shape": imgs.shape == (3, 3, handles.img_res, handles.img_res),
            "finite": bool(np.isfinite(imgs).all()),
            "row0_vs_single_edit": _within(row0, ref),
            "twin_rows_bitwise": twin["bitwise"],
            "k1_launches": launches["flash_fwd"] == want_fwd,
            "k2_launches": launches["flash_bwd"] == sites * guided_calls,
            "no_general_route": _no_general(launches),
        }
        if remat:
            checks["remat_vs_off"] = _within(vs_off, ref)
        _line("edit_batched", remat=remat or "off", transforms=3, chunk=4,
              batch=4, seconds=seconds, seconds_per_edit=seconds / 3,
              single_edit_seconds=single_seconds, peak_bytes=peak,
              resident_bytes=resident, flash_fwd=launches["flash_fwd"],
              flash_bwd=launches["flash_bwd"], flash_fwd_expected=want_fwd,
              row0_vs_single_edit=row0, twin_rows=twin, vs_remat_off=vs_off,
              checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"batched edit checks failed: {checks}")
        runs[remat] = {"imgs": imgs, "launches": launches}
    os.environ.pop(BATCHED_REMAT_ENV, None)
    if saved is not None:
        os.environ[BATCHED_REMAT_ENV] = saved
    return args, transforms, runs[False]["imgs"]


# The conv3x3_kernel values of the conv-modes phase ('hybrid': K7's dx
# under cuDNN's forward; 'mixed': K7's forward over a plain fp32 backward)
CONV_MODES = {"default": False, "conv": True, "hybrid": "hybrid",
              "mixed": "mixed"}
CONV_MODE_REPEATS = 2


def phase_unet_conv_modes(handles) -> None:
    """One guidance forward + backward (the latents' gradient) of the sd2
    U-Net at 512x512, bf16, on the handles' seeded weights, with each
    conv3x3_kernel value (CONV_MODES): eps and the gradient against the
    default U-Net's within UNET_RTOL, K7's forward and dx launches of the
    call (hybrid: dx only; mixed: forward only), no general route, and the
    median device ms of the call."""
    import torch
    unet = handles.diffuser.models.unet
    x, t, ctx = _unet_input(unet, handles.diffuser.latent_res, 6)
    ref, checks = None, {}
    for name, mode in CONV_MODES.items():
        # K7 (forward, dx) per call: every eligible conv each way the mode
        # runs K7
        want = (CONV3_SITES * (mode in (True, "mixed")),
                CONV3_SITES * (mode in (True, "hybrid")))
        u = _swapped_unet(unet, conv3x3_kernel=mode) if mode else unet
        reset_launch_counts()
        eps, grad = _latents_grad(u, x, t, ctx)
        torch.cuda.synchronize()
        counts = launch_counts()
        got = (counts["conv3x3_fwd"], counts["conv3x3_dx"])
        ref = ref or (eps, grad)
        err_e, tol_e = _rel_err(eps, ref[0], UNET_RTOL)
        err_g, tol_g = _rel_err(grad, ref[1], UNET_RTOL)
        ms = _device_ms(lambda: _latents_grad(u, x, t, ctx),
                        repeats=CONV_MODE_REPEATS)
        checks[name] = (got == want and _no_general(counts)
                        and err_e <= tol_e and err_g <= tol_g
                        and bool(torch.isfinite(eps).all())
                        and bool(torch.isfinite(grad).all()))
        _line("unet_conv_modes", mode=name, conv3x3_kernel=mode,
              conv3x3_fwd=got[0], conv3x3_dx=got[1], expected=list(want),
              fwd_bwd_ms=ms, max_abs_err_eps=err_e, tol_eps=tol_e,
              max_abs_err_grad=err_g, tol_grad=tol_g, ok=checks[name])
        del u
    if not all(checks.values()):
        raise AssertionError(f"conv modes failed: {checks}")


# Tensor parallelism on the card: two ranks of a process group on this one
# card, the sd2 U-Net sharded over a model axis of 2. NCCL refuses two
# ranks on one device; gloo stages CUDA tensors through the host. A check
# by hand on the card's torch (2.11, two ranks on one H100) found gloo's
# all_reduce, all_gather and broadcast right on CUDA fp32, bf16 and fp16
# tensors, so the phase runs TP_RANKS_ON_CARD ranks; 0 would leave TP=2 to
# the CPU tests (tests/test_torch_port_parallel.py).
TP_RANKS_ON_CARD = 2
TP_DIR = pathlib.Path(__file__).resolve().parent / "build" / "multi_gpu"
# the bands of tests/test_tensor_parallel.py: the forward (fp32) ...
TP_FWD_RTOL, TP_FWD_ATOL = 2e-4, 2e-5
# ... and the gradient, its atol a share of the largest gradient
TP_GRAD_RTOL, TP_GRAD_ATOL = 5e-3, 2e-3


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _in_band(got, want, rtol, atol) -> dict:
    """Elementwise |got - want| <= atol + rtol |want|: the worst excess
    over the bound (<= 0 inside) and the largest error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return {"max_abs_err": err.max().item(),
            "worst_over_band": (err - atol - rtol * want.abs()).max().item()}


def _tp_rank(rank: int, port: int, world: int) -> None:
    """One rank of the TP=2 check (spawned): joins over gloo on card 0,
    builds the sd2 U-Net with the handles' seeded weights in fp32 (TF32
    off), and runs one guidance forward + backward of it sharded over the
    model axis, in fp32 and then with bf16 compute; rank 0 also runs the
    replicated U-Net. Writes its results to TP_DIR."""
    import torch
    import torch.distributed as dist

    from diffusionhandles_tpu_torch.diffuser import seeded_init_
    from diffusionhandles_tpu_torch.models.unet import (UNet2DConditionModel,
                                                        UNetConfig)
    from diffusionhandles_tpu_torch.parallel.distributed import \
        init_distributed
    from diffusionhandles_tpu_torch.parallel.mesh import make_mesh
    from diffusionhandles_tpu_torch.parallel.sharding import shard_unet
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"localhost:{port}", world, rank, local_device_ids=[0],
                     backend="gloo")
    mesh = make_mesh(world, model_parallel=world)
    cfg = UNetConfig(dtype=torch.float32, param_dtype=torch.float32,
                     flash_attention=True)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(cfg)
    seeded_init_(unet, torch.Generator(device="cuda").manual_seed(0))
    unet.eval().requires_grad_(False)
    x, t, ctx = _unet_input(unet, 64, 7)
    res = {"rank": rank, "backend": dist.get_backend()}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        rep = _swapped_unet(unet, dtype=dtype)
        tp = shard_unet(_swapped_unet(unet, dtype=dtype), mesh)
        reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        eps, grad = _latents_grad(tp, x, t, ctx)
        torch.cuda.synchronize()
        row = {"seconds": time.perf_counter() - start,
               "launches": {k: n for k, n in launch_counts().items() if n},
               "param_bytes": sum(p.numel() * p.element_size()
                                  for p in tp.parameters()),
               "replicated_param_bytes": sum(
                   p.numel() * p.element_size() for p in rep.parameters()),
               "replicated_attentions": sum(
                   type(m).__name__ == "Attention" for m in tp.modules()),
               "finite": bool(torch.isfinite(eps).all()
                              and torch.isfinite(grad).all())}
        if rank == 0:
            eps_r, grad_r = _latents_grad(rep, x, t, ctx)
            row["eps"] = _in_band(eps, eps_r, TP_FWD_RTOL, TP_FWD_ATOL)
            row["grad"] = _in_band(
                grad, grad_r, TP_GRAD_RTOL,
                TP_GRAD_ATOL * max(grad_r.abs().max().item(), 1.0))
            row["eps_rel"] = _rel_err(eps, eps_r, UNET_RTOL)
            row["grad_rel"] = _rel_err(grad, grad_r, UNET_RTOL)
        res[name] = row
        del rep, tp
    TP_DIR.mkdir(parents=True, exist_ok=True)
    with open(TP_DIR / f"rank{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase_multi_gpu(handles, batched) -> None:
    """Multi-GPU editing as far as one card shows it. (1) A world of one
    over NCCL in this process, joined under the env contract
    (maybe_init_from_env): edit_batch of the batched phase's transforms
    with mesh=make_mesh(1) must equal its mesh=None images bitwise. (2)
    TP_RANKS_ON_CARD ranks over gloo on this card (_tp_rank): the sharded
    U-Net's eps within the forward band of the replicated one's and its
    latents' gradient within the gradient band (fp32), bf16 within
    UNET_RTOL; each rank's parameter bytes, replicated attentions and K1/K2
    launches. (3) The number of cards: figures across cards need more than
    one."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from diffusionhandles_tpu_torch.parallel.batch import edit_batch
    from diffusionhandles_tpu_torch.parallel.distributed import \
        maybe_init_from_env
    from diffusionhandles_tpu_torch.parallel.mesh import make_mesh
    args, transforms, want = batched
    env = {"DIFFHANDLES_COORDINATOR": f"localhost:{_free_port()}",
           "DIFFHANDLES_NUM_PROCESSES": "1", "DIFFHANDLES_PROCESS_ID": "0"}
    os.environ.update(env)
    try:
        info = maybe_init_from_env()
        backend = dist.get_backend()
        mesh = make_mesh(1)
        reset_launch_counts()
        imgs, seconds = _timed(lambda: edit_batch(
            handles, *args, transforms, mesh, chunk=4))
        launches = launch_counts()
    finally:
        for k in env:
            os.environ.pop(k)
        if dist.is_initialized():
            dist.destroy_process_group()
    world1 = {"info": info, "backend": backend, "mesh": list(mesh.shape),
              "seconds": seconds, "flash_fwd": launches["flash_fwd"],
              "flash_bwd": launches["flash_bwd"],
              "bitwise_mesh_none": bool(np.array_equal(imgs, want))}
    checks = {"world1_nccl": backend == "nccl",
              "world1_bitwise": world1["bitwise_mesh_none"]}

    tp = {"tp_ranks_on_card": TP_RANKS_ON_CARD}
    if TP_RANKS_ON_CARD:
        _free_device_memory()
        for old in TP_DIR.glob("rank*.json"):
            old.unlink()
        start = time.perf_counter()
        mp.spawn(_tp_rank, args=(_free_port(), TP_RANKS_ON_CARD),
                 nprocs=TP_RANKS_ON_CARD)
        tp["seconds"] = time.perf_counter() - start
        ranks = [json.loads((TP_DIR / f"rank{r}.json").read_text())
                 for r in range(TP_RANKS_ON_CARD)]
        tp["ranks"] = ranks
        r0 = ranks[0]
        checks.update({
            "tp_gloo": all(r["backend"] == "gloo" for r in ranks),
            "tp_finite": all(r[d]["finite"] for r in ranks
                             for d in ("fp32", "bf16")),
            "tp_fp32_eps_in_band": r0["fp32"]["eps"]["worst_over_band"] <= 0,
            "tp_fp32_grad_in_band": (r0["fp32"]["grad"]["worst_over_band"]
                                     <= 0),
            "tp_bf16_within_unet_rtol": all(
                r0["bf16"][k][0] <= r0["bf16"][k][1]
                for k in ("eps_rel", "grad_rel")),
            "tp_k1_k2_each_rank": all(
                r["bf16"]["launches"].get("flash_fwd", 0) > 0
                and r["bf16"]["launches"].get("flash_bwd", 0) > 0
                for r in ranks),
            "tp_params_sharded": all(
                r["fp32"]["param_bytes"]
                < 0.6 * r["fp32"]["replicated_param_bytes"] for r in ranks)})
    else:
        tp["reason"] = ("gloo in this torch refuses a CUDA collective the "
                        "TP path needs (hand check)")
    _line("multi_gpu", world1=world1, tp=tp,
          device_count=torch.cuda.device_count(), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"multi-GPU checks failed: {checks}")


# The test-set phase. ZoeDepth-NK and big-LaMa run fp32 with TF32 off, on
# the card and on the CPU on the same weights; the two differ only in the
# order of their fp32 sums (cuDNN, cuBLAS and cuFFT against ATen's CPU
# kernels), ~1e-6 relative a layer. The card's depth is held to the CPU's
# within ZOE_DEPTH_RTOL of max_depth (80 m) with the same domain chosen
# per pass; the inpainted image within LAMA_ATOL on [0, 1]. An EXR depth
# is half-float: it is held to the estimate within EXR_RTOL (2**-10 of
# each value, half's precision).
ZOE_DEPTH_RTOL = 1e-3
LAMA_ATOL = 1e-3
EXR_RTOL = 2.0 ** -10
TESTSET_TRANSFORMS = {
    "rotate": {"rotation_angle": 20.0, "rotation_axis": [0.0, 1.0, 0.0],
               "translation": [0.0, 0.0, 0.1]},
    "shift": {"rotation_angle": 0.0, "rotation_axis": [0.0, 1.0, 0.0],
              "translation": [0.08, 0.0, 0.0]},
}


# where the test-set phase writes its sample and outputs (the foreground
# phase reads the sample)
TESTSET_DIR = pathlib.Path(__file__).resolve().parent / "build" / \
    "testset_smoke"


def _testset_sample(root, res: int) -> None:
    """A seeded textured image and a square foreground mask, written with
    the port's image_io; no depth.exr, bg.png or bg_depth.exr, so that the
    estimators must run."""
    import numpy as np

    from diffusionhandles_tpu_torch.utils.image_io import save_image
    d = root / "inputs" / "sample"
    d.mkdir(parents=True)
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res),
                         indexing="ij")
    rng = np.random.RandomState(7)
    img = np.stack([0.5 + 0.3 * np.sin(12 * xx + 3 * k) * np.cos(9 * yy)
                    + 0.15 * (yy - 0.5) for k in range(3)])
    img = np.clip(img + 0.05 * rng.randn(3, res, res), 0, 1)
    save_image(img.astype(np.float32), d / "input.png")
    lo, hi = res // 3, 2 * res // 3
    mask = np.zeros((3, res, res), np.float32)
    mask[:, lo:hi, lo:hi] = 1.0
    save_image(mask, d / "mask.png")
    (d / "prompt.txt").write_text(EDIT_PROMPT + "\n")
    (d / "transforms.json").write_text(json.dumps(TESTSET_TRANSFORMS))
    (root / "set.json").write_text(json.dumps(
        {"sample": list(TESTSET_TRANSFORMS)}))


def _timed_peak(fn):
    """(fn(), seconds to its end on the card, peak bytes above the bytes
    allocated before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out, seconds = _timed(fn)
    return out, seconds, torch.cuda.max_memory_allocated() - before


def _zoedepth_check(img):
    """ZoeDepthEstimator at full width on the card, against the same model
    on the CPU. Returns the estimator."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.models.zoedepth import ZoeDepthEstimator
    est, build_s = _timed(lambda: ZoeDepthEstimator(device="cuda"))
    cfg = est.config
    x = torch.from_numpy(img)
    with torch.no_grad():
        est.model(x.cuda())  # first use
        (depth, probs), seconds, peak = _timed_peak(
            lambda: est.model(x.cuda(), return_domain=True))
        repeatable = bool(torch.equal(est.model(x.cuda()), depth))
        cpu = ZoeDepthEstimator(cfg, params={
            k: v.cpu() for k, v in est.model.nk.state_dict().items()},
            device="cpu")
        (depth_cpu, probs_cpu), cpu_seconds = _timed(
            lambda: cpu.model(x, return_domain=True))
    depth, probs = depth.cpu().numpy(), probs.cpu().numpy()
    depth_cpu, probs_cpu = depth_cpu.numpy(), probs_cpu.numpy()
    err = float(np.abs(depth - depth_cpu).max())
    names = [bc.name for bc in cfg.bin_confs]
    domain = probs.argmax(-1)
    # the share of pixels at each clip bound (the domains' and the final)
    bounds = sorted({b for bc in cfg.bin_confs
                     for b in (bc.min_depth, bc.max_depth)})
    at_bound = {str(b): float(np.isclose(depth, b, rtol=1e-6, atol=0).mean())
                for b in bounds}
    checks = {
        "shape": depth.shape == img.shape[:1] + img.shape[2:],
        "finite": bool(np.isfinite(depth).all()),
        "same_domain_per_pass": bool(np.array_equal(
            domain, probs_cpu.argmax(-1))),
        "repeatable_bitwise": repeatable,
        "depth_vs_cpu": err <= ZOE_DEPTH_RTOL * cfg.max_depth,
    }
    _line("testset_zoedepth", build_seconds=build_s, seconds=seconds,
          flip_batch=2 * img.shape[0], peak_bytes=peak,
          cpu_seconds=cpu_seconds, image_size=cfg.backbone.image_size,
          domains=names, domain_probs=probs.tolist(),
          domain_probs_cpu=probs_cpu.tolist(),
          chosen=[names[i] for i in domain], max_abs_err=err,
          tol=ZOE_DEPTH_RTOL * cfg.max_depth, share_at_bound=at_bound,
          depth_range=[float(depth.min()), float(depth.max())],
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"ZoeDepth checks failed: {checks}")
    return est


def _lama_check(img, mask):
    """LamaInpainter (big-LaMa) at full size on the card, against the same
    model on the CPU. Returns the inpainter."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.models.lama import LamaInpainter
    from diffusionhandles_tpu_torch.ops.morphology import \
        binary_dilation_iter
    lama, build_s = _timed(lambda: LamaInpainter(device="cuda"))
    lama.remove_foreground(img, mask, dilation=3)  # first use
    out, seconds, peak = _timed_peak(
        lambda: lama.remove_foreground(img, mask, dilation=3))
    repeatable = bool(np.array_equal(
        lama.remove_foreground(img, mask, dilation=3), out))
    cpu = LamaInpainter(lama.config, params={
        k: v.cpu() for k, v in lama.model.state_dict().items()},
        device="cpu")
    out_cpu, cpu_seconds = _timed(
        lambda: cpu.remove_foreground(img, mask, dilation=3))
    hole = binary_dilation_iter(torch.from_numpy(mask[0, 0]) > 0.5,
                                3).numpy()
    keep = np.broadcast_to(~hole, out.shape)
    err = float(np.abs(out - out_cpu).max())
    checks = {
        "shape": out.shape == img.shape,
        "finite": bool(np.isfinite(out).all()),
        "known_pixels_bitwise": bool(np.array_equal(out[keep], img[keep])),
        "repeatable_bitwise": repeatable,
        "vs_cpu": err <= LAMA_ATOL,
    }
    _line("testset_lama", build_seconds=build_s, seconds=seconds,
          peak_bytes=peak, cpu_seconds=cpu_seconds,
          n_blocks=lama.config.n_blocks, size=list(img.shape[2:]),
          hole_share=float(hole.mean()), max_abs_err=err, tol=LAMA_ATOL,
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"LaMa checks failed: {checks}")
    return lama


def phase_testset(handles):
    """The test-set path on the default handles (see the module
    docstring, 4c). Returns its ZoeDepth and LaMa models (the service
    phase serves them)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.checkpoint import load_identity, to_nchw
    from diffusionhandles_tpu_torch.testset.driver import \
        test_diffusion_handles as run_test_set
    from diffusionhandles_tpu_torch.testset.preprocess import estimate_depth
    from diffusionhandles_tpu_torch.utils.image_io import (load_depth,
                                                           load_image,
                                                           read_png)
    root = TESTSET_DIR
    shutil.rmtree(root, ignore_errors=True)
    res = handles.img_res
    _testset_sample(root, res)
    sdir = root / "inputs" / "sample"
    img = load_image(sdir / "input.png")[None]
    mask = load_image(sdir / "mask.png")[:1][None]

    _free_device_memory()
    est = _zoedepth_check(img)
    estimate_depth(str(sdir / "input.png"), str(root / "depth.exr"),
                   estimator=est)
    exr_depth = load_depth(root / "depth.exr")[None]
    exr_ok = bool(np.allclose(exr_depth, est.estimate_depth(img),
                              rtol=EXR_RTOL, atol=0))
    lama = _lama_check(img, mask)

    saved_tmp = tempfile.tempdir
    tempfile.tempdir = str(root / "tmp")  # the identity cache's home
    (root / "tmp").mkdir()
    inversions = []
    real_invert = handles.invert_input_image
    handles.invert_input_image = lambda *a, **k: (
        inversions.append(1), real_invert(*a, **k))[1]
    runs = []
    try:
        for name in ("first", "cached"):
            reset_launch_counts()
            _, seconds = _timed(lambda: run_test_set(
                test_set_path=str(root / "set.json"),
                input_dir=str(root / "inputs"),
                output_dir=str(root / name), handles=handles, img_res=res,
                cache_input_image_identity=True, depth_estimator=est,
                foreground_remover=lama, generate_webpage=name == "first"))
            metrics = json.loads((root / name / "metrics.json").read_text())
            runs.append(dict(seconds=seconds, launches=launch_counts(),
                             inversions=len(inversions),
                             sample=metrics["samples"]["sample"]))
            if name == "first":
                rec = handles._recording
    finally:
        tempfile.tempdir = saved_tmp
        del handles.invert_input_image
    ident = load_identity(root / "tmp" / "diffhandles" / "set" / "sample"
                          / "input_image_identity.npz")
    as_np = lambda t: t.float().cpu().numpy()
    ident_equal = {
        "null_text_emb": np.array_equal(ident["null_text_emb"],
                                        as_np(rec["null"])),
        "init_noise": np.array_equal(to_nchw(ident["init_noise"]),
                                     as_np(rec["noise"])),
        "activations": all(np.array_equal(to_nchw(a), as_np(b)) for a, b in
                           zip(ident["activations"], rec["acts"])),
        "latent_image": np.array_equal(to_nchw(ident["latent_image"]),
                                       as_np(rec["latents"])),
    }
    files = ["disparity.png", "recon.png"] + [
        f"{t}{s}.png" for t in TESTSET_TRANSFORMS for s in ("", "_disparity")]
    same = {f: bool(np.array_equal(read_png(root / "first" / "sample" / f),
                                   read_png(root / "cached" / "sample" / f)))
            for f in files}
    first = runs[0]["launches"]
    checks = {
        "exr_depth_vs_estimate": exr_ok,
        "outputs": all((root / "first" / "sample" / f).exists()
                       for f in files),
        "gallery": (root / "first" / "set_summary.html").exists(),
        "first_run_inverts": runs[0]["inversions"] == 1,
        "cached_run_reads_the_cache": runs[1]["inversions"] == 1,
        "cached_run_bitwise": all(same.values()),
        "k1_k2_launched": first["flash_fwd"] > 0 and first["flash_bwd"] > 0,
        "no_general_route": _no_general(first),
        "identity_npz_equal": all(ident_equal.values()),
        "recon_scores_finite": all(np.isfinite(runs[0]["sample"][k])
                                   for k in ("recon_psnr_db", "recon_ssim")),
    }
    for r, name in zip(runs, ("first", "cached")):
        _line("testset_driver", run=name, seconds=r["seconds"],
              sample_seconds=r["sample"]["seconds"],
              recon_psnr_db=r["sample"]["recon_psnr_db"],
              recon_ssim=r["sample"]["recon_ssim"],
              transforms=len(TESTSET_TRANSFORMS),
              flash_fwd=r["launches"]["flash_fwd"],
              flash_bwd=r["launches"]["flash_bwd"])
    _line("testset", identity_equal=ident_equal, cached_run_bitwise=same,
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"testset checks failed: {checks}")
    return est, lama


# The service phase. The five services run in this process on free
# loopback ports (each binds port 0), on the models of the phases before:
# the core on the default handles, depth on the test-set phase's
# ZoeDepth-NK, the remover on its big-LaMa, the selector on a seeded CLIP
# segmenter at ViT-B/16 widths, text2img on a seeded 10-step SD-2.
# DiffhandlesPipeline drives them over HTTP; every response must be the
# bits of the same call made here in the process on the same objects.
# The soft raster (K = SOFT_K, softmax blending, PyTorch3D's sigma and
# gamma) of the rgb preview's scene on the card is held to the port on
# the CPU: its elementwise fp32 geometry differs only where the card
# contracts a product into an FMA, which moves z by an ulp and can swap
# two fragments within an ulp of each other (at most SOFT_FID_SHARE of
# the fragments); where every level has the same face, the blended color
# is held within SOFT_COLOR_ATOL (an ulp of z_inv is 6e-4 of a weight at
# gamma 1e-4) and alpha within SOFT_ALPHA_ATOL. LPIPS at 512x512 (fp32,
# TF32 off) is held to the CPU within LPIPS_RTOL.
SOFT_K = 4
SOFT_FID_SHARE = 1e-3
SOFT_COLOR_ATOL = 2e-3
SOFT_ALPHA_ATOL = 1e-5
LPIPS_RTOL = 1e-4


def _start_services(handles, est, lama, seg, t2i):
    """The five services on free loopback ports: ({name: app}, pipeline
    over them)."""
    from diffusionhandles_tpu_torch.service import services
    from diffusionhandles_tpu_torch.service.pipeline_app import \
        DiffhandlesPipeline
    apps = {"diffhandles": services.DiffhandlesWebapp(handles=handles,
                                                      port=0),
            "depth": services.DepthEstimatorWebapp(estimator=est, port=0),
            "remover": services.ForegroundRemoverWebapp(remover=lama, port=0),
            "selector": services.ForegroundSelectorWebapp(selector=seg,
                                                          port=0),
            "text2img": services.Text2ImgWebapp(generator=t2i, port=0)}
    for app in apps.values():
        app.start_background()
    url = {k: f"http://127.0.0.1:{a.port}" for k, a in apps.items()}
    pipeline = DiffhandlesPipeline(
        diffhandles_url=url["diffhandles"], depth_url=url["depth"],
        remover_url=url["remover"], selector_url=url["selector"],
        text2img_url=url["text2img"], device=handles.device)
    return apps, pipeline


# each client method of the pipeline, and the service that answers it
SERVICE_CALLS = (("diffhandles", "diffhandles", "set_input_image"),
                 ("diffhandles", "diffhandles", "set_foreground"),
                 ("diffhandles", "diffhandles", "transform_foreground"),
                 ("depth_estimator", "depth", "estimate_depth"),
                 ("remover", "remover", "remove_foreground"),
                 ("selector", "selector", "select_foreground"),
                 ("text2img", "text2img", "generate"))


def _record_requests(pipeline, apps) -> list:
    """Wrap the pipeline's client methods to record each request: its
    arguments and response, the client's wall seconds and body bytes, and
    the handler's seconds from its service."""
    requests = []
    for attr, service, method in SERVICE_CALLS:
        client = getattr(pipeline, attr)

        def call(*args, _fn=getattr(client, method), _client=client,
                 _app=apps[service], _name=f"{service}/{method}", **kwargs):
            out = _fn(*args, **kwargs)
            requests.append(dict(name=_name, args=args, kwargs=kwargs,
                                 out=out, client=dict(_client.last_call),
                                 server=dict(_app.last_request)))
            return out
        setattr(client, method, call)
    return requests


def _request_line(req, bitwise: bool) -> None:
    wall = req["client"]["seconds"]
    handler = req["server"]["handler_seconds"]
    _line("service_request", request=req["name"], seconds=wall,
          handler_seconds=handler,
          encode_transport_decode_seconds=wall - handler,
          request_bytes=req["client"]["request_bytes"],
          response_bytes=req["client"]["response_bytes"],
          attempts=req["client"]["attempts"], bitwise_in_process=bitwise)


def _same(a, b) -> bool:
    """Equal bits: arrays, byte strings, or dicts of them."""
    import numpy as np
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, bytes):
        return a == b
    return bool(np.array_equal(a, b)) and np.asarray(a).dtype == \
        np.asarray(b).dtype


def _identity_matches(blob, null, noise, acts, latents) -> dict:
    """Each field of an identity npz against the tensors it was made
    from (NCHW, stored fp32)."""
    import io

    import numpy as np
    as_np = lambda t: t.float().cpu().numpy()
    with np.load(io.BytesIO(blob)) as data:
        got = {k: data[k] for k in data.files}
    want = {"null_text_emb": null, "init_noise": noise,
            "latent_image": latents,
            **{f"activations{i + 1}": a for i, a in enumerate(acts)}}
    return {k: bool(np.array_equal(got[k], as_np(v)))
            for k, v in want.items()}


def _preview_scene(state, device):
    """The rgb preview's merged mesh (colored bg grid, colored and moved
    fg) on `device`, and the intrinsics."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.diffuser import GuidedStableDiffuser
    from diffusionhandles_tpu_torch.geometry.mesh import depth_to_mesh
    from diffusionhandles_tpu_torch.geometry.mesh_transform import \
        merge_meshes
    from diffusionhandles_tpu_torch.geometry.transform import \
        transform_points
    K = GuidedStableDiffuser.get_depth_intrinsics()
    img, bg_img = state.img[0], state.bg_img[0]
    h, w = img.shape[-2:]
    mask2d = state.fg_mask.reshape(h, w) > 0.5
    color = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    bg = depth_to_mesh(state.bg_depth, K, device=device)
    bg.add_vert_attribute("color", color(bg_img.reshape(3, -1).T))
    fg = depth_to_mesh(state.depth, K, mask=mask2d, device=device)
    fg.add_vert_attribute("color", color(
        img.reshape(3, -1).T[mask2d.reshape(-1)]))
    fg.verts = transform_points(
        fg.verts, EDIT_TRANSFORM["rot_angle"],
        np.asarray(EDIT_TRANSFORM["rot_axis"], np.float32),
        np.asarray(EDIT_TRANSFORM["translation"], np.float32))
    return merge_meshes(bg, fg), K


def _soft_raster_check(state, device) -> dict:
    """rasterize_k (SOFT_K levels) of the rgb preview's scene at 512x512
    on `device` (the card) and its softmax blend of the vertex colors (the
    renderer's 'softmax' blend_type, PyTorch3D's sigma and gamma), against
    the same on the CPU."""
    import numpy as np

    from diffusionhandles_tpu_torch.ops.rasterize import (
        big_faces, interpolate_attribute_k, project_verts, rasterize_k,
        softmax_blend_weights)
    res = state.img.shape[-1]
    out = {}
    for dev in ("card", "cpu"):
        mesh, K = _preview_scene(state, device if dev == "card" else "cpu")
        verts_px = project_verts(mesh.verts, K, res, res)
        run = lambda: rasterize_k(verts_px, mesh.faces, res, res,
                                  faces_per_pixel=SOFT_K)

        def blend(kr):
            w, _, alpha = softmax_blend_weights(kr)
            color = interpolate_attribute_k(kr, mesh.faces,
                                            mesh.vert_attributes["color"])
            return (w[..., None] * color).sum(0), alpha

        if dev == "card":
            blend(run())  # first use
            kr, seconds, peak = _timed_peak(run)
        else:
            kr, seconds = _timed(run)
            peak = None
        (color, alpha), blend_s = _timed(lambda: blend(kr))
        out[dev] = dict(fid=kr.face_id.cpu().numpy(),
                        zbuf=kr.zbuf.cpu().numpy(),
                        color=color.cpu().numpy(), alpha=alpha.cpu().numpy(),
                        seconds=seconds, blend_seconds=blend_s, peak=peak,
                        faces=int(mesh.faces.shape[0]),
                        big=int(big_faces(verts_px, mesh.faces).numel()))
    g, c = out["card"], out["cpu"]
    frags = int((c["fid"] >= 0).sum())
    differ = int((g["fid"] != c["fid"]).sum())
    agree = (g["fid"] == c["fid"]).all(0)
    color_err = float(np.abs(g["color"] - c["color"])[agree].max())
    alpha_err = float(np.abs(g["alpha"] - c["alpha"])[agree].max())
    both = (g["fid"] >= 0) & (g["fid"] == c["fid"])
    zbuf_err = float(np.abs(g["zbuf"][both] - c["zbuf"][both]).max())
    checks = {
        "fragments_differ_within_bound": differ <= SOFT_FID_SHARE * frags,
        "every_level_filled": bool((g["fid"][-1] >= 0).any()),
        "color_within_tol": color_err <= SOFT_COLOR_ATOL,
        "alpha_within_tol": alpha_err <= SOFT_ALPHA_ATOL,
        "finite": bool(np.isfinite(g["color"]).all()),
    }
    _line("service_soft_raster", faces_per_pixel=SOFT_K, res=res,
          faces=g["faces"], big_faces=g["big"], seconds=g["seconds"],
          peak_bytes=g["peak"], blend_seconds=g["blend_seconds"],
          cpu_seconds=c["seconds"], cpu_blend_seconds=c["blend_seconds"],
          fragments=frags, fragments_differ=differ,
          tol_fragments=SOFT_FID_SHARE * frags,
          pixels_all_levels_agree=float(agree.mean()),
          zbuf_max_abs_err=zbuf_err, color_max_abs_err=color_err,
          tol_color=SOFT_COLOR_ATOL, alpha_max_abs_err=alpha_err,
          tol_alpha=SOFT_ALPHA_ATOL, checks=checks)
    return checks


def _lpips_check(a, b, device) -> dict:
    """LPIPSMetric (seeded VGG16) at 512x512 on `device` (the card)
    against the same weights on the CPU."""
    from diffusionhandles_tpu_torch.models.lpips import LPIPSMetric
    metric = LPIPSMetric(device=device)
    metric(a, b)  # first use
    d, seconds, peak = _timed_peak(lambda: metric(a, b))
    cpu = LPIPSMetric(params=_cpu_copy(metric.model), device="cpu")
    d_cpu, cpu_seconds = _timed(lambda: cpu(a, b))
    checks = {"finite_positive": d > 0 and d == d,
              "vs_cpu": abs(d - d_cpu) <= LPIPS_RTOL * abs(d_cpu),
              "self_distance_zero": metric(a, a) == 0.0}
    _line("service_lpips", size=list(a.shape[-2:]), distance=d,
          distance_cpu=d_cpu, rel_err=abs(d - d_cpu) / abs(d_cpu),
          tol=LPIPS_RTOL, seconds=seconds, peak_bytes=peak,
          cpu_seconds=cpu_seconds, checks=checks)
    return checks


def _service_models():
    """The selector's and text2img's models: a seeded CLIPSegmenter at
    ViT-B/16 widths and a seeded TEXT2IMG_STEPS-step SD-2 on the card."""
    from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig
    from diffusionhandles_tpu_torch.models.segmenter import CLIPSegmenter
    from diffusionhandles_tpu_torch.models.text2img import StableText2Img
    from diffusionhandles_tpu_torch.models.weights_clip import clip_vit_b16
    return (CLIPSegmenter(*clip_vit_b16(), device="cuda"),
            StableText2Img(GuidedDiffuserConfig(
                use_depth=False, num_timesteps=TEXT2IMG_STEPS),
                device="cuda"))


def phase_service(handles, est, lama, seg, t2i, root) -> dict:
    """The service layer (module docstring, 4e) on the test-set sample
    under `root`, with the models given, on the handles' device. Returns
    the K1/K2 launches of the transform request."""
    import io

    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.checkpoint import load_identity, to_nchw
    from diffusionhandles_tpu_torch.geometry.mesh import depth_to_mesh
    from diffusionhandles_tpu_torch.geometry.mesh_io import save_mesh_glb
    from diffusionhandles_tpu_torch.utils.image_io import load_image
    sdir = root / "inputs" / "sample"
    img = load_image(sdir / "input.png")[None]
    mask = load_image(sdir / "mask.png")[:1][None]
    prompt = EDIT_PROMPT
    apps, pipeline = _start_services(handles, est, lama, seg, t2i)
    requests = _record_requests(pipeline, apps)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    same, steps = {}, {}
    state = pipeline.state
    try:
        # 1. depth, then the inversion
        _, steps["set_input_image"] = _timed(
            lambda: pipeline.set_input_image(img, prompt))
        rec = handles._recording
        ident_vs_inversion = _identity_matches(
            state.input_image_identity, rec["null"], rec["noise"],
            rec["acts"], rec["latents"])
        n = len(requests)
        # 2. the foreground from the selector, then the sample's mask
        _, steps["set_foreground_prompt"] = _timed(
            lambda: pipeline.set_foreground(fg_prompt=FG_PROMPT))
        selected = state.fg_mask
        _, steps["set_foreground_mask"] = _timed(
            lambda: pipeline.set_foreground(fg_mask=mask))
        raw_bg = requests[-2]["out"]
        # 3. the meshes of the core's set_foreground
        meshes = pipeline.diffhandles.set_foreground(
            state.depth, state.fg_mask, raw_bg, export_meshes=True)
        # 4. the edit, its launches counted alone
        reset_launch_counts()
        (edited, _), steps["transform_foreground"] = _timed(
            lambda: pipeline.transform_foreground(**EDIT_TRANSFORM))
        launches = launch_counts()
        # 5. the previews, in the process on the card
        previews = {}
        for mode in ("depth", "rgb"):
            pipeline.preview_edit(mode=mode, **EDIT_TRANSFORM)  # first use
            previews[mode], steps[f"preview_{mode}"] = _timed(
                lambda: pipeline.preview_edit(mode=mode, **EDIT_TRANSFORM))
        # 6. text2img
        generated, steps["generate"] = _timed(
            lambda: pipeline.text2img.generate(FG_PROMPT, seed=0))
        peak = torch.cuda.max_memory_allocated()
    finally:
        for app in apps.values():
            app.shutdown()

    # each response against the same call made here
    calls = {
        "depth/estimate_depth": lambda a, k: est.estimate_depth(*a, **k),
        "remover/remove_foreground":
            lambda a, k: lama.remove_foreground(*a, **k),
        "selector/select_foreground":
            lambda a, k: seg.select_foreground(*a, **k),
        "text2img/generate": lambda a, k: t2i.generate(*a, **k),
    }

    def core_set_foreground(a, k):
        depth, fg_mask, bg_depth = (np.asarray(x, np.float32) for x in a[:3])
        out = {"bg_depth_harmonized": handles.set_foreground(
            depth, fg_mask, bg_depth)}
        if k.get("export_meshes"):
            intr = handles.diffuser.get_depth_intrinsics()
            for name, d, m in (("bg_depth_mesh", bg_depth, None),
                               ("fg_depth_mesh", depth, fg_mask[0, 0])):
                path = root / f"{name}.glb"
                save_mesh_glb(path, depth_to_mesh(d, intr, mask=m,
                                                  device=handles.device))
                out[name] = path.read_bytes()
        return out

    def core_transform(a, k):
        ident = load_identity(io.BytesIO(a[0]))
        out = handles.transform_foreground(
            depth=a[1], prompt=a[2], fg_mask=a[3], bg_depth=a[4],
            null_text_emb=ident["null_text_emb"],
            init_noise=to_nchw(ident["init_noise"]),
            activations=[to_nchw(x) for x in ident["activations"]],
            rot_angle=float(k["rot_angle"]),
            rot_axis=np.asarray(k["rot_axis"], np.float32),
            translation=np.asarray(k["translation"], np.float32),
            fg_weight=k["fg_weight"], bg_weight=k["bg_weight"])
        return dict(zip(("edited_img", "edited_disparity"), out))

    calls["diffhandles/set_foreground"] = core_set_foreground
    calls["diffhandles/transform_foreground"] = core_transform
    for i, req in enumerate(requests):
        if req["name"] == "diffhandles/set_input_image":
            a = req["args"]
            null, noise = handles.invert_input_image(*a)
            null, noise, acts, latents = handles.generate_input_image(
                a[1], a[2], null, noise)
            match = _identity_matches(req["out"], null, noise, acts, latents)
            bitwise = all(match.values())
        else:
            bitwise = _same(req["out"], calls[req["name"]](req["args"],
                                                           req["kwargs"]))
        same[f"{i}:{req['name']}"] = bitwise
        _request_line(req, bitwise)
    identity_bytes = requests[n - 1]["client"]["response_bytes"]

    res = handles.img_res
    checks = {
        "every_request_bitwise_in_process": all(same.values()),
        # depth + core; selector, remover, depth, core; remover, depth,
        # core; the meshes; the edit; text2img
        "requests_answered": len(requests) == 12,
        "identity_loads_to_the_inversion": all(ident_vs_inversion.values()),
        "k1_k2_in_transform_request": launches["flash_fwd"] > 0
        and launches["flash_bwd"] > 0,
        "no_general_route": _no_general(launches),
        "edited_shape_finite": edited.shape == (1, 3, res, res)
        and bool(np.isfinite(edited).all()),
        "selected_mask_binary": set(np.unique(selected)) <= {0.0, 1.0},
        "meshes_glb": all(meshes[k][:4] == b"glTF" for k in
                          ("bg_depth_mesh", "fg_depth_mesh")),
        "preview_depth": previews["depth"].shape == (1, 1, res, res)
        and 0.0 <= previews["depth"].min() <= previews["depth"].max() <= 1.0,
        "preview_rgb": previews["rgb"].shape == (1, 3, res, res)
        and bool(np.isfinite(previews["rgb"]).all()),
        "generated": generated.shape == (1, 3, res, res),
    }
    checks.update(_soft_raster_check(state, handles.device))
    checks.update(_lpips_check(img, edited, handles.device))
    checks = {k: bool(v) for k, v in checks.items()}
    _line("service", seconds=steps,
          requests=len(requests), identity_npz_bytes=identity_bytes,
          flash_fwd=launches["flash_fwd"], flash_bwd=launches["flash_bwd"],
          peak_bytes=peak, resident_bytes=resident,
          identity_vs_inversion=ident_vs_inversion, bitwise=same,
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"service checks failed: {checks}")
    return {k: launches[k] for k in ("flash_fwd", "flash_bwd")}


# The foreground phase. CLIP ViT-B/16, SAM ViT-H and GroundingDINO (Swin-T
# OGC) run fp32 with TF32 off, on the card and on the CPU on the same
# seeded weights; the two differ in the order of their fp32 sums. The
# similarity map (a cosine) is held within FG_SIM_ATOL; SAM's mask logits
# and GroundingDINO's logits within FG_LOGIT_RTOL of their largest
# magnitude, SAM's IoU within FG_IOU_ATOL and GroundingDINO's cxcywh boxes
# within FG_BOX_ATOL (units of the image). A thresholded mask equals the
# CPU's but where the card's value lies within that tolerance of the
# threshold; those pixels are counted. GroundingDINO's 900 selected
# proposals must be the CPU's, in the CPU's order, but for pairs whose CPU
# scores lie within FG_LOGIT_RTOL of the largest score of each other (not
# rows tied on both devices): a sum in another order may swap such a
# pair, and with it the pair's queries, so its logits and boxes are held
# against the CPU decoding the card's selection.
FG_PROMPT = "a toy cube"
FG_SIM_ATOL = 1e-4
FG_LOGIT_RTOL = 1e-3
FG_IOU_ATOL = 1e-3
FG_BOX_ATOL = 1e-3
TEXT2IMG_STEPS = 10


def _flips(got, want, value, tol, thresh=0.0):
    """(pixels where the masks differ, of those away from the threshold)."""
    import numpy as np
    differ = np.asarray(got) != np.asarray(want)
    away = differ & (np.abs(np.asarray(value) - thresh) > tol)
    return int(differ.sum()), int(away.sum())


def _cpu_copy(module):
    return {k: v.cpu() for k, v in module.state_dict().items()}


def _clip_check(img):
    """CLIPSegmenter at ViT-B/16 widths on the card, against the same
    segmenter on the CPU."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.models.segmenter import CLIPSegmenter
    from diffusionhandles_tpu_torch.models.weights_clip import clip_vit_b16
    icfg, tcfg = clip_vit_b16()
    seg, build_s = _timed(lambda: CLIPSegmenter(icfg, tcfg, device="cuda"))
    seg.similarity_map(img, FG_PROMPT)  # first use
    sim, seconds, peak = _timed_peak(lambda: seg.similarity_map(img,
                                                                FG_PROMPT))
    cpu = CLIPSegmenter(icfg, tcfg, image_params=_cpu_copy(seg.image_model),
                        text_params=_cpu_copy(seg.text_model), device="cpu")
    sim_cpu, cpu_seconds = _timed(lambda: cpu.similarity_map(img, FG_PROMPT))
    mask = seg.select_foreground(img, FG_PROMPT)
    mask_cpu = cpu.select_foreground(img, FG_PROMPT)
    lo, hi = np.percentile(sim_cpu[0], [5, 95])
    flips, away = _flips(sim[0] > (lo + hi) / 2, sim_cpu[0] > (lo + hi) / 2,
                         sim[0], FG_SIM_ATOL, (lo + hi) / 2)
    err = float(np.abs(sim - sim_cpu).max())
    checks = {
        "shape": sim.shape == (1,) + img.shape[2:],
        "finite": bool(np.isfinite(sim).all()),
        "sim_vs_cpu": err <= FG_SIM_ATOL,
        "split_flips_at_threshold_only": away == 0,
        "mask_vs_cpu": flips > 0 or bool(np.array_equal(mask, mask_cpu)),
    }
    _line("foreground_clip", widths="clip_vit_b16", build_seconds=build_s,
          seconds=seconds, peak_bytes=peak, cpu_seconds=cpu_seconds,
          max_abs_err=err, tol=FG_SIM_ATOL, split_flips=flips,
          mask_share=float(mask.mean()), tf32=torch.backends.cuda.matmul.
          allow_tf32, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"CLIP segmenter checks failed: {checks}")


def _sam_run(sam, x, box):
    """(embedding, mask logits, iou) of SamModel on a preprocessed input
    and one box prompt, with no point token."""
    import torch
    dev = x.device
    with torch.no_grad():
        emb = sam.model.embed(x)
        masks, iou = sam.model.decode(
            emb, torch.zeros(1, 0, 2, device=dev),
            torch.zeros(1, 0, dtype=torch.long, device=dev),
            torch.as_tensor(box, device=dev).reshape(1, 2, 2))
    return emb, masks, iou


def _sam_check(img, box):
    """PromptableSegmenter(sam_vit_h()) at 1024 on the card: embed and a
    box-prompted decode timed, the predictor's mask; held to the whole
    ViT-H on the CPU (about 20 s there). Returns the segmenter."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.models.sam import (PromptableSegmenter,
                                                       sam_vit_h)
    sam, build_s = _timed(lambda: PromptableSegmenter(sam_vit_h(),
                                                      device="cuda"))
    x, _, scale = sam._preprocess(img)
    box_in = np.asarray(box, np.float32) * scale
    _sam_run(sam, x, box_in)  # first use
    with torch.no_grad():
        emb, embed_s, embed_peak = _timed_peak(lambda: sam.model.embed(x))
        _, decode_s, decode_peak = _timed_peak(lambda: sam.model.decode(
            emb, torch.zeros(1, 0, 2, device="cuda"),
            torch.zeros(1, 0, dtype=torch.long, device="cuda"),
            torch.as_tensor(box_in, device="cuda").reshape(1, 2, 2)))
    (logits, iou), predict_s = _timed(lambda: sam.mask_logits(img,
                                                              boxes=box))
    cpu = PromptableSegmenter(sam.config, params=_cpu_copy(sam.model),
                              device="cpu")
    _, m_card, i_card = _sam_run(sam, x, box_in)
    (_, m_cpu, i_cpu), cpu_seconds = _timed(lambda: _sam_run(cpu, x.cpu(),
                                                            box_in))
    lg_cpu, iou_cpu = cpu.mask_logits(img, boxes=box)
    m_card, m_cpu = m_card.cpu().numpy(), m_cpu.numpy()
    scale_lg = float(np.abs(m_cpu).max())
    err = float(np.abs(m_card - m_cpu).max())
    iou_err = float(np.abs(i_card.cpu().numpy() - i_cpu.numpy()).max())
    tol = FG_LOGIT_RTOL * scale_lg
    flips, away = _flips(logits > 0, lg_cpu > 0, logits, tol)
    checks = {
        "finite": bool(np.isfinite(logits).all()
                       and np.isfinite(emb.cpu().numpy()).all()),
        "mask_shape": logits.shape == (1,) + img.shape[2:],
        "logits_vs_cpu": bool(err <= tol),
        "iou_vs_cpu": bool(iou_err <= FG_IOU_ATOL
                           and abs(iou - iou_cpu) <= FG_IOU_ATOL),
        "mask_flips_at_threshold_only": away == 0,
    }
    _line("foreground_sam", widths="sam_vit_h", img_size=sam.config.img_size,
          build_seconds=build_s, embed_seconds=embed_s,
          embed_peak_bytes=embed_peak, decode_seconds=decode_s,
          decode_peak_bytes=decode_peak, predict_seconds=predict_s,
          iou=iou, mask_pixels=int((logits > 0).sum()),
          cpu_seconds=cpu_seconds, max_abs_err=err, tol=tol,
          iou_err=iou_err, mask_flips=flips, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"SAM checks failed: {checks}")
    return sam


def _gdino_run(gr, x, ids, mask):
    """(logits, boxes, the selected proposals, the selection scores)."""
    import torch
    tr = gr.model.transformer
    seen = {}
    hooks = [tr.enc_output_norm.register_forward_hook(
        lambda m, a, out: seen.__setitem__("memory", out)),
        tr.encoder.text_layers[-1].register_forward_hook(
        lambda m, a, out: seen.__setitem__("txt", out))]
    try:
        with torch.no_grad():
            logits, boxes, topk = gr.model(x, ids, mask, return_topk=True)
    finally:
        for h in hooks:
            h.remove()
    txt = seen["txt"] * mask[..., None]
    scores = torch.einsum("bsd,btd->bst", seen["memory"], txt).masked_fill(
        ~mask[:, None, :], -float("inf")).amax(-1)
    return logits, boxes, topk, scores


@contextlib.contextmanager
def _fixed_selection(indices):
    """GroundingDINO's query selection returns `indices` inside the block
    (the CPU reference then decodes the card's proposals)."""
    from diffusionhandles_tpu_torch.models import groundingdino
    real = groundingdino.select_topk
    groundingdino.select_topk = lambda scores, k: indices.to(scores.device)
    try:
        yield
    finally:
        groundingdino.select_topk = real


def _bert_vocab(path) -> str:
    """A stand-in for bert-base-uncased's vocab.txt (30522 lines): the
    special tokens at their release ids ([CLS] 101, [SEP] 102, '.' 1012,
    '?' 1029) and the prompt's words, so a caption's ids are the same in
    every process (the tokenizer's fallback without a vocab hashes with
    Python's salted `hash`)."""
    words = [f"[unused{i}]" for i in range(30522)]
    for i, w in {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
                 1012: ".", 1029: "?", 1037: "a", 9121: "toy",
                 14291: "cube"}.items():
        words[i] = w
    path.write_text("\n".join(words))
    return str(path)


def _gdino_check(img, vocab: str):
    """GroundingDinoGrounder(GroundingDinoConfig()) at its 512 input on
    the card, against the same grounder on the CPU. The selection: the
    card's 900 proposals must be the CPU's, in its order, but where two
    proposals' CPU scores differ by less than the tolerance (an fp32 sum
    in another order may swap such a pair, and split rows the CPU ties:
    the card's GEMM may round equal rows differently; rows tied on both
    sides must keep the index order). The logits and boxes: against the
    CPU decoding the card's selection. Returns the grounder."""
    import numpy as np

    from diffusionhandles_tpu_torch.models.groundingdino import \
        GroundingDinoGrounder
    gr, build_s = _timed(lambda: GroundingDinoGrounder(vocab_path=vocab,
                                                       device="cuda"))
    x, ids, mask = gr.inputs(img, FG_PROMPT)
    _gdino_run(gr, x, ids, mask)  # first use
    (logits, boxes, topk, scores), seconds, peak = _timed_peak(
        lambda: _gdino_run(gr, x, ids, mask))
    (pb, ps), predict_s = _timed(lambda: gr.predict_boxes(img, FG_PROMPT))
    cpu = GroundingDinoGrounder(gr.config, params=_cpu_copy(gr.model),
                                vocab_path=vocab, device="cpu")
    inputs = (x.cpu(), ids.cpu(), mask.cpu())
    (_, _, tk_c, sc_c), cpu_seconds = _timed(lambda: _gdino_run(cpu,
                                                                *inputs))
    with _fixed_selection(topk.cpu()):
        lg_c, bx_c, _, _ = _gdino_run(cpu, *inputs)
        _, ps_c = cpu.predict_boxes(img, FG_PROMPT)
    lg, lg_c = logits.cpu().numpy(), lg_c.numpy()
    topk, tk_c = topk.cpu().numpy()[0], tk_c.numpy()[0]
    sc, sc_c = scores.cpu().numpy()[0], sc_c.numpy()[0]
    finite = np.isfinite(lg_c)
    lg_err = float(np.abs(lg[finite] - lg_c[finite]).max())
    box_err = float(np.abs(boxes.cpu().numpy() - bx_c.numpy()).max())
    score_tol = FG_LOGIT_RTOL * float(np.abs(sc_c).max())
    moved = topk != tk_c
    gaps = np.abs(sc_c[topk] - sc_c[tk_c])[moved]
    card_gaps = np.abs(sc[topk] - sc[tk_c])[moved]
    values, counts = np.unique(sc_c, return_counts=True)
    tied = np.isin(sc_c[tk_c], values[counts > 1])
    _, card_counts = np.unique(sc, return_counts=True)
    checks = {
        "finite": bool(np.isfinite(boxes.cpu().numpy()).all()
                       and np.isfinite(sc).all()),
        "inf_pattern": bool(np.array_equal(np.isfinite(lg), finite)),
        # a move within the tolerance, and never between rows tied on
        # both sides (those go by index on each)
        "selection_as_cpu_but_near_ties": bool(
            ((gaps <= score_tol) & ((gaps > 0) | (card_gaps > 0))).all()),
        "logits_vs_cpu": bool(lg_err <= FG_LOGIT_RTOL
                              * np.abs(lg_c[finite]).max()),
        "boxes_vs_cpu": bool(box_err <= FG_BOX_ATOL),
        "predicted_scores_vs_cpu": len(ps) == len(ps_c) and bool(
            np.abs(ps - ps_c).max() <= FG_IOU_ATOL),
    }
    _line("foreground_gdino", widths="groundingdino_swint_ogc",
          input_size=gr.input_size, build_seconds=build_s, seconds=seconds,
          peak_bytes=peak, predict_seconds=predict_s,
          cpu_seconds=cpu_seconds, queries=int(topk.shape[0]),
          proposals=int(sc.shape[0]), tied_rows=int(counts.max()),
          tied_rows_card=int(card_counts.max()),
          tied_rows_selected=int(tied.sum()), moved=int(moved.sum()),
          moved_score_gaps=[float(g) for g in gaps[:8]],
          moved_card_gaps=[float(g) for g in card_gaps[:8]],
          score_tol=score_tol, score_err=float(np.abs(sc - sc_c).max()),
          logit_err=lg_err, box_err=box_err, boxes=len(pb),
          best_box=pb[0].tolist(), best_score=float(ps[0]), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"GroundingDINO checks failed: {checks}")
    return gr


def _text2img_check():
    """StableText2Img on seeded SD-2 at 512x512, bf16 (the edit's dtype),
    TEXT2IMG_STEPS steps: K1 carries the U-Net's self-attention, its
    launches counted in the timed call alone."""
    import numpy as np

    from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig
    from diffusionhandles_tpu_torch.models.text2img import StableText2Img
    t2i, build_s = _timed(lambda: StableText2Img(GuidedDiffuserConfig(
        use_depth=False, num_timesteps=TEXT2IMG_STEPS), device="cuda"))
    calls = _count_unet_calls(t2i.diffuser.models.unet)
    t2i.generate(FG_PROMPT, seed=0)  # first use
    calls["forward"] = 0
    reset_launch_counts()
    img, seconds, peak = _timed_peak(lambda: t2i.generate(FG_PROMPT, seed=0))
    counts, unet_calls = launch_counts(), calls["forward"]
    again = t2i.generate(FG_PROMPT, seed=0)
    sites = sum(FLASH_SITES.values())
    checks = {
        "shape": img.shape == (1, 3, 512, 512),
        "finite_in_unit_range": bool(np.isfinite(img).all()
                                     and 0.0 <= img.min() <= img.max() <= 1.0),
        "repeatable_bitwise": bool(np.array_equal(img, again)),
        "k1_per_unet_call": counts["flash_fwd"] == sites * unet_calls
        and unet_calls == TEXT2IMG_STEPS,
        "no_general_route": _no_general(counts),
    }
    _line("foreground_text2img", model="sd2 (use_depth=False)",
          dtype=t2i.diffuser.conf.dtype, steps=TEXT2IMG_STEPS,
          build_seconds=build_s, seconds=seconds, peak_bytes=peak,
          unet_calls=unet_calls, flash_fwd=counts["flash_fwd"],
          flash_fwd_per_call=counts["flash_fwd"] / max(unet_calls, 1),
          image_std=float(img.std()), checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"text2img checks failed: {checks}")
    return counts["flash_fwd"]


def phase_foreground(root) -> int:
    """The text-prompted foreground path and text2img (module docstring,
    4d) on the test-set phase's 512x512 sample under `root`. Returns K1's
    launches in the timed text2img call."""
    import numpy as np
    import torch

    from diffusionhandles_tpu_torch.models.segmenter import LangSamSegmenter
    from diffusionhandles_tpu_torch.testset.preprocess import \
        estimate_foreground
    from diffusionhandles_tpu_torch.utils.image_io import (load_image,
                                                           read_png)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sample = root / "inputs" / "sample" / "input.png"
    img = load_image(sample)[None]
    res = img.shape[-1]
    box = [res // 3, res // 3, 2 * res // 3, 2 * res // 3]  # the sample's
    _free_device_memory()
    _clip_check(img)
    _free_device_memory()
    sam = _sam_check(img, box)
    gr = _gdino_check(img, _bert_vocab(root / "vocab.txt"))
    out = root / "foreground" / "mask.png"
    out.parent.mkdir(exist_ok=True)
    lang = LangSamSegmenter(grounder=gr, sam=sam)
    _, seconds = _timed(lambda: estimate_foreground(
        str(sample), FG_PROMPT, str(out), selector=lang))
    mask = read_png(out)
    checks = {"mask_png": mask.shape[:2] == img.shape[2:]
              and set(np.unique(mask)) <= {0, 255}}
    _line("foreground_estimate", selector="LangSamSegmenter(GroundingDINO, "
          "SAM ViT-H)", seconds=seconds, mask_share=float((mask > 0).mean()),
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"estimate_foreground checks failed: {checks}")
    del sam, gr, lang
    _free_device_memory()
    k1 = _text2img_check()
    _free_device_memory()
    return k1


# 3x3 convs of the conv-kernel U-Net at 512x512 that pass the conv gate: 44
# resnet halves and 3 upsamplers; 2 of them (the first resnet's) come
# before the first cross-attention.
CONV3_SITES = 47
CONV3_SITES_BEFORE_CONTEXT = 2


def check_conv_launches(launches, calls):
    """K7 launches once per eligible conv call, CONV3_SITES per U-Net
    forward, and runs dx at each eligible conv a backward reaches: all of
    them for a gradient to the latents (guidance), all but those before
    the first cross-attention for one to the text embedding (null-text)."""
    grads = calls["with_grad"]
    checks = {
        "sites_per_call": (calls["conv3x3_eligible"]
                           == CONV3_SITES * calls["forward"]),
        "fwd_per_site": launches["conv3x3_fwd"] == calls["conv3x3_eligible"],
        "dx_per_backward": ((CONV3_SITES - CONV3_SITES_BEFORE_CONTEXT) * grads
                            <= launches["conv3x3_dx"]
                            <= CONV3_SITES * grads),
    }
    _line("edit_conv_launches", unet_calls=calls,
          conv3x3_fwd=launches["conv3x3_fwd"],
          conv3x3_dx=launches["conv3x3_dx"], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"conv launches off: {checks}")


# Fused resnet halves (K9) and fused GroupNorms (K8) of the fused U-Net at
# 512x512, per forward; 2 halves come before the first cross-attention.
FUSED_HALVES = 34
FUSED_HALVES_BEFORE_CONTEXT = 2
FUSED_NORMS = 17


def check_fused_launches(launches, calls, copies):
    """K9's forward and K8's forward launch at each fused site once per
    U-Net forward; K9's dx at each half a backward reaches (all of them
    for a gradient to the latents, all but those before the first
    cross-attention for one to the text embedding), K8's backward at most
    once per fused GroupNorm and backward; K8's wrappers copy nothing into
    another layout (every site reads its channels-last x, and the
    gradient, in place)."""
    fwd, grads = calls["forward"], calls["with_grad"]
    checks = {
        "k9_fwd_per_call": launches["gn_silu_conv3x3_fwd"]
        == FUSED_HALVES * fwd,
        "k9_dx_per_backward": ((FUSED_HALVES - FUSED_HALVES_BEFORE_CONTEXT)
                               * grads <= launches["gn_silu_conv3x3_dx"]
                               <= FUSED_HALVES * grads),
        "k8_fwd_per_call": launches["gn_silu_fwd"] == FUSED_NORMS * fwd,
        "k8_bwd_per_backward": (0 < launches["gn_silu_bwd"]
                                <= FUSED_NORMS * grads),
        "k8_no_layout_copy": copies["gn"] == 0,
    }
    _line("edit_fused_launches", unet_calls=calls, layout_copies=copies,
          **{k: launches[k] for k in ("gn_silu_conv3x3_fwd",
                                      "gn_silu_conv3x3_dx", "gn_silu_fwd",
                                      "gn_silu_bwd")}, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"fused launches off: {checks}")


def _no_general(counts) -> bool:
    """True when no general route ran (bf16 at the U-Net's shapes)."""
    return not any(n for k, n in counts.items() if k.endswith("_general"))


def _unet_input(unet, res: int, seed: int):
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((1, unet.config.in_channels, res, res),
                    generator=gen).to("cuda")
    ctx = torch.randn((1, 77, unet.config.cross_attention_dim),
                      generator=gen).to("cuda")
    return x, torch.tensor([500], device="cuda"), ctx


def phase_unet_reference(handles):
    """The sd2 U-Net on one input with the kernels, then with dense
    attention: eps must agree (bf16 end to end)."""
    import torch

    from diffusionhandles_tpu_torch.models.unet import Attention
    unet = handles.diffuser.models.unet
    attns = [m for m in unet.modules() if isinstance(m, Attention)]
    x, t, ctx = _unet_input(unet, handles.diffuser.latent_res, 1)
    with torch.no_grad():
        eps_k = unet(x, t, ctx)[0].float()
        for m in attns:
            m.use_flash = False
        eps_d = unet(x, t, ctx)[0].float()
        for m in attns:
            m.use_flash = True
    err, tol = _rel_err(eps_k, eps_d, UNET_RTOL)
    ok = bool(torch.isfinite(eps_k).all()) and err <= tol
    _line("unet_reference", max_abs_err=err, tol=tol, ok=ok)
    if not ok:
        raise AssertionError("U-Net with kernels disagrees with dense")


def _latents_grad(unet, x, t, ctx):
    """eps and the gradient of an activation energy (+ eps^2) w.r.t. the
    latents, fp32."""
    import torch
    lat = x.clone().requires_grad_(True)
    eps, acts, _ = unet(lat, t, ctx)
    energy = sum(a.float().square().mean() for a in acts)
    (grad,) = torch.autograd.grad(energy + eps.float().square().mean(), lat)
    return eps.detach().float(), grad.float()


def phase_unet_switch_reference(name, handles, default_config):
    """A switched U-Net (fused GroupNorm, or the conv kernel) and a
    default-config U-Net given its weights, on one input: eps and the
    gradient of an activation energy w.r.t. the latents must agree (bf16
    end to end)."""
    import torch

    from diffusionhandles_tpu_torch.models.unet import UNet2DConditionModel
    unet_s = handles.diffuser.models.unet
    with torch.device("cuda"):
        unet_d = UNet2DConditionModel(default_config)
    unet_d.load_state_dict(unet_s.state_dict(), strict=True)
    unet_d.eval().requires_grad_(False)
    x, t, ctx = _unet_input(unet_s, handles.diffuser.latent_res, 2)
    eps_d, grad_d = _latents_grad(unet_d, x, t, ctx)
    eps_s, grad_s = _latents_grad(unet_s, x, t, ctx)
    err_e, tol_e = _rel_err(eps_s, eps_d, UNET_RTOL)
    err_g, tol_g = _rel_err(grad_s, grad_d, UNET_RTOL)
    ok = (bool(torch.isfinite(eps_s).all())
          and bool(torch.isfinite(grad_s).all())
          and err_e <= tol_e and err_g <= tol_g)
    _line(name, max_abs_err_eps=err_e, tol_eps=tol_e,
          max_abs_err_grad=err_g, tol_grad=tol_g, ok=ok)
    if not ok:
        raise AssertionError(f"{name}: the U-Net disagrees with the default")


def phase_unet_flash_bwd_modes(handles) -> dict:
    """The default U-Net forward + backward to the latents under each
    DIFFHANDLES_FLASH_BWD value: each launches its own backward route and
    no other, and its gradient agrees with the unset mode's. Returns the
    launch counts of each route in its own run."""
    import os

    import torch
    env = _kernel_modules()[0].BWD_ENV
    unet = handles.diffuser.models.unet
    x, t, ctx = _unet_input(unet, handles.diffuser.latent_res, 3)
    saved = os.environ.pop(env, None)
    grads, launches, errs, general_free = {}, {}, {}, {}
    try:
        for mode, route in BWD_MODES.items():
            if mode is not None:
                os.environ[env] = mode
            reset_launch_counts()
            grads[route] = _latents_grad(unet, x, t, ctx)[1]
            torch.cuda.synchronize()
            counts = launch_counts()
            launches[route] = {r: counts[r] for r in BWD_MODES.values()}
            general_free[route] = _no_general(counts)
            os.environ.pop(env, None)
    finally:
        if saved is not None:
            os.environ[env] = saved
    checks = {}
    for route, counts in launches.items():
        err, tol = _rel_err(grads[route], grads["flash_bwd"], UNET_RTOL)
        errs[route] = [err, tol]
        checks[route] = (counts[route] > 0 and err <= tol
                         and general_free[route]
                         and bool(torch.isfinite(grads[route]).all())
                         and all(n == 0 for r, n in counts.items()
                                 if r != route))
    _line("unet_flash_bwd_modes", launches=launches, max_abs_err_tol=errs,
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"backward modes failed: {checks}")
    return {route: counts[route] for route, counts in launches.items()}


def phase_attention_forward_entries() -> dict:
    """The forward-only entries at the U-Net's self-attention shapes:
    flash_attention (K1), flash_attention(block_k=STREAM_BLOCK_K) (K4) and
    flash_fwd_impl(fold=False) (K5), each against dense attention. Returns
    the launch counts of this run."""
    import torch
    att = _kernel_modules()[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    entries = {
        "flash_fwd": lambda q, k, v: att.flash_attention(q, k, v),
        "flash_fwd_stream": lambda q, k, v: att.flash_attention(
            q, k, v, block_k=STREAM_BLOCK_K),
        "flash_fwd_unfolded": lambda q, k, v: att.flash_fwd_impl(
            q, k, v, fold=False)[0]}
    reset_launch_counts()
    errs = {name: 0.0 for name in entries}
    ok = True
    for shape in FWD_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        dense = att.dot_product_attention(q, k, v)
        for name, entry in entries.items():
            out = entry(q, k, v)
            err, tol = _rel_err(out, dense, ENTRY_RTOL)
            errs[name] = max(errs[name], err / tol)
            ok = ok and bool(torch.isfinite(out.float()).all()) and err <= tol
    torch.cuda.synchronize()
    counts = launch_counts()
    checks = {"within_tol": ok,
              "launched": all(counts[n] == len(FWD_SHAPES) for n in entries),
              "no_general_route": _no_general(counts)}
    # the same entries in fp32 at the first shape: the general kernels
    reset_launch_counts()
    q, k, v = (torch.randn(FWD_SHAPES[0], generator=gen, device="cuda")
               for _ in range(3))
    dense = att.dot_product_attention(q, k, v)
    for name, entry in entries.items():
        out = entry(q, k, v)
        err, tol = _rel_err(out, dense, ENTRY_RTOL)
        errs[f"{name}_general"] = err / tol
        checks["within_tol"] &= (out.dtype == torch.float32 and err <= tol
                                 and bool(torch.isfinite(out).all()))
    torch.cuda.synchronize()
    general_counts = {k: n for k, n in launch_counts().items() if n}
    checks["fp32_general"] = general_counts == {f"{n}_general": 1
                                                for n in entries}
    counts.update(general_counts)
    _line("attention_forward_entries",
          launches={n: counts[n] for n in entries},
          fp32_launches=general_counts, max_err_over_tol=errs,
          checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"forward entries failed: {checks}")
    return counts


# Each U-Net of the fp32 phase: its config switches, and the general routes
# its 512x512 forward takes (the kernel ops on its path) and how often: 10
# self-attention sites; 17 GroupNorms and 34 fused resnet halves; 47
# conv-kernel convs. The backward to the latents reaches every site once,
# with the matching backward route.
FP32_ROUTES = {
    "default": ({}, {"flash_fwd_general": 10}),
    "fused": (dict(fused_gn_conv=True, fused_gn=True),
              {"flash_fwd_general": 10, "gn_silu_fwd_general": FUSED_NORMS,
               "gn_silu_conv3x3_fwd_general": FUSED_HALVES}),
    "conv": (dict(conv3x3_kernel=True),
             {"flash_fwd_general": 10, "conv3x3_fwd_general": CONV3_SITES}),
}
FP16_ROUTE = {"flash_fwd_general": "flash_fwd",
              "gn_silu_conv3x3_fwd_general": "gn_silu_conv3x3_fwd",
              "conv3x3_fwd_general": "conv3x3_fwd"}
BACKWARD_ROUTE = {"flash_fwd_general": "flash_bwd_general",
                  "gn_silu_fwd_general": "gn_silu_bwd_general",
                  "gn_silu_conv3x3_fwd_general": "gn_silu_conv3x3_dx_general",
                  "conv3x3_fwd_general": "conv3x3_dx_general"}


def phase_fp32_routes() -> dict:
    """The U-Net of GuidedDiffuserConfig(dtype="float32") (flash on, the
    default), then the fused and conv U-Nets on its weights: one 512x512
    forward and backward to the latents each, the default one also with
    DIFFHANDLES_FLASH_BWD "twopass" and "fold"; then the three U-Nets in
    fp16 on the same weights, one forward each. None raises; each fp32 run
    takes exactly its general routes (FP32_ROUTES, and in the backward the
    matching backward route at each site) and launches no Hopper kernel;
    each fp16 run takes the Hopper kernels' fp16 instances (FP16_ROUTE)
    and K8's general one; eps and the gradient are finite and agree with
    the fp32 default U-Net's.
    Returns the launch counts summed over the runs."""
    import os

    import torch

    from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig
    from diffusionhandles_tpu_torch.diffuser import create_sd_models
    models = create_sd_models(conf=GuidedDiffuserConfig(dtype="float32"),
                              device="cuda")
    unet = models.unet
    del models
    x, t, ctx = _unet_input(unet, 64, 4)
    env = _kernel_modules()[0].BWD_ENV
    default = FP32_ROUTES["default"][1]
    # (name, config switches, DIFFHANDLES_FLASH_BWD, forward routes, the
    # flash backward route or None for a forward only)
    runs = [(n, sw, None, r, "flash_bwd_general")
            for n, (sw, r) in FP32_ROUTES.items()]
    runs += [(f"default_{mode}", {}, mode, default,
              f"flash_bwd_{mode}_general") for mode in ("twopass", "fold")]
    # fp16: the Hopper kernels' fp16 instances, K8's general one
    runs += [(f"{n}_fp16", {**sw, "dtype": torch.float16}, None,
              {FP16_ROUTE.get(k, k): c for k, c in r.items()}, None)
             for n, (sw, r) in FP32_ROUTES.items()]
    eps, grads, checks, total = {}, {}, {}, {}
    saved = os.environ.pop(env, None)
    try:
        for name, switches, mode, routes, flash_bwd in runs:
            u = _swapped_unet(unet, **switches) if switches else unet
            if mode is not None:
                os.environ[env] = mode
            reset_launch_counts()
            torch.cuda.synchronize()
            start = time.perf_counter()
            expected, fields, grad_ok = dict(routes), {}, True
            if flash_bwd is None:
                with torch.no_grad():
                    eps[name] = u(x, t, ctx)[0].float()
            else:
                eps[name], grads[name] = _latents_grad(u, x, t, ctx)
                expected.update({BACKWARD_ROUTE[k]: n
                                 for k, n in routes.items()})
                expected[flash_bwd] = expected.pop("flash_bwd_general")
                err_g, tol_g = _rel_err(grads[name], grads["default"],
                                        UNET_RTOL)
                grad_ok = (bool(torch.isfinite(grads[name]).all())
                           and err_g <= tol_g)
                fields = dict(max_abs_err_grad=err_g, tol_grad=tol_g)
            os.environ.pop(env, None)
            torch.cuda.synchronize()
            fields["seconds"] = time.perf_counter() - start
            counts = {k: n for k, n in launch_counts().items() if n}
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            err, tol = _rel_err(eps[name], eps["default"], UNET_RTOL)
            checks[name] = (counts == expected and grad_ok
                            and bool(torch.isfinite(eps[name]).all())
                            and err <= tol)
            _line("fp32_routes", unet=name, launches=counts,
                  expected=expected, max_abs_err=err, tol=tol, **fields,
                  ok=checks[name])
            del u
    finally:
        os.environ.pop(env, None)
        if saved is not None:
            os.environ[env] = saved
    if not all(checks.values()):
        raise AssertionError(f"fp32 routes failed: {checks}")
    return total


FUSED_EDIT_KERNELS = ("flash_fwd", "flash_bwd", "gn_silu_fwd",
                      "gn_silu_bwd", "gn_silu_conv3x3_fwd",
                      "gn_silu_conv3x3_dx")


def _free_device_memory() -> None:
    """Drop released models from the card before the next edit, so that
    each edit's peak memory is its own."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    try:
        import torch

        # the port itself first: without the repo around the script this
        # fails before any phase prints
        import diffusionhandles_tpu_torch.pipeline  # noqa: F401
        phase_device()
        phase_build()
        kernels = phase_kernels()
        default, _, _, _, edit = phase_edit("edit", EDIT_TIMESTEPS,
                                            ("flash_fwd", "flash_bwd"))
        single_seconds = phase_edit_paths(default, edit)
        batched = phase_edit_batched(default, edit, single_seconds)
        del edit
        _free_device_memory()
        phase_unet_conv_modes(default)
        phase_multi_gpu(default, batched)
        del batched
        est, lama = phase_testset(default)
        phase_service(default, est, lama, *_service_models(), TESTSET_DIR)
        del est, lama
        _free_device_memory()
        phase_unet_reference(default)
        launches = phase_unet_flash_bwd_modes(default)
        default_config = default.diffuser.models.unet_config
        del default
        _free_device_memory()
        phase_foreground(TESTSET_DIR)
        entries = phase_attention_forward_entries()
        launches.update({n: entries[n] for n in ("flash_fwd_unfolded",
                                                 "flash_fwd_stream")})
        general = {k: n for k, n in entries.items() if k.endswith("_general")}
        fused, fused_launches, fused_calls, fused_copies, _ = phase_edit(
            "edit_fused", FUSED_EDIT_TIMESTEPS, FUSED_EDIT_KERNELS,
            fused_gn_conv=True, fused_gn=True)
        check_fused_launches(fused_launches, fused_calls, fused_copies)
        launches.update({n: fused_launches[n] for n in FUSED_EDIT_KERNELS})
        phase_unet_switch_reference("unet_fused_reference", fused,
                                    default_config)
        del fused
        _free_device_memory()
        conv, conv_launches, calls, _, _ = phase_edit(
            "edit_conv", EDIT_TIMESTEPS,
            ("flash_fwd", "flash_bwd", "conv3x3_fwd", "conv3x3_dx"),
            conv3x3_kernel=True)
        check_conv_launches(conv_launches, calls)
        launches.update({n: conv_launches[n] for n in ("conv3x3_fwd",
                                                       "conv3x3_dx")})
        phase_unet_switch_reference("unet_conv_reference", conv,
                                    default_config)
        del conv
        _free_device_memory()
        # the general routes' launches; the Hopper kernels' stay the
        # edits' (their fp16 runs here are checks of other instances)
        for k, n in phase_fp32_routes().items():
            if k.endswith("_general"):
                general[k] = general.get(k, 0) + n
        launches.update(general)
        missing = [n for n in KERNELS if not launches.get(n)]
        if missing:
            raise AssertionError(f"no path launched {missing}")
    except Exception as exc:  # report and fail, with no result line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc!r}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name], **kernels[name]}
        for name, (source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
