"""Batch test-set driver over photogen-format manifests.

The counterpart of the JAX package's `testset/driver.py` (reference:
test/test_diffusion_handles.py): runs the pipeline over a JSON manifest
{sample_name: [transform_names]}, each sample a directory with input.png,
mask.png, prompt.txt and transforms.json and, optionally precomputed,
depth.exr, bg.png and bg_depth.exr. Missing depth and background inputs
are made by the estimators given (the reference shells out to its ZoeDepth
and LaMa scripts, :167-206). The identity cache (an npz in the reference's
layout, reference :85-114), --skip_existing (:216-225), metrics.json and
the HTML gallery are kept. Each sample's metrics also carry its seconds,
split into preprocess (loading and estimating the inputs), invert (the
inversion or the cache read, and set_foreground), edits and io (the
reconstruction and the files written).
"""

from __future__ import annotations

import json
import pathlib
import tempfile
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.checkpoint import (load_identity,
                                                   save_identity, to_nchw,
                                                   to_nhwc)
from diffusionhandles_tpu_torch.testset.metrics import psnr, ssim
from diffusionhandles_tpu_torch.utils.image_io import (crop_and_resize,
                                                       load_depth,
                                                       load_image,
                                                       save_image)


def load_diffhandles_inputs(input_dir: pathlib.Path, sample_name: str,
                            img_res: int, depth_estimator=None,
                            foreground_remover=None):
    """Load (and synthesize missing) inputs for one sample
    (reference: test_diffusion_handles.py:167-263)."""
    d = pathlib.Path(input_dir) / sample_name
    with open(d / "transforms.json") as f:
        transforms = json.load(f)
    prompt = (d / "prompt.txt").read_text().strip()

    img = crop_and_resize(load_image(d / "input.png"), img_res)[None]
    fg_mask = crop_and_resize(load_image(d / "mask.png")[:1],
                              img_res)[None]

    depth_path = d / "depth.exr"
    if depth_path.exists():
        depth = crop_and_resize(load_depth(depth_path), img_res)[None]
    elif depth_estimator is not None:
        depth = depth_estimator.estimate_depth(img)
    else:
        raise FileNotFoundError(f"{depth_path} missing and no estimator")

    bg_path = d / "bg.png"
    if bg_path.exists():
        bg_img = crop_and_resize(load_image(bg_path), img_res)[None]
    elif foreground_remover is not None:
        bg_img = foreground_remover.remove_foreground(img, fg_mask,
                                                      dilation=3)
    else:
        bg_img = None

    bg_depth_path = d / "bg_depth.exr"
    if bg_depth_path.exists():
        bg_depth = crop_and_resize(load_depth(bg_depth_path), img_res)[None]
    elif depth_estimator is not None and bg_img is not None:
        bg_depth = depth_estimator.estimate_depth(bg_img)
    else:
        raise FileNotFoundError(f"{bg_depth_path} missing and no estimator")

    return transforms, prompt, img, fg_mask, depth, bg_depth


class _Phases:
    """Seconds per phase on the host clock, each ended by a synchronize of
    the handles' device (its work is asynchronous on a GPU)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = OrderedDict(
            (k, 0.0) for k in ("preprocess", "invert", "edits", "io"))
        self._t = time.perf_counter()

    def end(self, phase: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[phase] += now - self._t
        self._t = now


def test_diffusion_handles(test_set_path: str, input_dir: str,
                           output_dir: str, skip_existing: bool = False,
                           cache_input_image_identity: bool = False,
                           config_path: Optional[str] = None,
                           variant: str = "sd2", img_res: int = 512,
                           depth_estimator=None, foreground_remover=None,
                           handles=None, generate_webpage: bool = True,
                           batched: bool = False, batch_chunk: int = 8,
                           device=None):
    """Run the pipeline over a photogen manifest (reference:
    test_diffusion_handles.py:19-165). Without `handles`, builds
    DiffusionHandles(config_path, variant) on `device` (default: the
    GPU)."""
    from diffusionhandles_tpu_torch.config import config_to_dict, load_config
    from diffusionhandles_tpu_torch.geometry.depth import normalize_depth

    test_set_path = pathlib.Path(test_set_path)
    input_dir = pathlib.Path(input_dir)
    output_dir = pathlib.Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    with open(test_set_path) as f:
        dataset_names = json.load(f, object_pairs_hook=OrderedDict)

    conf = load_config(config_path)
    if handles is None:
        from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
        handles = DiffusionHandles(conf, variant=variant, device=device)
        img_res = handles.img_res

    # the config beside the results (reference :52-54), as JSON, which is
    # YAML too (the JAX package writes the same mapping with PyYAML)
    with open(output_dir / "config.yaml", "w") as f:
        json.dump(config_to_dict(conf), f, indent=2)

    metrics_acc = OrderedDict()
    print(f"Editing {len(dataset_names)} images ...")
    for sample_idx, (sample_name, transform_names) in enumerate(
            dataset_names.items()):
        sample_out = output_dir / sample_name
        sample_out.mkdir(parents=True, exist_ok=True)

        if skip_existing and all(
                (sample_out / f"{t}.png").exists()
                for t in transform_names):
            print(f"[{sample_idx + 1}/{len(dataset_names)}] skipping "
                  f"{sample_name} (all outputs exist)")
            continue

        timer = _Phases(handles.device)
        transforms, prompt, img, fg_mask, depth, bg_depth = \
            load_diffhandles_inputs(input_dir, sample_name, img_res,
                                    depth_estimator, foreground_remover)
        timer.end("preprocess")
        print(f"[{sample_idx + 1}/{len(dataset_names)}] Editing "
              f"{sample_name} with {len(transform_names)} transforms ...")

        # the inputs for the gallery (reference :80-82)
        save_image(img[0], sample_out / "input.png")
        save_image(np.repeat(fg_mask[0], 3, axis=0),
                   sample_out / "mask.png")
        disparity = normalize_depth(1.0 / torch.as_tensor(
            depth, dtype=torch.float32)).numpy() / 255.0
        save_image(np.repeat(disparity[0], 3, axis=0),
                   sample_out / "disparity.png")
        timer.end("io")

        # the identity cache (reference :85-114)
        ident_path = (pathlib.Path(tempfile.gettempdir()) / "diffhandles"
                      / test_set_path.stem / sample_name
                      / "input_image_identity.npz")
        if cache_input_image_identity and ident_path.exists():
            ident = load_identity(ident_path)
            null_text_emb = ident["null_text_emb"]
            init_noise = to_nchw(ident["init_noise"])
            activations = [to_nchw(a) for a in ident["activations"]]
            latent_image = to_nchw(ident["latent_image"])
        else:
            null_text_emb, init_noise = handles.invert_input_image(
                img, depth, prompt)
            null_text_emb, init_noise, activations, latent_image = \
                handles.generate_input_image(depth, prompt, null_text_emb,
                                             init_noise)
            if cache_input_image_identity:
                save_identity(ident_path, null_text_emb,
                              to_nhwc(init_noise),
                              [to_nhwc(a) for a in activations],
                              to_nhwc(latent_image))

        bg_depth_h = handles.set_foreground(depth, fg_mask, bg_depth)
        timer.end("invert")

        # the reconstruction from the latent (reference :121-126) and the
        # recon-vs-input scores (meaningful with released weights only;
        # LPIPS needs converted VGG16 perceptual weights, which no release
        # file here holds: null, as in the JAX driver)
        rec_chw = handles.diffuser.decode_latent_image(
            latent_image)[0].cpu().numpy()
        save_image(rec_chw, sample_out / "recon.png")
        tr_rows = OrderedDict()
        metrics_acc[sample_name] = {
            "recon_psnr_db": round(float(psnr(img[0], rec_chw)), 3),
            "recon_ssim": round(float(ssim(img[0], rec_chw)), 4),
            "recon_lpips": None,
            # per-transform rows; edit-vs-input scores document the output
            # against its source (an edit should move away from it)
            "transforms": tr_rows,
            "seconds": timer.seconds,
        }
        timer.end("io")

        def save_edit_outputs(t_name, edited_chw, disp_1hw):
            save_image(edited_chw, sample_out / f"{t_name}.png")
            lo, hi = float(disp_1hw.min()), float(disp_1hw.max())
            save_image(
                np.repeat((disp_1hw - lo) / max(hi - lo, 1e-9), 3, axis=0),
                sample_out / f"{t_name}_disparity.png")
            tr = transforms[t_name]
            tr_rows[t_name] = {
                "edit_vs_input_psnr_db": round(
                    float(psnr(img[0], edited_chw)), 3),
                "edit_vs_input_ssim": round(
                    float(ssim(img[0], edited_chw)), 4),
                "rotation_angle": tr.get("rotation_angle"),
                "translation": tr.get("translation"),
            }

        if batched:
            # the sample's transforms denoise as fixed-size batches
            # (parallel/batch.py; the reference loops serially)
            from diffusionhandles_tpu_torch.parallel.batch import edit_batch
            todo = [t for t in transform_names if t in transforms
                    and not (skip_existing
                             and (sample_out / f"{t}.png").exists())]
            if todo:
                imgs, disps = edit_batch(
                    handles, depth, prompt, fg_mask, bg_depth_h,
                    null_text_emb, init_noise, activations,
                    [transforms[t] for t in todo], chunk=batch_chunk,
                    return_disparities=True)
                timer.end("edits")
                for t, edited_chw, disp in zip(todo, imgs, disps):
                    save_edit_outputs(t, edited_chw, disp)
                timer.end("io")
            continue

        for transform_name in transform_names:
            if transform_name not in transforms:
                print(f"WARNING: Transform {transform_name} not found for "
                      f"image {sample_name}. Skipping.")
                continue
            if skip_existing and (sample_out
                                  / f"{transform_name}.png").exists():
                continue
            tr = transforms[transform_name]
            results = handles.transform_foreground(
                depth=depth, prompt=prompt, fg_mask=fg_mask,
                bg_depth=bg_depth_h,
                null_text_emb=null_text_emb, init_noise=init_noise,
                activations=activations,
                rot_angle=tr.get("rotation_angle"),
                rot_axis=(np.asarray(tr["rotation_axis"], np.float32)
                          if "rotation_axis" in tr else None),
                translation=(np.asarray(tr["translation"], np.float32)
                             if "translation" in tr else None))
            timer.end("edits")
            if len(results) > 2:
                # save_denoising_steps: each step's decodes
                # (reference: guided_stable_diffuser.py:444-479)
                steps_dir = sample_out / f"{transform_name}_steps"
                for si, (img_opt, img_step) in enumerate(
                        results[2]["opt"]):
                    save_image(np.moveaxis(img_opt[0], -1, 0),
                               steps_dir / f"step_{si:03d}_opt.png")
                    save_image(np.moveaxis(img_step[0], -1, 0),
                               steps_dir / f"step_{si:03d}_denoise.png")
            save_edit_outputs(transform_name, results[0][0], results[1][0])
            timer.end("io")

    with open(output_dir / test_set_path.name, "w") as f:
        json.dump(dataset_names, f, indent=4)

    if metrics_acc:
        # a --skip_existing resume merges the previous run's entries, so
        # the means describe the whole output set
        prior_path = output_dir / "metrics.json"
        if skip_existing and prior_path.exists():
            with open(prior_path) as f:
                prior = json.load(f).get("samples", {})
            for name, entry in prior.items():
                metrics_acc.setdefault(name, entry)
            metrics_acc = OrderedDict(sorted(metrics_acc.items()))
        vals_p = [m["recon_psnr_db"] for m in metrics_acc.values()]
        vals_s = [m["recon_ssim"] for m in metrics_acc.values()]
        num_edits = sum(len(m.get("transforms", {}))
                        for m in metrics_acc.values())
        artifact = OrderedDict(
            samples=metrics_acc,
            num_samples=len(metrics_acc),
            num_edits=num_edits,
            mean_recon_psnr_db=round(float(np.mean(vals_p)), 3),
            mean_recon_ssim=round(float(np.mean(vals_s)), 4),
            lpips_note=("LPIPS requires converted VGG16 perceptual "
                        "weights (models/lpips.py); null without them."),
        )
        with open(output_dir / "metrics.json", "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"metrics: mean recon PSNR "
              f"{artifact['mean_recon_psnr_db']:.2f} dB, mean SSIM "
              f"{artifact['mean_recon_ssim']:.3f} -> "
              f"{output_dir / 'metrics.json'}")

    if generate_webpage:
        from diffusionhandles_tpu_torch.testset.report import \
            generate_results_webpage
        generate_results_webpage(
            test_set_path=str(test_set_path),
            website_path=str(output_dir
                             / f"{test_set_path.stem}_summary.html"),
            relative_image_dir=".")


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--test_set_path", required=True)
    parser.add_argument("--input_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--skip_existing", action="store_true")
    parser.add_argument("--cache_input_image_identity", action="store_true")
    parser.add_argument("--config_path", default=None)
    parser.add_argument("--variant", default="sd2")
    parser.add_argument("--batched", action="store_true",
                        help="denoise each sample's transforms as batches")
    parser.add_argument("--batch_chunk", type=int, default=8,
                        help="batch size for --batched (the last batch is "
                             "padded to it)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    args = parser.parse_args()
    test_diffusion_handles(
        test_set_path=args.test_set_path, input_dir=args.input_dir,
        output_dir=args.output_dir, skip_existing=args.skip_existing,
        cache_input_image_identity=args.cache_input_image_identity,
        config_path=args.config_path, variant=args.variant,
        batched=args.batched, batch_chunk=args.batch_chunk,
        device=args.device)


if __name__ == "__main__":
    main()
