"""Sample preprocessing: the reference's per-model scripts as functions
and a CLI.

The counterpart of the JAX package's `testset/preprocess.py`:
  estimate_depth      (reference: test/estimate_depth.py, ZoeDepth -> .exr)
  remove_foreground   (reference: test/remove_foreground.py, LaMa -> bg.png)
  estimate_foreground (reference: test/estimate_foreground.py, LangSAM ->
                       mask.png): the CLIP segmenter, or CLIP grounding
                       into SAM with a `sam_checkpoint`.
The estimators run on the GPU unless `device` says otherwise.

    python -m diffusionhandles_tpu_torch.testset.preprocess estimate_depth \\
        --img_path input.png --depth_path depth.exr
    python -m diffusionhandles_tpu_torch.testset.preprocess \\
        estimate_foreground --img_path input.png --prompt "a mug" \\
        --mask_path mask.png [--sam_checkpoint sam_vit_h_4b8939.pth]
"""

from __future__ import annotations

import numpy as np

from diffusionhandles_tpu_torch.utils.image_io import (load_image, save_depth,
                                                       save_image)


def estimate_depth(img_path: str, depth_path: str, estimator=None,
                   device=None) -> None:
    """Image -> metric depth EXR (reference: estimate_depth.py:11-32)."""
    if estimator is None:
        from diffusionhandles_tpu_torch.models.zoedepth import \
            ZoeDepthEstimator
        estimator = ZoeDepthEstimator(device=device)
    depth = estimator.estimate_depth(load_image(img_path)[None])
    save_depth(depth[0], depth_path)


def remove_foreground(img_path: str, fg_mask_path: str, bg_path: str,
                      dilation: int = 3, remover=None, device=None) -> None:
    """Inpaint the dilated foreground mask (reference:
    remove_foreground.py:11-42, which dilates the mask before LaMa)."""
    if remover is None:
        from diffusionhandles_tpu_torch.models.lama import LamaInpainter
        remover = LamaInpainter(device=device)
    img = load_image(img_path)[None]
    mask = load_image(fg_mask_path)[:1][None]
    save_image(remover.remove_foreground(img, mask, dilation=dilation)[0],
               bg_path)


def estimate_foreground(img_path: str, prompt: str, mask_path: str,
                        selector=None, sam_checkpoint: str = None,
                        device=None) -> None:
    """Text-prompted foreground mask (reference:
    estimate_foreground.py:11-42) from `selector.select_foreground(img
    [1, 3, H, W], prompt) -> [1, 1, H, W]`. Without a selector: with
    `sam_checkpoint`, the two-stage LangSamSegmenter (CLIP grounding ->
    released-weights SAM), otherwise the CLIP-similarity segmenter."""
    if selector is None:
        if sam_checkpoint is not None:
            from diffusionhandles_tpu_torch.models.segmenter import \
                LangSamSegmenter
            selector = LangSamSegmenter(sam_checkpoint=sam_checkpoint,
                                        device=device)
        else:
            from diffusionhandles_tpu_torch.models.segmenter import \
                CLIPSegmenter
            selector = CLIPSegmenter(device=device)
    mask = selector.select_foreground(load_image(img_path)[None], prompt)
    save_image(np.repeat(np.asarray(mask)[0], 3, axis=0), mask_path)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default=None,
                        help="torch device (default: the GPU)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("estimate_depth")
    p1.add_argument("--img_path", required=True)
    p1.add_argument("--depth_path", required=True)
    p2 = sub.add_parser("remove_foreground")
    p2.add_argument("--img_path", required=True)
    p2.add_argument("--fg_mask_path", required=True)
    p2.add_argument("--bg_path", required=True)
    p2.add_argument("--dilation", type=int, default=3)
    p3 = sub.add_parser("estimate_foreground")
    p3.add_argument("--img_path", required=True)
    p3.add_argument("--prompt", required=True)
    p3.add_argument("--mask_path", required=True)
    p3.add_argument("--sam_checkpoint", default=None,
                    help="released sam_vit_h .pth for the two-stage "
                         "LangSAM pipeline")
    args = parser.parse_args(argv)
    if args.cmd == "estimate_depth":
        estimate_depth(args.img_path, args.depth_path, device=args.device)
    elif args.cmd == "remove_foreground":
        remove_foreground(args.img_path, args.fg_mask_path, args.bg_path,
                          args.dilation, device=args.device)
    else:
        estimate_foreground(args.img_path, args.prompt, args.mask_path,
                            sam_checkpoint=args.sam_checkpoint,
                            device=args.device)


if __name__ == "__main__":
    main()
