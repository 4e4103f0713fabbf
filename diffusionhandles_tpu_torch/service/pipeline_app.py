"""Pipeline orchestrator: the user-facing 3-step editing flow.

The counterpart of the JAX package's `service/pipeline_app.py` (reference:
webapp/webapps/diffhandles_pipeline_webapp.py): it fans out to the backend
services (depth, remover, selector, core) with a callback DAG (:80-288),
lazily recomputes missing earlier-step outputs (:193-198, 547-556), and
offers a fast local preview of the depth transform in 'depth' or 'rgb'
mode (:290-532), with no diffusion, on `device` (default: the GPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.service.base import Webapp
from diffusionhandles_tpu_torch.service.client import (
    DepthEstimatorClient, DiffhandlesClient, ForegroundRemoverClient,
    ForegroundSelectorClient, Text2ImgClient)
from diffusionhandles_tpu_torch.service.job_manager import Job, JobManager
from diffusionhandles_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PipelineState:
    """Per-session state (the reference keeps these in gradio state and
    temp files)."""

    img: Optional[np.ndarray] = None
    prompt: Optional[str] = None
    depth: Optional[np.ndarray] = None
    input_image_identity: Optional[bytes] = None
    fg_prompt: Optional[str] = None
    fg_mask: Optional[np.ndarray] = None
    bg_img: Optional[np.ndarray] = None
    bg_depth: Optional[np.ndarray] = None


class DiffhandlesPipeline:
    """Programmatic orchestrator over the service mesh; the previews run
    on `device`."""

    def __init__(self, diffhandles_url: str = "http://127.0.0.1:8889",
                 depth_url: str = "http://127.0.0.1:8890",
                 remover_url: str = "http://127.0.0.1:8891",
                 selector_url: str = "http://127.0.0.1:8892",
                 text2img_url: Optional[str] = "http://127.0.0.1:8893",
                 fg_removal_dilation: int = 3, device=None):
        self.diffhandles = DiffhandlesClient(diffhandles_url)
        self.depth_estimator = DepthEstimatorClient(depth_url)
        self.remover = ForegroundRemoverClient(remover_url)
        self.selector = ForegroundSelectorClient(selector_url)
        self.text2img = Text2ImgClient(text2img_url) if text2img_url \
            else None
        self.fg_removal_dilation = fg_removal_dilation
        self.device = resolve_device(device)
        self.state = PipelineState()
        # per-sample overrides (reference: webapp/data/*/config.yaml keys
        # fg_removal_dilation / fg_weight / bg_weight / diffhandles_config)
        self.sample_overrides: dict = {}

    def load_sample(self, sample_dir):
        """Load a demo-sample directory (the webapp's data layout) with its
        optional per-sample config.yaml (reference:
        diffhandles_pipeline_webapp.py:661-701)."""
        import pathlib

        from diffusionhandles_tpu_torch.utils.image_io import (load_depth,
                                                               load_image)
        d = pathlib.Path(sample_dir)
        self.sample_overrides = {}
        cfg_path = d / "config.yaml"
        if cfg_path.exists():
            import yaml
            self.sample_overrides = yaml.safe_load(cfg_path.read_text()) \
                or {}
            if "fg_removal_dilation" in self.sample_overrides:
                self.fg_removal_dilation = int(
                    self.sample_overrides["fg_removal_dilation"])
        s = self.state
        s.img = load_image(d / "input.png")[None]
        s.prompt = (d / "prompt.txt").read_text().strip()
        if (d / "mask.png").exists():
            s.fg_mask = load_image(d / "mask.png")[:1][None]
        if (d / "fg_prompt.txt").exists():
            s.fg_prompt = (d / "fg_prompt.txt").read_text().strip()
        if (d / "depth.exr").exists():
            s.depth = load_depth(d / "depth.exr")[None]
        if (d / "bg.png").exists():
            s.bg_img = load_image(d / "bg.png")[None]
        if (d / "bg_depth.exr").exists():
            s.bg_depth = load_depth(d / "bg_depth.exr")[None]
        return s

    # -- step 1 ---------------------------------------------------------

    def generate_input_image(self, prompt: str, seed: int = 0):
        """Create the input image from text (reference :612-660)."""
        if self.text2img is None:
            raise RuntimeError("no text2img service configured")
        img = self.text2img.generate(prompt, seed=seed)
        return self.set_input_image(img, prompt)

    def set_input_image(self, img: np.ndarray, prompt: str):
        """Estimate depth, then invert the input image: two backend calls
        as a dependency DAG (reference :138-252)."""
        s = self.state
        s.img = np.asarray(img, np.float32)
        s.prompt = prompt
        jm = JobManager()
        depth_job = Job(lambda: self.depth_estimator.estimate_depth(s.img),
                        timeout=600)
        jm.add_job(depth_job)

        def on_depth(job):
            s.depth = job.outputs()
            jm.add_job(Job(lambda: self._invert(), timeout=1200))

        jm.add_callback([depth_job], on_depth)
        jm.run()
        return s.depth

    def _invert(self):
        s = self.state
        s.input_image_identity = self.diffhandles.set_input_image(
            s.img, s.depth, s.prompt)
        return s.input_image_identity

    # -- step 2 ---------------------------------------------------------

    def set_foreground(self, fg_prompt: Optional[str] = None,
                       fg_mask: Optional[np.ndarray] = None):
        """Select the foreground, remove it, estimate the bg depth and
        harmonize it (reference :254-288). Recomputes missing step-1
        outputs."""
        s = self.state
        if s.depth is None or s.input_image_identity is None:
            if s.img is None:
                raise RuntimeError("set_input_image must run first")
            self.set_input_image(s.img, s.prompt)
        if fg_mask is None:
            if fg_prompt is None:
                raise RuntimeError("need fg_prompt or fg_mask")
            fg_mask = self.selector.select_foreground(s.img, fg_prompt)
        s.fg_prompt = fg_prompt
        fg_mask = np.asarray(fg_mask, np.float32)
        if fg_mask.ndim == 4 and fg_mask.shape[1] > 1:  # an rgb mask upload
            fg_mask = fg_mask[:, :1]
        s.fg_mask = fg_mask

        jm = JobManager()
        remove_job = Job(lambda: self.remover.remove_foreground(
            s.img, s.fg_mask, self.fg_removal_dilation), timeout=600)
        jm.add_job(remove_job)

        def on_removed(job):
            s.bg_img = job.outputs()
            bg_depth_job = Job(lambda: self.depth_estimator.estimate_depth(
                s.bg_img), timeout=600)
            jm.add_job(bg_depth_job)

            def on_bg_depth(job2):
                raw_bg_depth = job2.outputs()
                s.bg_depth = self.diffhandles.set_foreground(
                    s.depth, s.fg_mask,
                    raw_bg_depth)["bg_depth_harmonized"]

            jm.add_callback([bg_depth_job], on_bg_depth)

        jm.add_callback([remove_job], on_removed)
        jm.run()
        return s.bg_depth

    # -- step 3 ---------------------------------------------------------

    def transform_foreground(self, rot_angle=0.0, rot_axis=(0.0, 1.0, 0.0),
                             translation=(0.0, 0.0, 0.0), fg_weight=None,
                             bg_weight=None):
        """Run the guided edit (reference :534-610). Recomputes missing
        step-2 outputs."""
        s = self.state
        if s.bg_depth is None:
            self.set_foreground(s.fg_prompt, s.fg_mask)
        if fg_weight is None:
            fg_weight = self.sample_overrides.get("fg_weight")
        if bg_weight is None:
            bg_weight = self.sample_overrides.get("bg_weight")
        out = self.diffhandles.transform_foreground(
            s.input_image_identity, s.depth, s.prompt, s.fg_mask,
            s.bg_depth, rot_angle=rot_angle, rot_axis=rot_axis,
            translation=translation, fg_weight=fg_weight,
            bg_weight=bg_weight)
        return out["edited_img"], out["edited_disparity"]

    # -- fast local preview (no diffusion) ------------------------------

    def preview_edit(self, rot_angle=0.0, rot_axis=(0.0, 1.0, 0.0),
                     translation=(0.0, 0.0, 0.0), mode: str = "depth"):
        """Depth-transform-only preview on `self.device` (reference
        :290-532), as numpy.

        mode='depth': the edited disparity normalized to [0, 1],
          [1, 1, H, W].
        mode='rgb': the colored depth meshes rendered, [1, 3, H, W]: the
          bg mesh colored by the background image, the fg mesh by the
          input image with its vertices rigidly transformed, and the
          pixels no face covers darkened (reference :472-519 renders the
          same scene with PyTorch3D).
        """
        from diffusionhandles_tpu_torch.diffuser import GuidedStableDiffuser
        from diffusionhandles_tpu_torch.geometry.transform import \
            transform_depth
        s = self.state
        if s.bg_depth is None:
            raise RuntimeError("set_foreground must run first")
        K = GuidedStableDiffuser.get_depth_intrinsics()
        if mode == "depth":
            disparity, _ = transform_depth(
                s.depth, s.bg_depth, s.fg_mask, K,
                rot_angle=rot_angle,
                rot_axis=np.asarray(rot_axis, np.float32),
                translation=np.asarray(translation, np.float32),
                device=self.device)
            disparity = disparity.cpu().numpy()
            lo, hi = disparity.min(), disparity.max()
            return (disparity - lo) / max(hi - lo, 1e-9)
        if mode == "rgb":
            from diffusionhandles_tpu_torch.geometry.mesh import \
                depth_to_mesh
            from diffusionhandles_tpu_torch.geometry.renderer import (
                Camera, RasterRenderer, RasterRendererArgs)
            from diffusionhandles_tpu_torch.geometry.transform import \
                transform_points
            img = s.img[0]  # [3, H, W]
            h, w = img.shape[-2:]
            bg_img = s.bg_img[0] if s.bg_img is not None else img
            mask2d = s.fg_mask.reshape(h, w) > 0.5

            def colors(x):
                return torch.from_numpy(np.ascontiguousarray(
                    x.astype(np.float32))).to(self.device)

            bg_mesh = depth_to_mesh(s.bg_depth, K, device=self.device)
            bg_mesh.add_vert_attribute("color", colors(
                bg_img.reshape(3, -1).T))
            fg_mesh = depth_to_mesh(s.depth, K, mask=mask2d,
                                    device=self.device)
            fg_mesh.add_vert_attribute("color", colors(
                img.reshape(3, -1).T[mask2d.reshape(-1)]))
            fg_mesh.verts = transform_points(
                fg_mesh.verts, rot_angle, np.asarray(rot_axis, np.float32),
                np.asarray(translation, np.float32))

            renderer = RasterRenderer(
                ["flat_vertex_color", "mask", "face_id"],
                RasterRendererArgs(output_res=(h, w), cull_backfaces=True))
            renderer.update_scene({
                "meshes": [bg_mesh, fg_mesh],
                "cameras": [Camera(intrinsics=K)]})
            out = renderer.render()
            rgb = out["flat_vertex_color"]
            # disocclusion: the stretched bg triangles behind the moved
            # object smear colors; darken the uncovered pixels
            rgb = np.where(out["mask"][..., None], rgb, 0.15 * rgb)
            return np.moveaxis(rgb, -1, 0)[None].astype(np.float32)
        raise ValueError(f"unknown preview mode {mode}")


class DiffhandlesPipelineWebapp(Webapp):
    """HTTP wrapper around the orchestrator (the 3-step endpoints,
    reference :138, 254, 617, and the preview), with the browser UI at
    GET /."""

    def __init__(self, pipeline: Optional[DiffhandlesPipeline] = None,
                 port: int = 8888, device=None, **kwargs):
        super().__init__(port=port, **kwargs)
        from diffusionhandles_tpu_torch.service.ui import PIPELINE_UI_HTML
        self.index_html = PIPELINE_UI_HTML
        self.pipeline = pipeline or DiffhandlesPipeline(device=device)
        self.route("set_input_image", self._set_input_image)
        self.route("set_foreground", self._set_foreground)
        self.route("transform_foreground", self._transform_foreground)
        self.route("preview_edit", self._preview_edit)

    def _set_input_image(self, req):
        depth = self.pipeline.set_input_image(
            np.asarray(req["img"], np.float32), str(req["prompt"]))
        return {"depth": depth}

    def _set_foreground(self, req):
        bg_depth = self.pipeline.set_foreground(
            fg_prompt=req.get("fg_prompt"),
            fg_mask=(np.asarray(req["fg_mask"], np.float32)
                     if req.get("fg_mask") is not None else None))
        return {"bg_depth": bg_depth}

    def _transform_foreground(self, req):
        edited_img, edited_disparity = self.pipeline.transform_foreground(
            rot_angle=float(req.get("rot_angle", 0.0)),
            rot_axis=req.get("rot_axis", [0.0, 1.0, 0.0]),
            translation=req.get("translation", [0.0, 0.0, 0.0]),
            fg_weight=req.get("fg_weight"),
            bg_weight=req.get("bg_weight"))
        return {"edited_img": edited_img,
                "edited_disparity": edited_disparity}

    def _preview_edit(self, req):
        return {"preview": self.pipeline.preview_edit(
            rot_angle=float(req.get("rot_angle", 0.0)),
            rot_axis=req.get("rot_axis", [0.0, 1.0, 0.0]),
            translation=req.get("translation", [0.0, 0.0, 0.0]),
            mode=str(req.get("mode", "depth")))}
