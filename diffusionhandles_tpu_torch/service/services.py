"""The microservices: one per model, and the DiffusionHandles core service.

The counterpart of the JAX package's `service/services.py`, with the same
endpoints (reference: webapp/webapps/*.py, SURVEY.md section 3.5):
  core service: /set_input_image, /set_foreground, /transform_foreground
    (diffhandles_webapp.py)
  depth estimator: /estimate_depth (zoe_depth_webapp.py)
  foreground remover: /remove_foreground (lama_inpainter_webapp.py)
  foreground selector: /select_foreground (langsam_segmenter_webapp.py)
  text2img: /generate (stablediff_text2img_webapp.py)

Arrays travel inline (service.base); the input-image identity travels as
the reference's npz (`checkpoint.save_identity`), so an identity made by
either package's service drives the other's. A service builds its
default model on `device` (default: the GPU); handlers hand back numpy.
"""

from __future__ import annotations

import pathlib
import tempfile

import numpy as np

from diffusionhandles_tpu_torch.checkpoint import (load_identity,
                                                   save_identity, to_nchw,
                                                   to_nhwc)
from diffusionhandles_tpu_torch.service.base import Webapp


class DepthEstimatorWebapp(Webapp):
    """Depth service (reference: depth_estimator_webapp.py)."""

    def __init__(self, estimator=None, port: int = 8890, device=None,
                 **kwargs):
        super().__init__(port=port, **kwargs)
        if estimator is None:
            from diffusionhandles_tpu_torch.models.zoedepth import \
                ZoeDepthEstimator
            estimator = ZoeDepthEstimator(device=device)
        self.estimator = estimator
        self.route("estimate_depth", self._estimate_depth)

    def _estimate_depth(self, req: dict) -> dict:
        img = np.asarray(req["img"], np.float32)
        return {"depth": self.estimator.estimate_depth(img)}


class ForegroundRemoverWebapp(Webapp):
    """Reference: foreground_remover_webapp.py / lama_inpainter_webapp.py."""

    def __init__(self, remover=None, port: int = 8891, device=None,
                 **kwargs):
        super().__init__(port=port, **kwargs)
        if remover is None:
            from diffusionhandles_tpu_torch.models.lama import LamaInpainter
            remover = LamaInpainter(device=device)
        self.remover = remover
        self.route("remove_foreground", self._remove_foreground)

    def _remove_foreground(self, req: dict) -> dict:
        img = np.asarray(req["img"], np.float32)
        mask = np.asarray(req["fg_mask"], np.float32)
        dilation = int(req.get("dilation", 3))
        return {"bg_img": self.remover.remove_foreground(img, mask,
                                                         dilation)}


class ForegroundSelectorWebapp(Webapp):
    """Reference: foreground_selector_webapp.py / langsam_segmenter_webapp."""

    def __init__(self, selector=None, port: int = 8892, device=None,
                 **kwargs):
        super().__init__(port=port, **kwargs)
        if selector is None:
            from diffusionhandles_tpu_torch.models.segmenter import \
                CLIPSegmenter
            selector = CLIPSegmenter(device=device)
        self.selector = selector
        self.route("select_foreground", self._select_foreground)

    def _select_foreground(self, req: dict) -> dict:
        img = np.asarray(req["img"], np.float32)
        prompt = str(req["prompt"])
        return {"fg_mask": self.selector.select_foreground(img, prompt)}


class Text2ImgWebapp(Webapp):
    """Reference: text2img_webapp.py / stablediff_text2img_webapp.py."""

    def __init__(self, generator=None, port: int = 8893, variant="sd2",
                 device=None, **kwargs):
        super().__init__(port=port, **kwargs)
        if generator is None:
            from diffusionhandles_tpu_torch.models.text2img import \
                StableText2Img
            generator = StableText2Img(variant=variant, device=device)
        self.generator = generator
        self.route("generate", self._generate)

    def _generate(self, req: dict) -> dict:
        return {"img": self.generator.generate(str(req["prompt"]),
                                               int(req.get("seed", 0)))}


class DiffhandlesWebapp(Webapp):
    """The core editing service (reference: diffhandles_webapp.py).

    /set_input_image: invert and record; returns the input-image identity
      as an npz blob (the reference's field names, :82-96).
    /set_foreground: harmonize the bg depth (:132-163), optionally with
      the bg and fg depth meshes as .glb files (`export_meshes`).
    /transform_foreground: 3D transform and guided generation (:229-312).
    """

    def __init__(self, handles=None, port: int = 8889, variant: str = "sd2",
                 conf=None, device=None, **kwargs):
        super().__init__(port=port, **kwargs)
        if handles is None:
            from diffusionhandles_tpu_torch.pipeline import DiffusionHandles
            handles = DiffusionHandles(conf, variant=variant, device=device)
        self.handles = handles
        self.route("set_input_image", self._set_input_image)
        self.route("set_foreground", self._set_foreground)
        self.route("transform_foreground", self._transform_foreground)

    def _set_input_image(self, req: dict) -> dict:
        img = np.asarray(req["img"], np.float32)
        depth = np.asarray(req["depth"], np.float32)
        prompt = str(req["prompt"])
        h = self.handles
        null_text_emb, init_noise = h.invert_input_image(img, depth, prompt)
        null_text_emb, init_noise, activations, latent_image = \
            h.generate_input_image(depth, prompt, null_text_emb, init_noise)
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "identity.npz"
            save_identity(path, null_text_emb, to_nhwc(init_noise),
                          [to_nhwc(a) for a in activations],
                          to_nhwc(latent_image))
            blob = path.read_bytes()
        return {"input_image_identity": blob}

    def _set_foreground(self, req: dict) -> dict:
        depth = np.asarray(req["depth"], np.float32)
        fg_mask = np.asarray(req["fg_mask"], np.float32)
        bg_depth = np.asarray(req["bg_depth"], np.float32)
        out = {"bg_depth_harmonized":
               self.handles.set_foreground(depth, fg_mask, bg_depth)}
        if req.get("export_meshes", False):
            from diffusionhandles_tpu_torch.geometry.mesh import \
                depth_to_mesh
            from diffusionhandles_tpu_torch.geometry.mesh_io import \
                save_mesh_glb
            K = self.handles.diffuser.get_depth_intrinsics()
            with tempfile.TemporaryDirectory() as tmp:
                for name, d, mask in [("bg_depth_mesh", bg_depth, None),
                                      ("fg_depth_mesh", depth, fg_mask)]:
                    mesh = depth_to_mesh(
                        d, K, mask=mask[0, 0] if mask is not None else None,
                        device=self.handles.device)
                    path = pathlib.Path(tmp) / f"{name}.glb"
                    save_mesh_glb(path, mesh)
                    out[name] = path.read_bytes()
        return out

    def _transform_foreground(self, req: dict) -> dict:
        with tempfile.TemporaryDirectory() as tmp:
            path = pathlib.Path(tmp) / "identity.npz"
            path.write_bytes(req["input_image_identity"])
            ident = load_identity(path)
        # two results, as the JAX service takes: under the config's
        # save_denoising_steps the facade returns three and this raises
        edited_img, edited_disparity = self.handles.transform_foreground(
            depth=np.asarray(req["depth"], np.float32),
            prompt=str(req["prompt"]),
            fg_mask=np.asarray(req["fg_mask"], np.float32),
            bg_depth=np.asarray(req["bg_depth"], np.float32),
            null_text_emb=ident["null_text_emb"],
            init_noise=to_nchw(ident["init_noise"]),
            activations=[to_nchw(a) for a in ident["activations"]],
            rot_angle=float(req.get("rot_angle", 0.0)),
            rot_axis=np.asarray(req.get("rot_axis", [0.0, 1.0, 0.0]),
                                np.float32),
            translation=np.asarray(req.get("translation", [0.0, 0.0, 0.0]),
                                   np.float32),
            fg_weight=req.get("fg_weight"),
            bg_weight=req.get("bg_weight"))
        return {"edited_img": edited_img,
                "edited_disparity": edited_disparity}
