"""Text-prompted foreground segmentation (the role of the reference's
LangSAM dependency, reference: test/estimate_foreground.py:11-42).

The counterpart of the JAX package's `models/segmenter.py`:

* `CLIPSegmenter`: the CLIP image encoder's patch tokens scored against
  the prompt's text embedding (cosine), the map upsampled to the image,
  split at the midpoint of its 5th and 95th percentiles and cleaned with
  an elliptical close then open;
* `LangSamSegmenter`: text grounding proposes the prompt, SAM draws the
  mask: GroundingDINO's best box (the reference's LangSAM stack) when a
  grounder or its checkpoint is given, else the CLIP map's box and peak.

The towers run on `device` (default: the GPU) in fp32; they do not turn
TF32 on. The thresholds and box proposals are host numpy, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusionhandles_tpu_torch.models.clip_image import (
    CLIPImageConfig, CLIPImageEncoder, seeded_init_clip_image_,
    tiny_clip_image_config)
from diffusionhandles_tpu_torch.models.clip_text import (CLIPTextConfig,
                                                         CLIPTextModel,
                                                         tiny_clip_config)
from diffusionhandles_tpu_torch.models.tokenizer import load_tokenizer
from diffusionhandles_tpu_torch.ops.morphology import (close, ellipse_kernel,
                                                       open_)
from diffusionhandles_tpu_torch.ops.resize import resize_nhwc
from diffusionhandles_tpu_torch.utils.device import resolve_device


class ForegroundSelector:
    """Service-level interface (the reference's
    webapp/webapps/foreground_selector_webapp.py)."""

    def select_foreground(self, img: np.ndarray,
                          prompt: str) -> np.ndarray:
        """img [1, 3, H, W] in [0, 1] + text prompt -> mask [1, 1, H, W]."""
        raise NotImplementedError


def _midpoint_split(sim: np.ndarray) -> np.ndarray:
    lo, hi = np.percentile(sim, [5, 95])
    return sim > (lo + hi) / 2


class CLIPSegmenter(ForegroundSelector):
    """`image_params` / `text_params` are release-named state dicts of
    CLIPImageEncoder / CLIPTextModel (models/weights_clip.py makes them
    from the JAX package's params or a released CLIPModel file)."""

    def __init__(self, image_config: Optional[CLIPImageConfig] = None,
                 text_config: Optional[CLIPTextConfig] = None,
                 image_params=None, text_params=None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 clip_checkpoint: Optional[str] = None,
                 text_projection=None, device=None):
        """With `clip_checkpoint` (a released HF CLIPModel weight file),
        loads both towers at ViT-B/16 widths and uses CLIP's eot-pooled
        projected text embedding; otherwise seeded random towers (the JAX
        package's small defaults) with mean pooling."""
        self.device = resolve_device(device)
        if clip_checkpoint is not None and image_config is None:
            from diffusionhandles_tpu_torch.models.weights_clip import (
                clip_vit_b16, load_clip_checkpoint)
            image_config, text_config = clip_vit_b16()
            image_params, text_params, text_projection = \
                load_clip_checkpoint(clip_checkpoint, image_config,
                                     text_config)
        self.image_config = image_config or tiny_clip_image_config(
            image_size=224, patch_size=16, hidden_size=256, num_layers=6,
            num_heads=4, projection_dim=256)
        self.text_config = text_config or tiny_clip_config(
            vocab_size=49408, hidden_size=256, intermediate_size=512,
            num_heads=4, num_layers=4)
        self.text_projection = (None if text_projection is None else
                                torch.as_tensor(text_projection,
                                                dtype=torch.float32,
                                                device=self.device))
        if self.image_config.projection_dim != self.text_config.hidden_size:
            raise ValueError("image projection_dim must match text hidden")
        with torch.device(self.device):
            self.image_model = CLIPImageEncoder(self.image_config)
            self.text_model = CLIPTextModel(self.text_config)
        gen = torch.Generator(device=self.device)
        if image_params is None:
            seeded_init_clip_image_(self.image_model, gen.manual_seed(seed))
        else:
            self.image_model.load_state_dict(image_params, strict=True)
        if text_params is None:
            from diffusionhandles_tpu_torch.diffuser import seeded_init_
            with torch.no_grad():
                seeded_init_(self.text_model, gen.manual_seed(seed + 1))
        else:
            self.text_model.load_state_dict(text_params, strict=True)
        for m in (self.image_model, self.text_model):
            m.eval().requires_grad_(False)
        self.tokenizer = load_tokenizer(
            checkpoint_dir, vocab_size=self.text_config.vocab_size)

    @torch.no_grad()
    def similarity_map(self, img: np.ndarray, prompt: str) -> np.ndarray:
        """Dense cosine similarity between patch tokens and the prompt,
        [1, H, W]."""
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        _, patches = self.image_model(x)
        ids = torch.tensor(self.tokenizer([prompt]), dtype=torch.long,
                           device=self.device)
        text = self.text_model(ids)
        if self.text_projection is not None:
            # CLIP pooling: the (post final-LN) hidden state at the eot
            # token (the highest token id), through the text projection
            eot = ids.argmax(dim=-1)
            t = text[torch.arange(text.shape[0]), eot] @ self.text_projection
        else:
            # random-weight mode: mean over positions
            t = text.mean(dim=1)
        patches = patches / (patches.norm(dim=-1, keepdim=True) + 1e-8)
        t = t / (t.norm(dim=-1, keepdim=True) + 1e-8)
        sim = torch.einsum("bhwc,bc->bhw", patches, t)
        h, w = img.shape[-2:]
        sim = resize_nhwc(sim[..., None], (h, w), "bilinear")[..., 0]
        return sim.cpu().numpy()

    def propose_box(self, img: np.ndarray, prompt: str) -> np.ndarray:
        """Text-grounded box [x1, y1, x2, y2]: the bounding box of the
        thresholded similarity region (the role GroundingDINO's box plays
        in LangSAM, reference: test/estimate_foreground.py:37-39)."""
        sim = self.similarity_map(img, prompt)[0]
        mask = _midpoint_split(sim)
        if not mask.any():
            fy, fx = np.unravel_index(np.argmax(sim), sim.shape)
            return np.array([fx - 4, fy - 4, fx + 4, fy + 4], np.float32)
        ys, xs = np.nonzero(mask)
        return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1],
                        np.float32)

    def select_foreground(self, img: np.ndarray, prompt: str,
                          refine_with=None) -> np.ndarray:
        """Text-prompted mask [1, 1, H, W]. With `refine_with` (a
        PromptableSegmenter), the two-stage pipeline: the CLIP box and the
        similarity peak prompt SAM, whose mask is returned."""
        sim = self.similarity_map(img, prompt)[0]
        if refine_with is not None:
            box = self.propose_box(img, prompt)
            fy, fx = np.unravel_index(np.argmax(sim), sim.shape)
            mask, _ = refine_with.predict(img, points=[[int(fx), int(fy)]],
                                          labels=[1], boxes=box)
            return mask
        mask = torch.from_numpy(_midpoint_split(sim))
        k = ellipse_kernel(max(1, mask.shape[-1] // 50))
        mask = open_(close(mask, k), k).numpy()
        return mask.astype(np.float32)[None, None]


class LangSamSegmenter(ForegroundSelector):
    """The LangSAM two-stage pipeline: text grounding proposes prompts,
    SAM (models/sam.py) produces the mask. `sam_checkpoint` loads a
    released sam_vit_* file (at ViT-H widths unless `sam_config` says
    otherwise); `gdino_checkpoint` a released GroundingDINO file, with the
    BERT `vocab.txt` at `bert_vocab_path`."""

    def __init__(self, clip_segmenter: Optional[CLIPSegmenter] = None,
                 sam=None, sam_config=None,
                 sam_checkpoint: Optional[str] = None,
                 grounder=None,
                 gdino_checkpoint: Optional[str] = None,
                 bert_vocab_path: Optional[str] = None, device=None):
        """Grounding stage: a GroundingDINO grounder when `grounder` /
        `gdino_checkpoint` is given (the reference's exact LangSAM stack),
        else CLIP-similarity grounding. The models made here run on
        `device` (default: the GPU)."""
        from diffusionhandles_tpu_torch.models.sam import (
            PromptableSegmenter, sam_vit_h)
        if gdino_checkpoint is not None and grounder is None:
            from diffusionhandles_tpu_torch.models.groundingdino import \
                GroundingDinoGrounder
            grounder = GroundingDinoGrounder(checkpoint_path=gdino_checkpoint,
                                             vocab_path=bert_vocab_path,
                                             device=device)
        self.grounder = grounder
        self.grounding = clip_segmenter or (
            None if grounder is not None else CLIPSegmenter(device=device))
        if sam is None:
            if sam_checkpoint is not None and sam_config is None:
                sam_config = sam_vit_h()
            sam = PromptableSegmenter(config=sam_config,
                                      checkpoint_path=sam_checkpoint,
                                      device=device)
        self.sam = sam

    def select_foreground(self, img: np.ndarray, prompt: str) -> np.ndarray:
        if self.grounder is not None:
            box = self.grounder.best_box(img, prompt)
            mask, _ = self.sam.predict(img, boxes=box)
            return mask
        return self.grounding.select_foreground(img, prompt,
                                                refine_with=self.sam)
