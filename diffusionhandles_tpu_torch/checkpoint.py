"""Input-image-identity checkpoints.

The counterpart of the JAX package's `checkpoint.py` (reference:
test/test_diffusion_handles.py:85-114): the "identity" of an inverted
input image (null-text embeddings, init noise, the three activation
stacks, the latent image) is saved to an npz to skip re-inversion. The
file keeps the reference's field names and NCHW layouts, so a file written
by either package loads in the other. `save_identity` takes, and
`load_identity` returns, the JAX package's in-memory layout (NHWC); this
package's pipeline works in NCHW, so its callers convert with `to_nhwc` /
`to_nchw`.
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict

import numpy as np
import torch


def to_nchw(x):
    """[..., H, W, C] -> [..., C, H, W] (tensors stay on their device)."""
    if isinstance(x, torch.Tensor):
        return torch.movedim(x, -1, -3)
    return np.moveaxis(np.asarray(x), -1, -3)


def to_nhwc(x):
    """[..., C, H, W] -> [..., H, W, C] (tensors stay on their device)."""
    if isinstance(x, torch.Tensor):
        return torch.movedim(x, -3, -1)
    return np.moveaxis(np.asarray(x), -3, -1)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def save_identity(path, null_text_emb, init_noise, activations,
                  latent_image) -> None:
    """Save an identity npz. Inputs are NHWC (numpy or tensors); stored as
    NCHW float32."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path,
             null_text_emb=_f32(null_text_emb),
             init_noise=to_nchw(_f32(init_noise)),
             activations1=to_nchw(_f32(activations[0])),
             activations2=to_nchw(_f32(activations[1])),
             activations3=to_nchw(_f32(activations[2])),
             latent_image=to_nchw(_f32(latent_image)))


def load_identity(path) -> Dict[str, Any]:
    """Load an identity npz -> dict of NHWC float32 numpy arrays."""
    with np.load(path) as data:
        return {
            "null_text_emb": data["null_text_emb"].astype(np.float32),
            "init_noise": to_nhwc(data["init_noise"]).astype(np.float32),
            "activations": [to_nhwc(data[f"activations{i + 1}"]).astype(
                np.float32) for i in range(3)],
            "latent_image": to_nhwc(data["latent_image"]).astype(
                np.float32),
        }
