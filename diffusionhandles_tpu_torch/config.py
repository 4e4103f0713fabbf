"""Configuration system.

The same dataclasses and YAML keys as the JAX package's `config.py` (the
reference's OmegaConf schema, diffhandles/config/default.yaml:1-15), so a
config file drives either package. `yaml` is imported inside `load_config`
only: the package must import on hosts that have no PyYAML.

`remat_guidance` sets the U-Net's block recompute (`UNetConfig.remat`).
The fields that select TPU machinery (`pallas_conv`,
`null_opt_inner_loop`) are kept so that configs load unchanged; this
package reads neither.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Optional


@dataclasses.dataclass
class GuidedDiffuserConfig:
    """Hyperparameters of the guided diffuser (reference default.yaml)."""

    bg_weight: float = 1.25
    fg_weight: float = 1.5
    fg_patch_size: int = 1
    bg_patch_size: int = 1
    use_depth: bool = True
    save_denoising_steps: bool = False
    bg_loss_type: str = "global_avg"  # 'global_avg' | 'local_avg'
    num_timesteps: int = 50
    num_optsteps: int = 3
    guidance_max_step: int = 38
    # 'constant' | 'linear' | 'quadratic'
    guidance_schedule_type: str = "constant"
    bg_erosion: int = 0
    seed: int = 2773

    # --- additions without a reference counterpart ---
    # Compute dtype of the diffusion model (U-Net and VAE).
    dtype: str = "bfloat16"
    # Parameter storage dtype of the U-Net and VAE (CLIP stays fp32).
    param_dtype: str = "bfloat16"
    # Classifier-free guidance scale (reference guided_stable_diffuser.py:264).
    guidance_scale: float = 7.5
    # Step size of the guidance descent on the latents
    # (reference guided_stable_diffuser.py:434).
    guidance_lr: float = 0.1
    # Slots of deduplicated (orig-cell, trans-cell) correspondence pairs.
    max_correspondences: int = 16384
    # 'torch_cpu': the reference's seeded torch CPU Mersenne Twister.
    noise_rng: str = "torch_cpu"
    # Storage dtype of the recorded activation stacks.
    activation_store_dtype: str = "bfloat16"
    # Route long U-Net self-attentions through the flash kernels.
    flash_attention: bool = True
    # Recompute the U-Net's blocks in the backward (UNetConfig.remat:
    # False, True or 'dots').
    remat_guidance: bool = False
    # TPU-only switches, read by the JAX package alone.
    pallas_conv: bool = True
    null_opt_inner_loop: str = "while"
    # Capture the guidance activations during the null-text inversion's
    # conditional passes; generate_input_image then serves the capture
    # instead of re-running the recording reconstruction.
    fused_recording: bool = True


SD2_DEPTH = "stabilityai/stable-diffusion-2-depth"
# SDXL base 1.0, conditioned on depth through diffusers/controlnet-depth-
# sdxl-1.0 (diffuser.py)
SDXL_DEPTH_CONTROLNET = "stabilityai/stable-diffusion-xl-base-1.0"


@dataclasses.dataclass
class ModelPathsConfig:
    """Where model weights come from. With `checkpoint_dir` None the models
    get seeded random weights at the real shapes. `model_name` picks the
    model family: SD2_DEPTH (and any other name) or
    SDXL_DEPTH_CONTROLNET."""

    checkpoint_dir: Optional[str] = None
    model_name: str = SD2_DEPTH


@dataclasses.dataclass
class DiffusionHandlesConfig:
    """Top-level config (reference: diffhandles/config/default.yaml)."""

    guided_diffuser: GuidedDiffuserConfig = dataclasses.field(
        default_factory=GuidedDiffuserConfig)
    depth_transform_mode: str = "pc"  # 'pc' | 'mesh' 
    model_paths: ModelPathsConfig = dataclasses.field(
        default_factory=ModelPathsConfig)


def _update_dataclass(obj: Any, data: dict) -> Any:
    for key, value in data.items():
        if not hasattr(obj, key):
            raise KeyError(
                f"Unknown config key '{key}' for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value)
        else:
            setattr(obj, key, value)
    return obj


def load_config(path: Optional[str] = None) -> DiffusionHandlesConfig:
    """Load a config YAML, overlaying it on the defaults."""
    conf = DiffusionHandlesConfig()
    if path is not None:
        import yaml
        with open(pathlib.Path(path), "r") as f:
            data = yaml.safe_load(f) or {}
        _update_dataclass(conf, data)
    return conf


def config_from_dict(data: dict) -> DiffusionHandlesConfig:
    conf = DiffusionHandlesConfig()
    _update_dataclass(conf, data)
    return conf


def config_to_dict(conf: Any) -> dict:
    return dataclasses.asdict(conf)
