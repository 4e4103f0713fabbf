"""The whole four-step edit: PyTorch port vs the JAX package.

Both `DiffusionHandles(variant="tiny")` facades run in fp32 on the SAME
weights (the JAX parameters, converted into the port with
`models/weights.py`) and the same synthetic sample, through
invert_input_image -> generate_input_image -> set_foreground ->
transform_foreground. The rig and the tolerances are those of
tests/test_pipeline_oracle.py (T=6, GMS=4; small-scale weights keep the
random network's fp32 trajectories comparable).
"""

import jax
import numpy as np
import pytest
import torch

from diffusionhandles_tpu.config import DiffusionHandlesConfig as JConfig
from diffusionhandles_tpu.config import GuidedDiffuserConfig as JGConfig
from diffusionhandles_tpu.pipeline import DiffusionHandles as JHandles
from diffusionhandles_tpu_torch.config import \
    DiffusionHandlesConfig as TConfig
from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig as TGConfig
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.pipeline import DiffusionHandles as THandles

T = 6
GMS = 4
PROMPT = "a toy cube on a table"
EDIT = dict(rot_angle=10.0, rot_axis=np.array([0.0, 1.0, 0.0]),
            translation=np.array([0.0, 0.0, 0.0]))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, what, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    maxdiff = np.abs(got - want).max()
    assert maxdiff < rtol * scale, \
        f"{what}: maxdiff {maxdiff:.3e} vs scale {scale:.3e} (rtol {rtol})"


@pytest.fixture(scope="module")
def rig():
    kw = dict(num_timesteps=T, num_optsteps=3, guidance_max_step=GMS,
              dtype="float32", param_dtype="float32",
              activation_store_dtype="float32", flash_attention=False,
              pallas_conv=False, remat_guidance=False)
    jh = JHandles(JConfig(guided_diffuser=JGConfig(**kw)), variant="tiny")
    th = THandles(TConfig(guided_diffuser=TGConfig(**kw)), variant="tiny",
                  device="cpu")
    m = jh.diffuser.models
    rng = np.random.RandomState(42)
    small = lambda tree: jax.tree.map(
        lambda a: (rng.randn(*np.shape(a)) * 0.05).astype(np.float32), tree)
    m.unet_params = small(m.unet_params)
    m.vae_params = small(m.vae_params)
    m.text_params = small(m.text_params)
    tm = th.diffuser.models
    tm.unet.load_state_dict(tweights.unet_state_dict(m.unet_params),
                            strict=True)
    tm.vae.load_state_dict(tweights.vae_state_dict(m.vae_params), strict=True)
    tm.text_encoder.load_state_dict(tweights.clip_state_dict(m.text_params),
                                    strict=True)

    res = jh.img_res
    assert th.img_res == res
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    depth = (2.0 + 0.01 * yy).astype(np.float32)
    fg = ((yy >= res // 3) & (yy < 2 * res // 3)
          & (xx >= res // 3) & (xx < 2 * res // 3))
    depth_fg = depth.copy()
    depth_fg[fg] -= 0.4
    img = np.random.RandomState(0).rand(1, 3, res, res).astype(np.float32)
    sample = dict(img=img, depth=depth_fg[None, None],
                  bg_depth=depth[None, None],
                  fg_mask=fg.astype(np.float32)[None, None])
    return jh, th, sample


def test_four_step_edit_matches_jax(rig):
    jh, th, s = rig
    # step 1: inversion (DDIM loop + null-text Adam, fused recording)
    j_null, j_noise = jh.invert_input_image(s["img"], s["depth"], PROMPT)
    t_null, t_noise = th.invert_input_image(s["img"], s["depth"], PROMPT)
    _close(t_noise, j_noise, "init_noise", 2e-4)
    _close(t_null, j_null, "null_text_emb", 2e-3)

    # step 2: served from the fused capture
    _, _, j_acts, j_lat = jh.generate_input_image(s["depth"], PROMPT, j_null,
                                                  j_noise)
    _, _, t_acts, t_lat = th.generate_input_image(s["depth"], PROMPT, t_null,
                                                  t_noise)
    _close(t_lat, j_lat, "recon latents", 1e-3)
    assert len(t_acts) == 3
    for k in range(3):
        _close(t_acts[k], j_acts[k], f"activations[{k}]", 1e-3)

    # the standalone recording loop (the facade's fallback) agrees with it
    acts2, lat2, _, _ = th.diffuser.initial_inference(
        t_noise, th._disparity(s["depth"]), t_null, PROMPT)
    _close(lat2, j_lat, "recon latents (standalone)", 1e-3)
    for k in range(3):
        _close(acts2[k], j_acts[k], f"activations[{k}] (standalone)", 1e-3)

    # steps 3 + 4: depth harmonization, pc transform, guided denoising
    j_bg = jh.set_foreground(s["depth"], s["fg_mask"], s["bg_depth"])
    t_bg = th.set_foreground(s["depth"], s["fg_mask"], s["bg_depth"])
    _close(t_bg, j_bg, "harmonized bg depth", 1e-5)
    j_img, j_disp = jh.transform_foreground(
        depth=s["depth"], prompt=PROMPT, fg_mask=s["fg_mask"], bg_depth=j_bg,
        null_text_emb=j_null, init_noise=j_noise, activations=j_acts, **EDIT)
    t_img, t_disp = th.transform_foreground(
        depth=s["depth"], prompt=PROMPT, fg_mask=s["fg_mask"], bg_depth=t_bg,
        null_text_emb=t_null, init_noise=t_noise, activations=t_acts, **EDIT)
    assert isinstance(t_img, np.ndarray) and t_img.shape == (1, 3, 32, 32)
    _close(t_disp, j_disp, "edited disparity", 1e-5)
    _close(t_img, j_img, "edited image", 5e-3)


def test_null_optimization_full_adam_trajectory(rig):
    """epsilon = -1 disables the early stop on both sides: all 5 fresh-Adam
    iterations run at every timestep."""
    jh, th, s = rig
    disparity = 255.0 * (1.0 / s["depth"] - (1.0 / s["depth"]).min()) / (
        (1.0 / s["depth"]).max() - (1.0 / s["depth"]).min())
    _, j_noise, j_null = jh.inverter.invert(
        np.moveaxis(s["img"], 1, -1), disparity, PROMPT, num_inner_steps=5,
        early_stop_epsilon=-1.0)
    _, t_noise, t_null = th.inverter.invert(
        torch.from_numpy(s["img"]), disparity.astype(np.float32), PROMPT,
        num_inner_steps=5, early_stop_epsilon=-1.0)
    _close(t_noise, np.moveaxis(_np(j_noise), -1, 1), "init_noise", 2e-4)
    _close(t_null, j_null, "null_text_emb (5 Adam iters)", 2e-3)
