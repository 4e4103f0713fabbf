"""save_denoising_steps (configs/full_debug.yaml): PyTorch port vs the
JAX package on the CPU.

Both facades load configs/full_debug.yaml (the rig overrides only the
timesteps, the guidance steps and the dtypes) and run transform_foreground
on the same recorded inputs: a 3-tuple with the per-step decodes
{"opt": [(post-opt image, post-CFG image)] * T}, numpy [1, H, W, 3].
"""

import pathlib

import numpy as np
import pytest

from diffusionhandles_tpu import config as jconfig
from diffusionhandles_tpu_torch import config as tconfig
from torch_port_rig import (torch_on_one_thread,  # noqa: F401
                            EDIT, T, close, edit_args, make_rig, one_thread,
                            with_guided)

FULL_DEBUG = pathlib.Path(__file__).parents[1] / "configs" / "full_debug.yaml"


def test_full_debug_config_loads():
    t = tconfig.load_config(FULL_DEBUG)
    assert t.guided_diffuser.save_denoising_steps is True
    assert (tconfig.config_to_dict(t)
            == jconfig.config_to_dict(jconfig.load_config(FULL_DEBUG)))


@pytest.fixture(scope="module")
def rig():
    jh, th, s, rec = make_rig(FULL_DEBUG)
    assert th.conf.guided_diffuser.save_denoising_steps
    return jh, th, s, rec


def test_save_denoising_steps_matches_jax(rig):
    jh, th, s, rec = rig
    j_img, j_disp, j_steps = jh.transform_foreground(**edit_args(s, rec),
                                                     **EDIT)
    out = th.transform_foreground(**edit_args(s, rec), **EDIT)
    assert isinstance(out, tuple) and len(out) == 3
    t_img, t_disp, t_steps = out
    res = th.img_res
    assert t_img.shape == (1, 3, res, res)
    close(t_disp, j_disp, "edited disparity", 1e-5)
    close(t_img, j_img, "edited image", 5e-3)
    assert set(t_steps) == {"opt"} and len(t_steps["opt"]) == T
    for i, ((t_opt, t_step), (j_opt, j_step)) in enumerate(
            zip(t_steps["opt"], j_steps["opt"])):
        for got, want, what in ((t_opt, j_opt, "post-opt"),
                                (t_step, j_step, "post-CFG")):
            assert isinstance(got, np.ndarray)
            assert got.shape == (1, res, res, 3)
            assert got.min() >= 0.0 and got.max() <= 1.0
            close(got, np.asarray(want), f"step {i} {what} image", 5e-3)
    # the last step's post-CFG latents are the final image's
    np.testing.assert_array_equal(t_steps["opt"][-1][1][0],
                                  np.moveaxis(t_img[0], 0, -1))
    # past guidance_max_step "post opt" is the previous step's latents
    gms = th.conf.guided_diffuser.guidance_max_step
    np.testing.assert_array_equal(t_steps["opt"][gms][0],
                                  t_steps["opt"][gms - 1][1])


def test_final_image_equals_flag_off_run(rig):
    """The guided loop is the same with the flag on: the final image and
    disparity are bitwise those of the flag-off run (on one thread, see
    one_thread)."""
    _, th, s, rec = rig
    try:
        with one_thread():
            on_img, on_disp, _ = th.transform_foreground(
                **edit_args(s, rec), **EDIT)
            with_guided(th, save_denoising_steps=False)
            out = th.transform_foreground(**edit_args(s, rec), **EDIT)
    finally:
        with_guided(th, save_denoising_steps=True)
    assert len(out) == 2
    np.testing.assert_array_equal(out[0], on_img)
    np.testing.assert_array_equal(out[1], on_disp)
