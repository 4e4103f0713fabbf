"""The small-weights rig that holds the PyTorch port's whole edit to the
JAX package on the CPU (shared by the tests/test_torch_port_*.py files of
the edit's entry points).

Both `DiffusionHandles(variant="tiny")` facades run in fp32 on the SAME
weights (the JAX parameters scaled down to std 0.05, converted into the
port with `models/weights.py`): the random network's fp32 trajectories
stay comparable, as in tests/test_torch_port_pipeline.py. A config file's
own switches are kept; the rig overrides only the timesteps, the
guidance steps and the dtypes (and routes attention densely).

The auxiliary models' parity tests (CLIP, SAM, GroundingDINO, text2img)
take two helpers from here: `random_flax_params` (random JAX parameters
made by shape, with no flax init to compile) and
`near_threshold_mismatch` (masks compared but at their threshold).
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from diffusionhandles_tpu import config as jconfig
from diffusionhandles_tpu.pipeline import DiffusionHandles as JHandles
from diffusionhandles_tpu_torch import config as tconfig
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.pipeline import DiffusionHandles as THandles

T = 6
GMS = 4
PROMPT = "a toy cube on a table"
RIG_OVERRIDES = dict(num_timesteps=T, guidance_max_step=GMS,
                     dtype="float32", param_dtype="float32",
                     activation_store_dtype="float32", flash_attention=False,
                     pallas_conv=False)


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def close(got, want, what, rtol):
    """max |got - want| < rtol * max |want|."""
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-6)
    maxdiff = np.abs(got - want).max()
    assert maxdiff < rtol * scale, \
        f"{what}: maxdiff {maxdiff:.3e} vs scale {scale:.3e} (rtol {rtol})"


def _configs(config_file=None, **overrides):
    jc = jconfig.load_config(config_file)
    tc = tconfig.load_config(config_file)
    for c in (jc, tc):
        for k, v in {**RIG_OVERRIDES, **overrides}.items():
            if hasattr(c.guided_diffuser, k):
                setattr(c.guided_diffuser, k, v)
            else:
                setattr(c, k, v)
    return jc, tc


def sample(res: int):
    """A box foreground 0.4 in front of a sloped background, NCHW numpy."""
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    depth = (2.0 + 0.01 * yy).astype(np.float32)
    fg = ((yy >= res // 3) & (yy < 2 * res // 3)
          & (xx >= res // 3) & (xx < 2 * res // 3))
    depth_fg = depth.copy()
    depth_fg[fg] -= 0.4
    img = np.random.RandomState(0).rand(1, 3, res, res).astype(np.float32)
    return dict(img=img, depth=depth_fg[None, None],
                bg_depth=depth[None, None],
                fg_mask=fg.astype(np.float32)[None, None])


def make_rig(config_file=None, **overrides):
    """(JAX handles, port handles on the CPU, sample, recording): both
    facades on the same small weights; `recording` is the port's
    reconstruction pass (null-text embeddings, noise, activation stacks,
    as numpy), the inputs both sides' transform_foreground take."""
    jc, tc = _configs(config_file, **overrides)
    jh = JHandles(jc, variant="tiny")
    th = THandles(tc, variant="tiny", device="cpu")
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
    s = sample(jh.img_res)
    null, noise, acts, _ = th.generate_input_image(s["depth"], PROMPT)
    rec = dict(null_text_emb=np_(null), init_noise=np_(noise),
               activations=[np_(a) for a in acts])
    return jh, th, s, rec


def edit_args(s, rec) -> dict:
    """transform_foreground's inputs but the transform."""
    return dict(depth=s["depth"], prompt=PROMPT, fg_mask=s["fg_mask"],
                bg_depth=s["bg_depth"], **rec)


EDIT = dict(rot_angle=10.0, rot_axis=np.array([0.0, 1.0, 0.0]),
            translation=np.array([0.0, 0.0, 0.0]))


def with_guided(handles, **fields) -> None:
    """Set `fields` of the handles' guided-diffuser config in place (the
    diffuser holds the same object and reads it at each call)."""
    for k, v in fields.items():
        setattr(handles.conf.guided_diffuser, k, v)


@contextlib.contextmanager
def one_thread():
    """Run torch on one CPU thread: ATen's multi-threaded CPU conv
    backward splits its sums by thread (a tiny U-Net's 1x1-pixel convs
    differ run to run by ~1 ulp), so only a single thread makes two runs
    of the same loop comparable bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    """The tiny models' ops are too small to share out: with the suite's
    workers side by side, torch's threads only wait on each other. A test
    module that imports this runs torch on one thread."""
    with one_thread():
        yield


def random_flax_params(init, seed: int, scale: float = 0.05):
    """Seeded random values in the parameter tree that `init(key)` (a flax
    `Module.init` closure) would make, found by shape alone (no compile):
    kernels N(0, 1 / fan_in), norm scales 1 + scale * N(0, 1), every other
    leaf scale * N(0, 1). numpy float32 leaves."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        noise = rng.randn(*s.shape).astype(np.float32)
        leaf = path[-1].key
        if leaf == "kernel":
            return noise / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        return noise * np.float32(scale) + (leaf == "scale")

    return jax.tree_util.tree_map_with_path(fill, shapes)


def near_threshold_mismatch(got, want, value, tol: float, thresh=0.0):
    """The number of pixels where masks `got` and `want` differ while the
    continuous `value` they threshold lies within `tol` of `thresh`; fails
    if they differ anywhere else."""
    got, want, value = (np.asarray(a) for a in (got, want, value))
    differ = got != want
    near = np.abs(value - thresh) <= tol
    assert not (differ & ~near).any(), (
        f"{int((differ & ~near).sum())} mask pixels differ away from the "
        f"threshold")
    return int(differ.sum())
