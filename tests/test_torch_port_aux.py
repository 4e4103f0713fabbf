"""The test set's auxiliary models, PyTorch port vs the JAX package on the
CPU: ZoeDepth-NK (BEiT backbone, DPT neck, metric-bins head, the flip
average of `estimate_depth`) and big-LaMa (FFC generator, the inpainter).

Both packages run the same weights: the JAX parameters, carried into the
port by `models/weights_zoedepth.zoedepth_state_dict` and
`models/weights_lama.lama_state_dict`. Tolerances are the JAX oracle
tests' (tests/test_zoedepth_parity.py, tests/test_lama_parity.py). The
release names are checked by running the JAX package's own converters on
the port's state dicts, and at full width against the torch oracles, on
the meta device (shapes only).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffusionhandles_tpu.models import lama as jlama
from diffusionhandles_tpu.models import zoedepth as jzoe
from diffusionhandles_tpu.models.weights_lama import convert_lama
from diffusionhandles_tpu.models.weights_zoedepth import convert_zoedepth
from diffusionhandles_tpu_torch.models import lama as tlama
from diffusionhandles_tpu_torch.models import zoedepth as tzoe
from diffusionhandles_tpu_torch.models.weights_lama import (
    lama_state_dict, load_lama_checkpoint)
from diffusionhandles_tpu_torch.models.weights_zoedepth import (
    load_zoedepth_checkpoint, zoedepth_state_dict)
from diffusionhandles_tpu_torch.ops.morphology import binary_dilation_iter

ZOE_RTOL, ZOE_ATOL = 1e-3, 1e-4
LAMA_ATOL = 2e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _same_tree(a: dict, b: dict):
    fa, fb = flatten_dict(a), flatten_dict(b)
    assert set(fa) == set(fb), sorted(set(fa) ^ set(fb))[:6]
    for k in fa:
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]),
                                      err_msg=str(k))


# ---------------------------------------------------------------------------
# ZoeDepth-NK
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zoe():
    """The tiny JAX model's parameters with every leaf perturbed (the
    zero-initialized cls token, q/v biases and bias tables included), and
    the port's estimator on them."""
    cfg = jzoe.tiny_zoedepth_config()
    params = jax.jit(jzoe.ZoeDepthModel(cfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32))
    rng = np.random.RandomState(0)
    params = jax.tree.map(lambda a: np.asarray(a) + (
        rng.randn(*a.shape) * 0.02).astype(np.float32), params)
    sd = zoedepth_state_dict(params)
    est = tzoe.ZoeDepthEstimator(tzoe.tiny_zoedepth_config(), params=sd,
                                 device="cpu")
    return cfg, params, sd, est


def test_zoedepth_nk_matches_jax(zoe):
    """Domain probabilities, relative depth and the routed metric depth
    of ZoeDepthNK at the backbone's size."""
    cfg, params, _, est = zoe
    size = cfg.backbone.image_size
    x = np.random.RandomState(1).randn(2, size, size, 3).astype(
        np.float32) * 0.5
    d_j, p_j, r_j = jax.jit(jzoe.ZoeDepthNK(cfg).apply)(
        {"params": params["params"]["nk"]}, jnp.asarray(x))
    with torch.no_grad():
        d_t, p_t, r_t = est.model.nk(torch.from_numpy(np.moveaxis(x, -1, 1)))
    np.testing.assert_allclose(_np(p_t), np.asarray(p_j), rtol=ZOE_RTOL,
                               atol=ZOE_ATOL)
    np.testing.assert_array_equal(_np(p_t).argmax(-1),
                                  np.asarray(p_j).argmax(-1))
    np.testing.assert_allclose(_np(r_t), np.asarray(r_j), rtol=ZOE_RTOL,
                               atol=ZOE_ATOL)
    np.testing.assert_allclose(_np(d_t), np.asarray(d_j), rtol=ZOE_RTOL,
                               atol=ZOE_ATOL)


def test_estimate_depth_matches_jax(zoe):
    """estimate_depth (resize, normalization, flip average, resize back,
    clip) on a non-square image: [1, 1, H, W] within the metric range."""
    cfg, params, _, est = zoe
    img = np.random.RandomState(2).rand(1, 3, 48, 40).astype(np.float32)
    want = jzoe.ZoeDepthEstimator(cfg, params=params).estimate_depth(img)
    got = est.estimate_depth(img)
    assert got.shape == (1, 1, 48, 40)
    assert cfg.min_depth <= got.min() and got.max() <= cfg.max_depth
    np.testing.assert_allclose(got, want, rtol=ZOE_RTOL, atol=ZOE_ATOL)


def test_zoedepth_state_dict_has_release_names(zoe):
    """The JAX package's release-checkpoint converter maps the port's
    state dict back onto the same parameters."""
    _, params, sd, _ = zoe
    back = convert_zoedepth({k: v.numpy() for k, v in sd.items()})
    _same_tree(back["params"], params["params"])


def test_zoedepth_checkpoint_roundtrip(zoe, tmp_path):
    """A release-style {'model': sd} file, with the buffers the release
    holds, loads strictly through load_zoedepth_checkpoint; a missing key
    fails loudly."""
    _, _, sd, est = zoe
    cfg = tzoe.tiny_zoedepth_config()
    release = dict(sd)
    release["core.core.pretrained.model.blocks.0.attn."
            "relative_position_index"] = torch.zeros(17, 17, dtype=torch.long)
    path = tmp_path / "ZoeD_M12_NK.pt"
    torch.save({"model": release}, path)
    loaded = load_zoedepth_checkpoint(str(path), cfg)
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    img = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    other = tzoe.ZoeDepthEstimator(cfg, checkpoint_path=str(path),
                                   device="cpu")
    np.testing.assert_array_equal(other.estimate_depth(img),
                                  est.estimate_depth(img))
    del release["conv2.weight"]
    torch.save(release, path)
    with pytest.raises(ValueError, match="unassigned"):
        load_zoedepth_checkpoint(str(path), cfg)


def test_zoedepth_full_width_names_and_shapes():
    """ZoeDepthNK(ZoeDepthConfig()) holds exactly the keys and shapes of
    the release-named torch oracle at zoedepth_nk's widths (meta device)."""
    from torch_oracle_zoedepth import (OracleBEiTConfig, OracleZoeConfig,
                                       OracleZoeDepthNK)
    from diffusionhandles_tpu_torch.models.weights_zoedepth import \
        SKIP_SUFFIXES
    cfg = tzoe.ZoeDepthConfig()
    bb = cfg.backbone
    ocfg = OracleZoeConfig(
        backbone=OracleBEiTConfig(
            image_size=bb.image_size, embed_dim=bb.embed_dim,
            num_layers=bb.num_layers, num_heads=bb.num_heads, hooks=bb.hooks,
            reassemble_channels=bb.reassemble_channels,
            fusion_channels=bb.fusion_channels,
            midas_out_channels=bb.midas_out_channels),
        n_bins=64, bin_embedding_dim=cfg.bin_embedding_dim,
        bottleneck_features=cfg.bottleneck_features,
        n_attractors=cfg.n_attractors, pt_dim=cfg.patch_transformer_dim,
        pt_heads=cfg.patch_transformer_heads,
        pt_layers=cfg.patch_transformer_layers,
        pt_ff=cfg.patch_transformer_ff)
    with torch.device("meta"):
        want = {k: v.shape for k, v in OracleZoeDepthNK(
            ocfg).state_dict().items()
            if not k.endswith(SKIP_SUFFIXES)}
        got = {k: v.shape for k, v in tzoe.ZoeDepthNK(
            cfg).state_dict().items()}
    assert got == want


# ---------------------------------------------------------------------------
# big-LaMa
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lama():
    """Random tiny JAX variables (non-trivial BatchNorm statistics) and the
    port's generator on them."""
    cfg = jlama.tiny_lama_config()
    variables = jax.jit(jlama.LamaGenerator(cfg).init)(
        jax.random.PRNGKey(0), np.zeros((1, 48, 64, cfg.input_nc),
                                        np.float32))
    rng = np.random.RandomState(0)
    variables = {
        "params": jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.05).astype(
            np.float32), variables["params"]),
        "batch_stats": {
            k: jax.tree.map(lambda a: (np.abs(rng.randn(*a.shape)) * 0.3
                                       + 0.5).astype(np.float32), v)
            for k, v in variables["batch_stats"].items()}}
    sd = lama_state_dict(variables, tlama.tiny_lama_config())
    inp = tlama.LamaInpainter(tlama.tiny_lama_config(), params=sd,
                              device="cpu")
    return cfg, variables, sd, inp


def test_lama_generator_matches_jax_nonsquare(lama):
    """The generator on a non-square 48x64 input (catches pad and FFT axis
    mix-ups), within the JAX oracle test's 2e-5."""
    cfg, variables, _, inp = lama
    x = np.random.RandomState(1).rand(1, cfg.input_nc, 48, 64).astype(
        np.float32)
    want = np.moveaxis(np.asarray(jax.jit(jlama.LamaGenerator(cfg).apply)(
        variables, np.moveaxis(x, 1, -1))), -1, 1)
    with torch.no_grad():
        got = _np(inp.model(torch.from_numpy(x)))
    assert got.shape == want.shape == (1, 3, 48, 64)
    np.testing.assert_allclose(got, want, atol=LAMA_ATOL, rtol=0)


def test_remove_foreground_matches_jax(lama):
    """remove_foreground (the mask dilated 3 times, then inpainted): the
    known pixels are the input's bits, the rest within 2e-5 of JAX."""
    cfg, variables, _, inp = lama
    rng = np.random.RandomState(2)
    img = rng.rand(1, 3, 48, 64).astype(np.float32)
    mask = np.zeros((1, 1, 48, 64), np.float32)
    mask[..., 16:30, 20:40] = 1.0
    want = jlama.LamaInpainter(cfg, params=variables).remove_foreground(
        img, mask, dilation=3)
    got = inp.remove_foreground(img, mask, dilation=3)
    np.testing.assert_allclose(got, want, atol=LAMA_ATOL, rtol=0)
    hole = binary_dilation_iter(torch.from_numpy(mask[0, 0]) > 0.5,
                                3).numpy()
    assert hole.sum() > (mask > 0.5).sum()
    keep = np.broadcast_to(~hole, got.shape)
    np.testing.assert_array_equal(got[keep], img[keep])


def test_lama_state_dict_has_release_names(lama):
    """The JAX package's release converter maps the port's state dict
    (less the BatchNorm counters it does not read) back onto the same
    variables."""
    cfg, variables, sd, _ = lama
    back = convert_lama({k: v.numpy() for k, v in sd.items()}, cfg)
    _same_tree(back, variables)


def test_lama_checkpoint_roundtrip(lama, tmp_path):
    """A lightning-style best.ckpt (generator.* beside a discriminator
    entry) loads strictly and bitwise; a missing key fails loudly."""
    _, _, sd, inp = lama
    cfg = tlama.tiny_lama_config()
    ckpt = {"generator." + k: v for k, v in sd.items()}
    ckpt["discriminator.model0.weight"] = torch.zeros(4, 4, 3, 3)
    path = tmp_path / "best.ckpt"
    torch.save({"state_dict": ckpt}, path)
    loaded = load_lama_checkpoint(str(path), cfg)
    assert set(loaded) == set(sd)
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    other = tlama.LamaInpainter(cfg, checkpoint_path=str(path), device="cpu")
    img = np.random.RandomState(3).rand(1, 3, 32, 32).astype(np.float32)
    mask = np.zeros((1, 1, 32, 32), np.float32)
    mask[..., 8:20, 8:20] = 1.0
    np.testing.assert_array_equal(other.inpaint(img, mask),
                                  inp.inpaint(img, mask))
    bare = {k: v for k, v in sd.items() if k != "model.1.ffc.convl2l.weight"}
    torch.save(bare, path)
    with pytest.raises(ValueError, match="unassigned"):
        load_lama_checkpoint(str(path), cfg)


def test_biglama_names_and_shapes():
    """LamaGenerator(LamaConfig()) (ngf 64, 18 blocks, ratio 0.75) holds
    exactly the keys and shapes of the release-named torch oracle (meta
    device)."""
    from torch_oracle_lama import FFCResNetGenerator
    with torch.device("meta"):
        want = {k: v.shape for k, v in FFCResNetGenerator().state_dict(
        ).items()}
        got = {k: v.shape for k, v in tlama.LamaGenerator(
            tlama.LamaConfig()).state_dict().items()}
    assert got == want
