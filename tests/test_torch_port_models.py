"""PyTorch port vs the JAX package: CLIP, VAE and U-Net on the same
(converted) weights, fp32, plus the JAX -> port weight converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.models import clip_text as jclip
from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu.models import vae as jvae
from diffusionhandles_tpu_torch.models import clip_text as tclip
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import vae as tvae
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.ops import attention as tatt


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nchw(x):
    return np.array(np.moveaxis(np.asarray(x), -1, 1))


def _close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want| (fp32 summation order)."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def tiny_unet():
    model, params = junet.init_unet_params(junet.tiny_unet_config(), seed=0)
    port = tunet.UNet2DConditionModel(tunet.tiny_unet_config())
    port.load_state_dict(tweights.unet_state_dict(_np(params)), strict=True)
    return model, params, port.eval()


def test_state_dicts_load_strict_both_ways(tiny_unet):
    """The converter produces exactly the port models' keys and shapes."""
    _, params, port = tiny_unet
    sd = tweights.unet_state_dict(_np(params))
    assert set(sd) == set(port.state_dict())
    _, vparams = jvae.init_vae_params(jvae.tiny_vae_config(), seed=1)
    vae = tvae.AutoencoderKL(tvae.tiny_vae_config())
    vsd = tweights.vae_state_dict(_np(vparams))
    assert set(vsd) == set(vae.state_dict())
    vae.load_state_dict(vsd, strict=True)
    _, cparams = jclip.init_clip_params(jclip.tiny_clip_config(), seed=2)
    clip = tclip.CLIPTextModel(tclip.tiny_clip_config())
    csd = tweights.clip_state_dict(_np(cparams))
    assert set(csd) == set(clip.state_dict())
    clip.load_state_dict(csd, strict=True)
    for k, v in csd.items():
        assert tuple(v.shape) == tuple(clip.state_dict()[k].shape), k


def test_unet_tiny_matches_jax_fp32(tiny_unet):
    """eps and the three decoder activations, plus the captured
    cross-attention probabilities: 1e-5 of the largest value."""
    model, params, port = tiny_unet
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    eps_j, acts_j, attn_j = model.apply(params, jnp.asarray(x),
                                        jnp.asarray([7, 500]),
                                        jnp.asarray(ctx),
                                        capture_attention=True)
    with torch.no_grad():
        eps_t, acts_t, attn_t = port(torch.from_numpy(_nchw(x)),
                                     torch.tensor([7, 500]),
                                     torch.from_numpy(ctx),
                                     capture_attention=True)
    _close(eps_t.numpy(), _nchw(eps_j), 1e-5, "eps")
    assert len(acts_t) == 3
    for k in range(3):
        _close(acts_t[k].numpy(), _nchw(acts_j[k]), 1e-5, f"act{k}")
    for part in ("down", "up"):
        for pj, pt in zip(jax.tree.leaves(attn_j[part]),
                          [p for blk in attn_t[part] for p in blk]):
            _close(pt.numpy(), np.asarray(pj), 1e-5, f"probs {part}")


def test_unet_flash_route_matches_jax_with_grad():
    """sample_size 32: the level-0 self-attentions have 1024 tokens and
    take the flash route in both packages (the JAX Pallas kernels in
    interpret mode, the port's plain versions on the CPU). eps and the
    gradient of an activation energy w.r.t. the latents agree to 1e-4 of
    the largest value (fp32)."""
    jcfg = junet.tiny_unet_config(sample_size=32, flash_attention=True)
    model, params = junet.init_unet_params(jcfg, seed=3)
    port = tunet.UNet2DConditionModel(tunet.tiny_unet_config(
        sample_size=32, flash_attention=True)).eval()
    port.load_state_dict(tweights.unet_state_dict(_np(params)), strict=True)
    assert tatt.flash_ok(1024, 1024, head_dim=16)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 32, 32, 5).astype(np.float32)
    ctx = rng.randn(1, 77, 32).astype(np.float32)
    w = rng.randn(1, 32, 32, 32).astype(np.float32)

    def energy(xj):
        eps, acts, _ = model.apply(params, xj, jnp.asarray(300),
                                   jnp.asarray(ctx))
        return jnp.sum(acts[2] * w) + jnp.sum(eps ** 2), eps

    with pltpu.force_tpu_interpret_mode():
        (_, eps_j), grad_j = jax.value_and_grad(energy, has_aux=True)(
            jnp.asarray(x))
    xt = torch.from_numpy(_nchw(x)).requires_grad_(True)
    eps_t, acts_t, _ = port(xt, torch.tensor(300), torch.from_numpy(ctx))
    e = (acts_t[2] * torch.from_numpy(_nchw(w))).sum() + (eps_t ** 2).sum()
    (grad_t,) = torch.autograd.grad(e, xt)
    _close(eps_t.detach().numpy(), _nchw(eps_j), 1e-4, "eps")
    _close(grad_t.numpy(), _nchw(grad_j), 1e-4, "d energy / d latents")


def test_vae_tiny_matches_jax_fp32():
    model, params = jvae.init_vae_params(jvae.tiny_vae_config(), seed=1)
    port = tvae.AutoencoderKL(tvae.tiny_vae_config()).eval()
    port.load_state_dict(tweights.vae_state_dict(_np(params)), strict=True)
    img = np.random.RandomState(2).rand(1, 32, 32, 3).astype(np.float32)
    z_j = model.apply(params, jnp.asarray(img) * 2 - 1,
                      method=jvae.AutoencoderKL.encode)
    dec_j = model.apply(params, z_j, method=jvae.AutoencoderKL.decode)
    with torch.no_grad():
        z_t = port.encode(torch.from_numpy(_nchw(img)) * 2 - 1)
        dec_t = port.decode(torch.from_numpy(_nchw(z_j)))
    _close(z_t.numpy(), _nchw(z_j), 1e-5, "encode")
    _close(dec_t.numpy(), _nchw(dec_j), 1e-5, "decode")


def test_clip_tiny_matches_jax_fp32():
    model, params = jclip.init_clip_params(jclip.tiny_clip_config(), seed=2)
    port = tclip.CLIPTextModel(tclip.tiny_clip_config()).eval()
    port.load_state_dict(tweights.clip_state_dict(_np(params)), strict=True)
    ids = np.random.RandomState(3).randint(0, 1024, (2, 77))
    want = model.apply(params, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = port(torch.from_numpy(ids))
    _close(got.numpy(), np.asarray(want), 1e-5, "last hidden state")
