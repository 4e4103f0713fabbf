"""StableText2Img, PyTorch port vs the JAX package on the CPU: the tiny
SD stack in fp32, three CFG DDIM steps from the seeded CPU noise, then the
VAE decode.

Both packages run the same weights: random JAX parameters (made by shape,
`torch_port_rig.random_flax_params`) carried into the port by
`models/weights.py`. The image is held to T2I_ATOL; a second call gives
the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from diffusionhandles_tpu.config import GuidedDiffuserConfig as JGConfig
from diffusionhandles_tpu.diffuser import SDModels as JSDModels
from diffusionhandles_tpu.models import clip_text as jclip
from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu.models import vae as jvae
from diffusionhandles_tpu.models.text2img import StableText2Img as JText2Img
from diffusionhandles_tpu.models.tokenizer import load_tokenizer
from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig as TGConfig
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.models.text2img import \
    StableText2Img as TText2Img
from torch_port_rig import random_flax_params

T2I_ATOL = 1e-4
CONF = dict(use_depth=False, num_timesteps=3, dtype="float32",
            remat_guidance=False)
PROMPT = "a castle at sunset"


def _jax_models():
    """The tiny SD stack with random parameters made by shape (no init
    compile)."""
    ucfg = junet.tiny_unet_config(in_channels=4, remat=False)
    vcfg, ccfg = jvae.tiny_vae_config(), jclip.tiny_clip_config()
    unet, vae = junet.UNet2DCondition(ucfg), jvae.AutoencoderKL(vcfg)
    clip = jclip.CLIPTextEncoder(ccfg)
    s = ucfg.sample_size
    up = random_flax_params(lambda k: unet.init(
        k, jnp.zeros((1, s, s, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, ucfg.cross_attention_dim))), 0)
    vp = random_flax_params(lambda k: vae.init(
        k, jnp.zeros((1, 32, 32, 3))), 1)
    cp = random_flax_params(lambda k: clip.init(
        k, jnp.zeros((1, 77), jnp.int32)), 2)
    return JSDModels(unet, up, vae, vp, clip, cp,
                     load_tokenizer(None, vocab_size=ccfg.vocab_size),
                     ucfg, vcfg, ccfg)


@pytest.fixture(scope="module")
def pair():
    jm = _jax_models()
    t2i = TText2Img(TGConfig(**CONF), variant="tiny", device="cpu")
    tm = t2i.diffuser.models
    tm.unet.load_state_dict(tweights.unet_state_dict(jm.unet_params),
                            strict=True)
    tm.vae.load_state_dict(tweights.vae_state_dict(jm.vae_params),
                           strict=True)
    tm.text_encoder.load_state_dict(tweights.clip_state_dict(jm.text_params),
                                    strict=True)
    return JText2Img(JGConfig(**CONF), models=jm, variant="tiny"), t2i


def test_text2img_tiny_matches_jax_and_repeats(pair):
    j, t = pair
    want = j.generate(PROMPT, seed=7)
    got = t.generate(PROMPT, seed=7)
    res = t.diffuser.image_res
    assert got.shape == want.shape == (1, 3, res, res)
    assert np.isfinite(got).all() and 0.0 <= got.min() <= got.max() <= 1.0
    assert got.std() > 1e-3  # not a flat image
    np.testing.assert_allclose(got, want, rtol=0, atol=T2I_ATOL)
    np.testing.assert_array_equal(t.generate(PROMPT, seed=7), got)
    other = t.generate(PROMPT, seed=8)
    assert np.abs(other - got).max() > 1e-3  # the seed reaches the noise


def test_text2img_interface_is_abstract():
    from diffusionhandles_tpu_torch.models.text2img import Text2Img
    with pytest.raises(NotImplementedError):
        Text2Img().generate(PROMPT)
    assert issubclass(TText2Img, Text2Img)
