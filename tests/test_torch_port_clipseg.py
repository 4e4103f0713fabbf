"""The CLIP segmenter, PyTorch port vs the JAX package on the CPU: the CLIP
image encoder's (pooled, patches), the similarity map under mean and eot
pooling, the box proposal, the thresholded and morphology-cleaned mask,
LangSamSegmenter's CLIP-grounding stack into SAM, `estimate_foreground`
and its CLI writing mask.png through the port's PNG codec, and the CLIP
loaders.

Both packages run the same weights: random JAX parameters (made by shape,
`torch_port_rig.random_flax_params`) carried into the port by
`weights_clip.clip_vision_state_dict` and `weights.clip_state_dict`; the
prompt ids come from the same deterministic hash tokenizer. Continuous
values are held to CLIP_RTOL of their largest magnitude; a mask equals
JAX's but where the value it thresholds lies within that tolerance of the
threshold (those pixels are counted).
"""

import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffusionhandles_tpu.models import clip_image as jclip
from diffusionhandles_tpu.models import clip_text as jtext
from diffusionhandles_tpu.models import sam as jsam
from diffusionhandles_tpu.models import segmenter as jseg
from diffusionhandles_tpu.models.weights_clip import convert_clip_vision
from diffusionhandles_tpu.testset import preprocess as jpre
from diffusionhandles_tpu_torch.models import clip_image as tclip
from diffusionhandles_tpu_torch.models import clip_text as ttext
from diffusionhandles_tpu_torch.models import sam as tsam
from diffusionhandles_tpu_torch.models import segmenter as tseg
from diffusionhandles_tpu_torch.models.weights import clip_state_dict
from diffusionhandles_tpu_torch.models.weights_clip import (
    clip_vision_state_dict, load_clip_checkpoint)
from diffusionhandles_tpu_torch.models.weights_sam import sam_state_dict
from diffusionhandles_tpu_torch.testset import preprocess as tpre
from diffusionhandles_tpu_torch.utils.image_io import read_png, save_image
from torch_port_rig import close, near_threshold_mismatch, np_, \
    random_flax_params

CLIP_RTOL = 1e-4
PROMPT = "a red toy car"


@pytest.fixture(scope="module")
def clip():
    """Tiny towers' random JAX params, the port's state dicts, a random
    text projection, and a segmenter pair per pooling mode."""
    icfg = jclip.tiny_clip_image_config()
    tcfg = jtext.tiny_clip_config()
    iparams = random_flax_params(lambda k: jclip.CLIPImageEncoder(icfg).init(
        k, jnp.zeros((1, 32, 32, 3))), 0)
    tparams = random_flax_params(lambda k: jtext.CLIPTextEncoder(tcfg).init(
        k, jnp.zeros((1, 77), jnp.int32)), 1)
    proj = (np.random.RandomState(2).randn(32, 32) * 0.2).astype(np.float32)
    isd, tsd = clip_vision_state_dict(iparams), clip_state_dict(tparams)
    pairs = {}
    for pooling, p in (("mean", None), ("eot", proj)):
        pairs[pooling] = (
            jseg.CLIPSegmenter(icfg, tcfg, iparams, tparams,
                               text_projection=p),
            tseg.CLIPSegmenter(tclip.tiny_clip_image_config(),
                               ttext.tiny_clip_config(), isd, tsd,
                               text_projection=p, device="cpu"))
    return iparams, isd, tsd, proj, pairs


def test_clip_image_encoder_matches_jax(clip):
    iparams, isd, _, _, _ = clip
    cfg = tclip.tiny_clip_image_config()
    enc = tclip.CLIPImageEncoder(cfg)
    enc.load_state_dict(isd, strict=True)
    img = np.random.RandomState(3).rand(2, 3, 40, 48).astype(np.float32)
    wp, wt = jclip.CLIPImageEncoder(jclip.tiny_clip_image_config()).apply(
        iparams, jnp.asarray(np.moveaxis(img, 1, -1)))
    with torch.no_grad():
        gp, gt = enc(torch.from_numpy(img))
    assert gt.shape == (2, 4, 4, 32)
    close(gp, wp, "pooled", CLIP_RTOL)
    close(gt, wt, "patches", CLIP_RTOL)


def test_clip_vision_state_dict_has_release_names(clip):
    """The JAX package's release converter maps the port's HF-named state
    dict back onto the same flax parameters, bit for bit."""
    iparams, isd, _, _, _ = clip
    back = flatten_dict(convert_clip_vision(
        {k: v.numpy() for k, v in isd.items()})["params"])
    want = flatten_dict(iparams["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("pooling", ["mean", "eot"])
def test_similarity_map_box_and_mask_match_jax(clip, pooling):
    """The similarity map [1, H, W]; its midpoint split equals JAX's with
    no pixel at the threshold flipped, so the box proposal and the cleaned
    mask (elliptical close then open, kernel 3 at 160 px) equal JAX's."""
    js, ts = clip[4][pooling]
    img = np.random.RandomState(4).rand(1, 3, 160, 150).astype(np.float32)
    want = js.similarity_map(img, PROMPT)
    got = ts.similarity_map(img, PROMPT)
    close(got, want, "similarity map", CLIP_RTOL)
    lo, hi = np.percentile(want[0], [5, 95])
    thr = (lo + hi) / 2
    tol = CLIP_RTOL * np.abs(want).max()
    n = near_threshold_mismatch(got[0] > thr, want[0] > thr, want[0], tol,
                                thr)
    assert n == 0, n
    np.testing.assert_array_equal(ts.propose_box(img, PROMPT),
                                  js.propose_box(img, PROMPT))
    mask = ts.select_foreground(img, PROMPT)
    assert mask.shape == (1, 1, 160, 150)
    np.testing.assert_array_equal(mask, js.select_foreground(img, PROMPT))


def _sam_pair():
    cfg = jsam.tiny_sam_config()
    s = cfg.img_size
    params = random_flax_params(lambda k: jsam.SamModel(cfg).init(
        k, jnp.zeros((1, s, s, 3)), jnp.zeros((1, 2, 2)),
        jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2, 2)),
        jnp.zeros((1, s // 4, s // 4, 1))), 7)
    return (jsam.PromptableSegmenter(cfg, params=params),
            tsam.PromptableSegmenter(tsam.tiny_sam_config(),
                                     params=sam_state_dict(params),
                                     device="cpu"))


def test_langsam_clip_stack_matches_jax(clip):
    """LangSamSegmenter without a grounder: the CLIP box and similarity
    peak prompt SAM; the mask equals JAX's but at SAM's threshold."""
    js, ts = clip[4]["mean"]
    jsam_seg, tsam_seg = _sam_pair()
    img = np.random.RandomState(5).rand(1, 3, 96, 96).astype(np.float32)
    want = jseg.LangSamSegmenter(clip_segmenter=js, sam=jsam_seg
                                 ).select_foreground(img, PROMPT)
    lang = tseg.LangSamSegmenter(clip_segmenter=ts, sam=tsam_seg)
    got = lang.select_foreground(img, PROMPT)
    assert got.shape == (1, 1, 96, 96)
    sim = ts.similarity_map(img, PROMPT)[0]
    fy, fx = np.unravel_index(np.argmax(sim), sim.shape)
    logits, _ = tsam_seg.mask_logits(img, points=[[int(fx), int(fy)]],
                                     labels=[1],
                                     boxes=ts.propose_box(img, PROMPT))
    n = near_threshold_mismatch(got[:, 0], want[:, 0], logits,
                                CLIP_RTOL * np.abs(logits).max())
    assert n <= 4, n


def test_estimate_foreground_writes_mask(clip, tmp_path):
    """estimate_foreground with a selector writes the mask JAX's writes;
    with none, the CLI subcommand runs the default CLIP segmenter on the
    CPU and writes a binary mask.png through the port's PNG codec."""
    js, ts = clip[4]["mean"]
    img = np.random.RandomState(6).rand(3, 64, 80).astype(np.float32)
    save_image(img, tmp_path / "input.png")
    jpre.estimate_foreground(str(tmp_path / "input.png"), PROMPT,
                             str(tmp_path / "jax.png"), selector=js)
    tpre.estimate_foreground(str(tmp_path / "input.png"), PROMPT,
                             str(tmp_path / "port.png"), selector=ts)
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"),
                                  read_png(tmp_path / "jax.png"))
    tpre.main(["--device", "cpu", "estimate_foreground", "--img_path",
               str(tmp_path / "input.png"), "--prompt", PROMPT,
               "--mask_path", str(tmp_path / "mask.png")])
    mask = read_png(tmp_path / "mask.png")
    assert mask.shape[:2] == (64, 80)
    assert set(np.unique(mask)) <= {0, 255}


def _write_safetensors(path, state):
    header, blobs, off = {}, [], 0
    for k, v in state.items():
        raw = v.contiguous().numpy().tobytes()
        dtype = {torch.float32: "F32", torch.int64: "I64"}[v.dtype]
        header[k] = {"dtype": dtype, "shape": list(v.shape),
                     "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path.write_bytes(struct.pack("<Q", len(head)) + head + b"".join(blobs))


@pytest.mark.parametrize("suffix", [".bin", ".safetensors"])
def test_load_clip_checkpoint(clip, tmp_path, suffix):
    """A full HF CLIPModel state dict (both towers, both projections,
    logit_scale and the position_ids buffers) loads into the towers'
    state dicts bitwise, and the projection as [D, P]; a missing or an
    unknown key fails loudly."""
    _, isd, tsd, proj, _ = clip
    full = {**isd, **tsd, "text_projection.weight": torch.from_numpy(proj.T),
            "logit_scale": torch.tensor(2.6),
            "text_model.embeddings.position_ids": torch.arange(77)[None]}
    path = tmp_path / f"clip{suffix}"
    save = (lambda sd: torch.save(sd, path)) if suffix == ".bin" else (
        lambda sd: _write_safetensors(path, sd))
    save(full)
    icfg, tcfg = tclip.tiny_clip_image_config(), ttext.tiny_clip_config()
    vision, text, tproj = load_clip_checkpoint(str(path), icfg, tcfg)
    assert set(vision) == set(isd) and set(text) == set(tsd)
    assert all(torch.equal(vision[k], isd[k]) for k in isd)
    assert all(torch.equal(text[k], tsd[k]) for k in tsd)
    np.testing.assert_array_equal(np_(tproj), proj)
    save({k: v for k, v in full.items()
          if k != "vision_model.post_layernorm.bias"})
    with pytest.raises(ValueError, match="unassigned"):
        load_clip_checkpoint(str(path), icfg, tcfg)
    save({**full, "vision_model.extra.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="unconsumed"):
        load_clip_checkpoint(str(path), icfg, tcfg)
    save({**full, "visual_adapter.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="no tower"):
        load_clip_checkpoint(str(path), icfg, tcfg)
