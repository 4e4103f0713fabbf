"""SAM, PyTorch port vs the JAX package on the CPU: the image embedding,
the mask decoder under each prompt kind (points, box with points, box
only, mask input), the predictor's mask and IoU, and the release names of
`models/weights_sam.py`.

Both packages run the same weights: random JAX parameters (made by shape,
`torch_port_rig.random_flax_params`) carried into the port by
`sam_state_dict`. Continuous outputs are held to SAM_RTOL of their
largest magnitude; a predicted mask (logits > 0) equals JAX's but where
the port's logit lies within that tolerance of 0, and those pixels are
counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffusionhandles_tpu.models import sam as jsam
from diffusionhandles_tpu.models.weights_sam import convert_sam
from diffusionhandles_tpu_torch.models import sam as tsam
from diffusionhandles_tpu_torch.models.weights_sam import (
    load_sam_checkpoint, sam_state_dict)
from torch_port_rig import close, near_threshold_mismatch, np_, \
    random_flax_params

SAM_RTOL = 1e-4


def _init(cfg):
    s = cfg.img_size
    return lambda key: jsam.SamModel(cfg).init(
        key, jnp.zeros((1, s, s, 3)), jnp.zeros((1, 2, 2)),
        jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2, 2)),
        jnp.zeros((1, s // 4, s // 4, 1)))


def _pair(jcfg, tcfg, seed):
    params = random_flax_params(_init(jcfg), seed)
    sd = sam_state_dict(params)
    return (jsam.PromptableSegmenter(jcfg, params=params),
            tsam.PromptableSegmenter(tcfg, params=sd, device="cpu"), params,
            sd)


@pytest.fixture(scope="module")
def tiny():
    return _pair(jsam.tiny_sam_config(), tsam.tiny_sam_config(), 0)


def test_sam_embed_matches_jax(tiny):
    jseg, tseg, params, _ = tiny
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = jseg._embed(params, jnp.asarray(x))
    with torch.no_grad():
        got = tseg.model.embed(torch.from_numpy(np.moveaxis(x, -1, 1)))
    close(np.moveaxis(np_(got), 1, -1), want, "embedding", SAM_RTOL)


PROMPTS = {
    "point": dict(points=[[[20.0, 30.0], [0.0, 0.0]]], labels=[[1, -1]]),
    "box": dict(points=[[[20.0, 30.0]]], labels=[[0]],
                boxes=[[[5.0, 6.0], [50.0, 40.0]]]),
    "box_only": dict(points=np.zeros((1, 0, 2)), labels=np.zeros((1, 0)),
                     boxes=[[[5.0, 6.0], [50.0, 40.0]]]),
    "mask": dict(points=[[[20.0, 30.0], [40.0, 10.0]]], labels=[[1, 0]],
                 mask=True),
}


@pytest.mark.parametrize("kind", sorted(PROMPTS))
def test_sam_decode_matches_jax(tiny, kind):
    """Mask logits [1, 4, 4E, 4E] and IoU predictions of SamModel.decode
    for each prompt kind (the box-only prompt has no point token)."""
    jseg, tseg, params, _ = tiny
    p = PROMPTS[kind]
    rng = np.random.RandomState(2)
    emb = rng.randn(1, 4, 4, 64).astype(np.float32)
    pts = np.asarray(p["points"], np.float32)
    lbl = np.asarray(p["labels"], np.int32)
    box = None if "boxes" not in p else np.asarray(p["boxes"], np.float32)
    mask = (rng.randn(1, 16, 16, 1).astype(np.float32) if p.get("mask")
            else None)
    j = lambda a: None if a is None else jnp.asarray(a)
    wm, wi = jseg.model.apply(params, j(emb), j(pts), j(lbl), j(box),
                              j(mask), method=jsam.SamModel.decode)
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        gm, gi = tseg.model.decode(
            t(np.moveaxis(emb, -1, 1)), t(pts), t(lbl.astype(np.int64)),
            t(box), None if mask is None else t(np.moveaxis(mask, -1, 1)))
    assert gm.shape == (1, 4, 16, 16) and gi.shape == (1, 4)
    close(gm, wm, f"{kind} mask logits", SAM_RTOL)
    close(gi, wi, f"{kind} iou", SAM_RTOL)


@pytest.mark.parametrize("kind", ["point", "box", "box_only"])
def test_sam_predict_matches_jax(tiny, kind):
    """predict on a non-square image: the preprocessing, the multimask
    choice, the logits resized back and thresholded; the mask equals JAX's
    but for counted pixels at the threshold, the IoU within SAM_RTOL."""
    jseg, tseg, _, _ = tiny
    img = np.random.RandomState(3).rand(1, 3, 80, 56).astype(np.float32)
    kw = {"point": dict(points=[[30, 40]], labels=[1]),
          "box": dict(points=[[30, 40], [5, 5]], labels=[1, 0],
                      boxes=np.array([4.0, 8.0, 50.0, 70.0])),
          "box_only": dict(boxes=np.array([4.0, 8.0, 50.0, 70.0]))}[kind]
    want, wiou = jseg.predict(img, **kw)
    got, giou = tseg.predict(img, **kw)
    logits, _ = tseg.mask_logits(img, **kw)
    assert got.shape == want.shape == (1, 1, 80, 56)
    assert abs(giou - wiou) <= SAM_RTOL * max(abs(wiou), 1.0)
    tol = SAM_RTOL * np.abs(logits).max()
    n = near_threshold_mismatch(got[:, 0], want[:, 0], logits, tol)
    assert n <= 4, n
    np.testing.assert_array_equal(tseg.segment(img, [[30, 40]], [1]),
                                  jseg.segment(img, [[30, 40]], [1]))


def test_sam_state_dict_has_release_names(tiny):
    """The JAX package's release converter maps the port's state dict back
    onto the same flax parameters, bit for bit (the transposed convs' taps
    flipped back)."""
    _, _, params, sd = tiny
    back = flatten_dict(convert_sam({k: v.numpy() for k, v in sd.items()})[
        "params"])
    want = flatten_dict(params["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


def test_sam_checkpoint_roundtrip(tiny, tmp_path):
    """A release-style .pth loads strictly and bitwise; a missing or an
    unknown key fails loudly."""
    _, tseg, _, sd = tiny
    cfg = tsam.tiny_sam_config()
    path = tmp_path / "sam_vit_tiny.pth"
    torch.save(sd, path)
    loaded = load_sam_checkpoint(str(path), cfg)
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    other = tsam.PromptableSegmenter(cfg, checkpoint_path=str(path),
                                     device="cpu")
    img = np.random.RandomState(4).rand(1, 3, 64, 64).astype(np.float32)
    np.testing.assert_array_equal(
        other.mask_logits(img, boxes=[4, 4, 40, 40])[0],
        tseg.mask_logits(img, boxes=[4, 4, 40, 40])[0])
    torch.save({k: v for k, v in sd.items()
                if k != "mask_decoder.iou_token.weight"}, path)
    with pytest.raises(ValueError, match="unassigned"):
        load_sam_checkpoint(str(path), cfg)
    torch.save({**sd, "mask_decoder.extra.weight": torch.zeros(1)}, path)
    with pytest.raises(ValueError, match="unconsumed"):
        load_sam_checkpoint(str(path), cfg)


def test_sam_release_width_embed_and_decode():
    """ViT-H widths (embed_dim 1280, 16 heads, head dim 80, the 256-wide
    decoder) cut to one windowed and one global block at img_size 256: the
    windowed block pads the 16x16 grid to 28x28."""
    kw = dict(img_size=256, depth=2, global_attn_indexes=(1,))
    jcfg = dataclasses.replace(jsam.sam_vit_h(), **kw)
    tcfg = dataclasses.replace(tsam.sam_vit_h(), **kw)
    jseg, tseg, params, _ = _pair(jcfg, tcfg, 5)
    img = np.random.RandomState(6).rand(1, 3, 200, 256).astype(np.float32)
    x, _, _ = jseg._preprocess(img)
    want = jseg._embed(params, x)
    with torch.no_grad():
        xt, _, _ = tseg._preprocess(img)
        got = tseg.model.embed(xt)
    close(np.moveaxis(np_(xt), 1, -1), x, "preprocessed", 1e-6)
    close(np.moveaxis(np_(got), 1, -1), want, "ViT-H-width embedding",
          SAM_RTOL)
    box = np.array([[[20.0, 30.0], [180.0, 150.0]]], np.float32)
    wm, wi = jseg._decode_box(params, want, jnp.zeros((1, 0, 2)),
                              jnp.zeros((1, 0), jnp.int32), jnp.asarray(box))
    with torch.no_grad():
        gm, gi = tseg.model.decode(got, torch.zeros(1, 0, 2),
                                   torch.zeros(1, 0, dtype=torch.long),
                                   torch.from_numpy(box))
    close(gm, wm, "ViT-H-width mask logits", SAM_RTOL)
    close(gi, wi, "ViT-H-width iou", SAM_RTOL)


def test_sam_vit_h_names_and_shapes():
    """SamModel(sam_vit_h()) holds exactly the keys and shapes of the
    release-named torch oracle at ViT-H widths (meta device)."""
    from torch_oracle_sam import Sam
    cfg = tsam.sam_vit_h()
    with torch.device("meta"):
        want = {k: v.shape for k, v in Sam(
            embed_dim=cfg.embed_dim, depth=cfg.depth,
            num_heads=cfg.num_heads,
            global_attn_indexes=cfg.global_attn_indexes).state_dict().items()}
        got = {k: v.shape for k, v in tsam.SamModel(cfg).state_dict().items()}
    assert got == want
