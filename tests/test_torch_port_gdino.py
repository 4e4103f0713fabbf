"""GroundingDINO, PyTorch port vs the JAX package on the CPU: the Swin
feature maps (shifted windows), BERT's hidden states under per-phrase
masks and position ids, the phrase masks themselves, the assembled
graph's logits and boxes, the query selection's indices where the scores
tie, `predict_boxes`, LangSamSegmenter's GroundingDINO stack into SAM, one
case at release widths, and the release names and loader of
`models/weights_gdino.py`.

Both packages run the same weights: random JAX parameters (made by shape,
`torch_port_rig.random_flax_params`) carried into the port by
`gdino_state_dict`. Continuous outputs are held to GDINO_RTOL of their
largest magnitude (logits where finite; the -inf pattern equal),
predict_boxes' pixel boxes to BOX_ATOL of the image size, indices and
position ids exactly.

The tiny model reads a 208-pixel image, so that its finest level (52x52)
has 204 border proposals outside (0.01, 0.99): those rows' memory is
zeroed, so their scores tie. 597 rows score above them, and with
num_queries 697 the cut of the top k falls inside the tie: only an
index-ordered selection picks `jax.lax.top_k`'s 100 of them.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from diffusionhandles_tpu.models import bert as jbert
from diffusionhandles_tpu.models import groundingdino as jg
from diffusionhandles_tpu.models import sam as jsam
from diffusionhandles_tpu.models import segmenter as jseg
from diffusionhandles_tpu.models import swin as jswin
from diffusionhandles_tpu.models.weights_gdino import convert_gdino
from diffusionhandles_tpu_torch.models import bert as tbert
from diffusionhandles_tpu_torch.models import groundingdino as tg
from diffusionhandles_tpu_torch.models import sam as tsam
from diffusionhandles_tpu_torch.models import segmenter as tseg
from diffusionhandles_tpu_torch.models import swin as tswin
from diffusionhandles_tpu_torch.models.weights_gdino import (
    gdino_state_dict, load_gdino_checkpoint)
from diffusionhandles_tpu_torch.models.weights_sam import sam_state_dict
from torch_port_rig import close, near_threshold_mismatch, np_, \
    random_flax_params

GDINO_RTOL = 1e-4
BOX_ATOL = 2e-4  # predict_boxes' pixel boxes, in units of the image size
SPECIAL = (101, 102, 119, 120)  # ids that fit the tiny 128-word vocab
SIZE = 208
QUERIES = 697  # 597 rows above the tie + 100 of the 204 tied rows
TEXT_LEN = 32
CAPTION = "a red cube . a blue ball"


def _cfgs(module, **kw):
    return dataclasses.replace(module.tiny_gdino_config(),
                               special_token_ids=SPECIAL, **kw)


def _init(cfg, size):
    return lambda k: jg.GroundingDinoModel(cfg).init(
        k, jnp.zeros((1, size, size, 3)), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), bool))


def _ids():
    ids = np.zeros((1, TEXT_LEN), np.int64)
    ids[0, :8] = [101, 7, 8, 119, 9, 10, 120, 102]
    return ids, ids != 0


@pytest.fixture(scope="module")
def tiny():
    """The tiny model's random JAX params, the port's model on them, and
    one compiled JAX apply that also captures what the query selection
    reads (the encoder memory and the last text layer's tokens)."""
    jcfg = _cfgs(jg, num_queries=QUERIES)
    tcfg = _cfgs(tg, num_queries=QUERIES)
    params = random_flax_params(_init(jcfg, SIZE), 0)
    sd = gdino_state_dict(params)
    model = tg.GroundingDinoModel(tcfg)
    model.load_state_dict(sd, strict=True)
    model.eval()
    last = f"text_layer_{jcfg.enc_layers - 1}"
    apply = jax.jit(lambda p, x, i, m: jg.GroundingDinoModel(jcfg).apply(
        p, x, i, m, capture_intermediates=lambda mdl, _: mdl.name in (
            "enc_output_norm", last)))
    return jcfg, tcfg, params, sd, model, apply, last


def _jax_topk(out, last, mask, k):
    """jax.lax.top_k over the JAX model's own selection scores."""
    (_, _), state = out
    inter = state["intermediates"]
    memory = inter["enc_output_norm"]["__call__"][0]
    txt = inter[last]["__call__"][0]
    txt = jnp.where(mask[..., None], txt, 0.0)
    scores = jnp.max(jnp.where(mask[:, None, :], jnp.einsum(
        "bsd,btd->bst", memory, txt), -jnp.inf), axis=-1)
    return np.asarray(jax.lax.top_k(scores, k)[1]), np.asarray(scores)


@contextlib.contextmanager
def _selection(indices):
    """The port's query selection returns `indices` inside the block."""
    real = tg.select_topk
    tg.select_topk = lambda scores, k: indices
    try:
        yield
    finally:
        tg.select_topk = real


def test_gdino_logits_boxes_and_tied_topk_match_jax(tiny):
    """The selection: the zeroed border rows' scores tie exactly and the
    cut of the top k falls inside the tie, so only index order picks
    JAX's rows there; elsewhere two picks may change places only where
    their scores agree within GDINO_RTOL (an fp32 sum in another order).
    The logits and boxes: the port decoding JAX's selection."""
    jcfg, _, params, _, model, apply, last = tiny
    img = np.random.RandomState(1).randn(1, 3, SIZE, SIZE).astype(
        np.float32) * 0.5
    ids, valid = _ids()
    out = apply(params, jnp.asarray(np.moveaxis(img, 1, -1)),
                jnp.asarray(ids.astype(np.int32)), jnp.asarray(valid))
    (wl, wb), _ = out
    wk, scores = _jax_topk(out, last, jnp.asarray(valid), QUERIES)
    inputs = (torch.from_numpy(img), torch.from_numpy(ids),
              torch.from_numpy(valid))
    with torch.no_grad():
        _, _, gk = model(*inputs, return_topk=True)
        with _selection(torch.tensor(wk, dtype=torch.long)):
            gl, gb = model(*inputs)
    gk, wk, scores = np_(gk)[0], wk[0], scores[0]
    values, counts = np.unique(scores, return_counts=True)
    tie = values[counts > 1]
    tied = scores[wk] == tie[0]
    assert len(tie) == 1 and 0 < tied.sum() < counts.max()
    np.testing.assert_array_equal(gk[tied], wk[tied])
    moved = gk != wk
    tol = GDINO_RTOL * np.abs(scores).max()
    assert (np.abs(scores[gk] - scores[wk])[moved] <= tol).all()
    wl, gl = np.asarray(wl), np_(gl)
    assert gl.shape == (1, QUERIES, jcfg.max_text_len)
    finite = np.isfinite(wl)
    np.testing.assert_array_equal(np.isfinite(gl), finite)
    close(gl[finite], wl[finite], "logits", GDINO_RTOL)
    close(gb, wb, "boxes", GDINO_RTOL)


def test_select_topk_orders_ties_as_lax_top_k():
    rng = np.random.RandomState(2)
    scores = rng.randint(0, 6, size=(3, 200)).astype(np.float32)
    scores[1, 50:] = 2.0
    for k in (1, 17, 150, 200):
        np.testing.assert_array_equal(
            np_(tg.select_topk(torch.from_numpy(scores), k)),
            np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1]))


CAPTIONS = {
    "phrases": [101, 5, 6, 119, 7, 119, 8, 9, 10, 102, 0, 0, 0, 0],
    "question": [101, 5, 120, 6, 7, 119, 102, 0, 0, 0, 0, 0, 0, 0],
    "no_padding": [101, 5, 6, 7, 8, 9, 119, 10, 11, 12, 120, 13, 14, 102],
    "unterminated": [101, 5, 6, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
}


def test_build_text_token_masks_match_jax():
    """Block masks and per-phrase position ids, bit for bit, for a batch
    of captions with several phrases, '?', padding and none."""
    ids = np.array(list(CAPTIONS.values()), np.int64)
    valid = ids != 0
    valid[3, 4:6] = True  # valid tokens after the last special token
    wm, wp = jax.jit(jg.build_text_token_masks, static_argnums=2)(
        jnp.asarray(ids), jnp.asarray(valid), SPECIAL)
    gm, gp = tg.build_text_token_masks(torch.from_numpy(ids),
                                       torch.from_numpy(valid), SPECIAL)
    np.testing.assert_array_equal(np_(gm), np.asarray(wm))
    np.testing.assert_array_equal(np_(gp), np.asarray(wp))
    assert np_(gp).max() > 1


def _sub_state(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def test_swin_matches_jax(tiny):
    """The tiny Swin's three levels on a 72x64 input: its last stage (5x4
    after padding to 6x4, two blocks) runs a shifted window."""
    _, _, params, sd, _, _, _ = tiny
    swin = tswin.SwinTransformer(tswin.tiny_swin_config())
    swin.load_state_dict(_sub_state(sd, "backbone.0."), strict=True)
    x = np.random.RandomState(3).randn(2, 72, 64, 3).astype(np.float32)
    want = jax.jit(jswin.SwinTransformer(jswin.tiny_swin_config()).apply)(
        {"params": params["params"]["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = swin(torch.from_numpy(np.moveaxis(x, -1, 1)))
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for i in got:
        close(np.moveaxis(np_(got[i]), 1, -1), want[i], f"level {i}",
              GDINO_RTOL)


def test_bert_matches_jax(tiny):
    """BERT's hidden states and pooled output under a [B, S, S] phrase
    mask with restarted position ids."""
    _, _, params, sd, _, _, _ = tiny
    bert = tbert.BertModel(tbert.tiny_bert_config())
    bert.load_state_dict(_sub_state(sd, "bert."), strict=True)
    ids = np.array(list(CAPTIONS.values()), np.int64)
    attn, pos = tg.build_text_token_masks(torch.from_numpy(ids),
                                          torch.from_numpy(ids != 0),
                                          SPECIAL)
    wh, wp = jax.jit(jbert.BertModel(jbert.tiny_bert_config()).apply)(
        {"params": params["params"]["bert"]}, jnp.asarray(ids),
        jnp.asarray(np_(attn)), position_ids=jnp.asarray(np_(pos)))
    with torch.no_grad():
        gh, gp = bert(torch.from_numpy(ids), attn, position_ids=pos)
    close(gh, wh, "hidden", GDINO_RTOL)
    close(gp, wp, "pooled", GDINO_RTOL)


def _vocab(path):
    """A 128-word vocab.txt whose special tokens sit at SPECIAL's ids."""
    words = [f"[unused{i}]" for i in range(128)]
    for i, w in {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
                 119: ".", 120: "?", 20: "a", 21: "red", 22: "cu",
                 23: "##be", 24: "blue", 25: "ball"}.items():
        words[i] = w
    path.write_text("\n".join(words))
    return str(path)


def test_predict_boxes_and_langsam_match_jax(tiny, tmp_path):
    """predict_boxes (square resize, ImageNet normalization, the caption's
    WordPiece ids from a vocab.txt, sigmoid phrase scores, the threshold)
    on a non-square image; then LangSamSegmenter with that grounder and a
    tiny SAM, the mask equal to JAX's but at SAM's threshold. The port
    decodes JAX's query selection (held in the test above): this image's
    selection scores hold pairs one fp32 ulp apart."""
    jcfg, tcfg, params, _, _, apply, last = tiny
    # the decoder's output norm scaled by 0.05: phrase logits of order 1,
    # whose sigmoid scores do not saturate at 1.0 (where their order would
    # be a tie); the query selection does not read it
    params = jax.tree.map(np.copy, params)
    for leaf in ("scale", "bias"):
        params["params"]["decoder_norm"][leaf] *= np.float32(0.05)
    sd = gdino_state_dict(params)
    vocab = _vocab(tmp_path / "vocab.txt")
    jgr = jg.GroundingDinoGrounder(jcfg, params=params, input_size=SIZE,
                                   vocab_path=vocab)
    selected = []

    def japply(p, x, i, m):  # compiled once, in the fixture
        out = apply(p, x, i, m)
        selected.append(_jax_topk(out, last, m, QUERIES)[0])
        return out[0]

    jgr._apply = japply
    tgr = tg.GroundingDinoGrounder(tcfg, params=sd, input_size=SIZE,
                                   vocab_path=vocab, device="cpu")
    ids, _ = tgr.tokenizer([CAPTION + "."])
    np.testing.assert_array_equal(ids[0, :9],
                                  [101, 20, 21, 22, 23, 119, 20, 24, 25])
    img = np.random.RandomState(6).rand(1, 3, 120, 96).astype(np.float32)
    wb, ws = jgr.predict_boxes(img, CAPTION, box_threshold=0.0)
    with _selection(torch.tensor(selected[0], dtype=torch.long)):
        gb, gs = tgr.predict_boxes(img, CAPTION, box_threshold=0.0)
        assert gb.shape == wb.shape and gb.shape[1] == 4
        assert ws.max() < 0.99 and ws[0] - ws[1] > 1e-3
        close(gs, ws, "scores", GDINO_RTOL)
        size = np.array([96, 120, 96, 120], np.float32)
        np.testing.assert_allclose(gb[0] / size, wb[0] / size, rtol=0,
                                   atol=BOX_ATOL)

        scfg = jsam.tiny_sam_config()
        s = scfg.img_size
        sparams = random_flax_params(lambda k: jsam.SamModel(scfg).init(
            k, jnp.zeros((1, s, s, 3)), jnp.zeros((1, 2, 2)),
            jnp.zeros((1, 2), jnp.int32), jnp.zeros((1, 2, 2)),
            jnp.zeros((1, s // 4, s // 4, 1))), 5)
        tsam_seg = tsam.PromptableSegmenter(tsam.tiny_sam_config(),
                                            params=sam_state_dict(sparams),
                                            device="cpu")
        want = jseg.LangSamSegmenter(
            grounder=jgr, sam=jsam.PromptableSegmenter(scfg, params=sparams)
        ).select_foreground(img, CAPTION)
        got = tseg.LangSamSegmenter(grounder=tgr, sam=tsam_seg
                                    ).select_foreground(img, CAPTION)
        logits, _ = tsam_seg.mask_logits(img,
                                         boxes=tgr.best_box(img, CAPTION))
    n = near_threshold_mismatch(got[:, 0], want[:, 0], logits,
                                GDINO_RTOL * np.abs(logits).max())
    assert n <= 4, n


def test_gdino_state_dict_has_release_names(tiny):
    """The JAX package's release converter, which checks the top-level
    bbox_embed alias against the decoder's copy, maps the port's state
    dict back onto the same flax parameters, bit for bit."""
    _, _, params, sd, model, _, _ = tiny
    assert set(sd) == set(model.state_dict())
    assert any(k.startswith("bbox_embed.") for k in sd)
    back = flatten_dict(convert_gdino({k: v.numpy() for k, v in sd.items()})[
        "params"])
    want = flatten_dict(params["params"])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=str(k))


def test_gdino_checkpoint_roundtrip(tiny, tmp_path):
    """A release-style {'model': sd} file under a `module.` prefix loads
    strictly and bitwise (the bbox_embed alias one tensor with its decoder
    copy); an alias that disagrees, a missing key and an unknown key fail
    loudly."""
    _, tcfg, _, sd, model, _, _ = tiny
    path = tmp_path / "groundingdino_tiny.pth"
    release = {"module." + k: v for k, v in sd.items()}
    release["module.bert.embeddings.position_ids"] = torch.arange(64)[None]
    torch.save({"model": release, "epoch": 11}, path)
    loaded = load_gdino_checkpoint(str(path), tcfg)
    assert set(loaded) == set(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    other = tg.GroundingDinoModel(tcfg)
    other.load_state_dict(loaded, strict=True)
    assert other.bbox_embed[0].layers[0].weight is \
        other.transformer.decoder.bbox_embed[0].layers[0].weight
    bad = dict(sd)
    bad["bbox_embed.0.layers.0.bias"] = sd["bbox_embed.0.layers.0.bias"] + 1
    torch.save({"model": bad}, path)
    with pytest.raises(ValueError, match="alias mismatch"):
        load_gdino_checkpoint(str(path), tcfg)
    torch.save({"model": {k: v for k, v in sd.items()
                          if k != "transformer.level_embed"}}, path)
    with pytest.raises(ValueError, match="unassigned"):
        load_gdino_checkpoint(str(path), tcfg)
    torch.save({"model": {**sd, "transformer.extra": torch.zeros(1)}}, path)
    with pytest.raises(ValueError, match="unconsumed"):
        load_gdino_checkpoint(str(path), tcfg)


def test_gdino_release_width():
    """d_model 256, 8 heads, 4 levels and 4 points, the 1024-wide fusion,
    Swin-T (the 7x7 window, all four stages) and a 768-wide BERT, cut to
    one layer of BERT, encoder and decoder and 50 queries, at 224 pixels:
    the smallest square input at which every Swin-T stage holds a whole
    window (at 112 pixels the JAX Swin shrinks the last stage's window to
    4, with a bias table no release file holds)."""
    kw = dict(enc_layers=1, dec_layers=1, num_queries=50)
    bert = dict(num_layers=1, vocab_size=1100, max_position_embeddings=64)
    jcfg = jg.GroundingDinoConfig(
        bert=dataclasses.replace(jbert.BertConfig(), **bert), **kw)
    tcfg = tg.GroundingDinoConfig(
        bert=dataclasses.replace(tbert.BertConfig(), **bert), **kw)
    params = random_flax_params(_init(jcfg, 224), 6)
    model = tg.GroundingDinoModel(tcfg)
    model.load_state_dict(gdino_state_dict(params), strict=True)
    img = np.random.RandomState(7).randn(1, 3, 224, 224).astype(
        np.float32) * 0.5
    ids = np.zeros((1, 16), np.int64)
    ids[0, :7] = [101, 55, 66, 1012, 77, 1029, 102]  # '.' 1012, '?' 1029
    valid = ids != 0
    wl, wb = jax.jit(jg.GroundingDinoModel(jcfg).apply)(
        params, jnp.asarray(np.moveaxis(img, 1, -1)),
        jnp.asarray(ids.astype(np.int32)), jnp.asarray(valid))
    with torch.no_grad():
        gl, gb = model(torch.from_numpy(img), torch.from_numpy(ids),
                       torch.from_numpy(valid))
    wl, gl = np.asarray(wl), np_(gl)
    finite = np.isfinite(wl)
    np.testing.assert_array_equal(np.isfinite(gl), finite)
    close(gl[finite], wl[finite], "release-width logits", GDINO_RTOL)
    close(gb, wb, "release-width boxes", GDINO_RTOL)


def test_gdino_swint_ogc_names_and_shapes():
    """GroundingDinoModel(GroundingDinoConfig()) holds exactly the keys and
    shapes of the release-named torch oracle's state dict (the top-level
    bbox_embed alias included) at swint_ogc widths (meta device)."""
    from torch_oracle_gdino import OracleGroundingDino
    cfg = tg.GroundingDinoConfig()
    with torch.device("meta"):
        want = {k: v.shape for k, v in
                OracleGroundingDino(cfg).state_dict_release().items()}
        got = {k: v.shape for k, v in
               tg.GroundingDinoModel(cfg).state_dict().items()}
    assert got == want
