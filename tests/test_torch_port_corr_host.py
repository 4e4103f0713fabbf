"""The packed [N, 4] host correspondence path: PyTorch port vs the JAX
package on the CPU.

`utils/correspondences.py`, `guidance.process_correspondences`,
`geometry/transform.transform_depth` in pc mode, and the diffuser's
`guided_inference` fed [N, 4] rows, each held to its JAX counterpart on
the same numpy inputs; then the port's host path against its own device
path (`transform_depth_pc_processed`).
"""

import numpy as np
import pytest
import torch

from diffusionhandles_tpu import guidance as jguidance
from diffusionhandles_tpu.geometry import transform as jtransform
from diffusionhandles_tpu.utils import correspondences as jcorr
from diffusionhandles_tpu_torch import guidance as tguidance
from diffusionhandles_tpu_torch.geometry import transform as ttransform
from diffusionhandles_tpu_torch.utils import correspondences as tcorr
from torch_port_rig import (torch_on_one_thread,  # noqa: F401
                            EDIT, PROMPT, close, make_rig, np_,
                            one_thread, sample)

FIELDS = ("corr_ox", "corr_oy", "corr_tx", "corr_ty", "corr_w",
          "bg_mask_orig", "bg_mask_trans", "bg_mask_both")


def _intrinsics():
    f = 1.0 / np.tan(0.5 * 55.0 * np.pi / 180.0)
    return np.array([[f, 0, 0], [0, f, 0], [0, 0, 1]], np.float32)


def test_pack_unpack_round_trip():
    rng = np.random.RandomState(0)
    cols = [rng.randint(0, 512, 40) for _ in range(4)]
    packed = tcorr.pack_correspondences(*cols)
    assert packed.dtype == np.int64 and packed.shape == (40, 4)
    np.testing.assert_array_equal(packed, jcorr.pack_correspondences(*cols))
    for got, want in zip(tcorr.unpack_correspondences(packed), cols):
        np.testing.assert_array_equal(got, want)
    empty = tcorr.unpack_correspondences(np.zeros((0, 4), np.int64))
    assert all(e.shape == (0,) and e.dtype == np.int64 for e in empty)


def _rows(n, img_res, seed):
    """Random rows, some transformed pixels outside the image, many
    duplicated cells."""
    rng = np.random.RandomState(seed)
    o = rng.randint(0, img_res, (n, 2))
    t = np.clip(o + rng.randint(-6, 7, (n, 2)), -3, img_res + 2)
    return np.concatenate([o, t], 1).astype(np.int64)


@pytest.mark.parametrize("bg_erosion,max_corr", [(0, 4096), (2, 4096),
                                                 (0, 40)])
def test_process_correspondences_matches_jax(bg_erosion, max_corr):
    """Integer fields, weights and masks equal exactly; more distinct
    pairs than max_corr keep the highest counts with a warning."""
    rows = _rows(600, 64, seed=bg_erosion + max_corr)
    kw = dict(img_res=64, bg_erosion=bg_erosion, max_corr=max_corr,
              latent_res=16)
    if max_corr < 600:
        with pytest.warns(UserWarning, match="truncating"):
            want = jguidance.process_correspondences(rows, **kw)
        with pytest.warns(UserWarning, match="truncating"):
            got = tguidance.process_correspondences(rows, device="cpu", **kw)
    else:
        want = jguidance.process_correspondences(rows, **kw)
        got = tguidance.process_correspondences(rows, device="cpu", **kw)
    for f in FIELDS:
        g, w = np_(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    inside = rows[(rows[:, 2:] >= 0).all(1) & (rows[:, 2:] < 64).all(1)]
    distinct = len(np.unique(inside // 4, axis=0))
    assert (np_(got.corr_w) > 0).sum() == min(max_corr, distinct)


@pytest.mark.parametrize("loss_type,patch", [("global_avg", 1),
                                             ("local_avg", 3)])
def test_convenience_losses_match_jax(loss_type, patch):
    """foreground_loss and background_loss (precompute + apply in one
    call) on the same activations and binned rows, fp32."""
    pc_kw = dict(img_res=64, bg_erosion=1, max_corr=512, latent_res=16)
    rows = _rows(300, 64, seed=3)
    jpc = jguidance.process_correspondences(rows, **pc_kw)
    tpc = tguidance.process_correspondences(rows, device="cpu", **pc_kw)
    rng = np.random.RandomState(5)
    cur, orig = (rng.randn(8, 8, 6).astype(np.float32) for _ in range(2))
    chw = lambda a: torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(a, -1, 0)))
    size = (16, 16)
    want = jguidance.foreground_loss(cur, orig, jpc, patch, size)
    got = tguidance.foreground_loss(chw(cur), chw(orig), tpc, patch, size)
    close(got, want, "foreground_loss", 1e-5)
    want = jguidance.background_loss(cur, orig, jpc, patch, size, loss_type)
    got = tguidance.background_loss(chw(cur), chw(orig), tpc, patch, size,
                                    loss_type)
    close(got, want, "background_loss", 1e-5)


@pytest.mark.parametrize("edit", [
    dict(rot_angle=25.0, rot_axis=[0.0, 1.0, 0.0], translation=[0.0] * 3),
    dict(rot_angle=-10.0, rot_axis=[1.0, 0.0, 0.0],
         translation=[0.05, 0.0, 0.1]),
    "empty"])
def test_transform_depth_pc_matches_jax(edit):
    """Disparity within 1e-5 of its scale, correspondences equal."""
    s = sample(48)
    fg = s["fg_mask"] * 0 if edit == "empty" else s["fg_mask"]
    kw = {} if edit == "empty" else edit
    jd, jc = jtransform.transform_depth_pc(s["depth"], s["bg_depth"], fg,
                                           _intrinsics(), **kw)
    td, tc = ttransform.transform_depth(s["depth"], s["bg_depth"], fg,
                                        _intrinsics(),
                                        depth_transform_mode="pc",
                                        device="cpu", **kw)
    assert isinstance(td, torch.Tensor) and td.shape == (1, 1, 48, 48)
    close(td, jd, "edited disparity", 1e-5)
    assert tc.dtype == np.int64 and tc.shape == jc.shape
    np.testing.assert_array_equal(tc, jc)
    if edit == "empty":
        assert tc.shape == (0, 4)
    else:
        assert len(tc) > 100


@pytest.fixture(scope="module")
def rig():
    return make_rig()


def test_guided_inference_host_correspondences_matches_jax(rig):
    """guided_inference fed the same [N, 4] rows (binned at the depth
    map's resolution) on both sides: the edited image within the pipeline
    test's 5e-3."""
    jh, th, s, rec = rig
    disp, corr = jtransform.transform_depth_pc(
        s["depth"], s["bg_depth"], s["fg_mask"],
        jh.diffuser.get_depth_intrinsics(), **EDIT)
    disp = np.array(disp)
    assert len(corr) > 50
    nhwc = lambda a: np.moveaxis(np.asarray(a), 1, -1)
    want = jh.diffuser.guided_inference(
        latents=nhwc(rec["init_noise"]), depth=disp,
        uncond_embeddings=rec["null_text_emb"], prompt=PROMPT,
        activations_orig=[nhwc(a) for a in rec["activations"]],
        correspondences=corr)
    got = th.diffuser.guided_inference(
        latents=rec["init_noise"], depth=disp,
        uncond_embeddings=rec["null_text_emb"], prompt=PROMPT,
        activations_orig=rec["activations"], correspondences=corr)
    assert got.shape == (1, 3, 32, 32)
    close(np.moveaxis(np_(got), 1, -1), want, "edited image", 5e-3)


@pytest.mark.parametrize("bg_erosion", [0, 2])
def test_host_path_matches_device_path(rig, bg_erosion):
    """transform_depth + process_correspondences and the device-binned
    transform_depth_pc_processed give the same disparity, the same slots
    (both sort by cell-pair key when nothing is truncated) and so the same
    guided image, bit for bit on one thread."""
    _, th, s, rec = rig
    d = th.diffuser
    args = (s["depth"], s["bg_depth"], s["fg_mask"],
            d.get_depth_intrinsics())
    disp_h, corr = ttransform.transform_depth(*args, device="cpu", **EDIT)
    pc_h = d.process_correspondences(corr, 32, bg_erosion)
    disp_d, pc_d = ttransform.transform_depth_pc_processed(
        *args, bg_erosion=bg_erosion, max_corr=d.conf.max_correspondences,
        latent_res=d.latent_res, device="cpu", **EDIT)
    assert torch.equal(disp_h, disp_d)
    for f in FIELDS:
        assert torch.equal(getattr(pc_h, f).to(getattr(pc_d, f).dtype),
                           getattr(pc_d, f)), f
    if bg_erosion == 0:
        common = dict(latents=rec["init_noise"], depth=disp_h,
                      uncond_embeddings=rec["null_text_emb"], prompt=PROMPT,
                      activations_orig=rec["activations"])
        with one_thread():
            host = d.guided_inference(correspondences=corr, **common)
            dev = d.guided_inference(processed_correspondences=pc_d,
                                     **common)
        assert torch.equal(host, dev)
