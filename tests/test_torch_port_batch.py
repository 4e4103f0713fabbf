"""Batched multi-transform editing and U-Net remat: PyTorch port vs the
JAX package on the CPU.

`parallel/batch.edit_batch` runs N transforms of one recorded image as one
batched guided denoising (a batch-B U-Net fwd+bwd per guidance iteration,
a batch-2B CFG step). It is held to JAX `edit_batch` row by row, to
itself across chunking and for identical transforms, and to the port's
own sequential edits; `UNetConfig.remat` (from `remat_guidance`) must
change no result.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffusionhandles_tpu.parallel.batch import edit_batch as jedit_batch
from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig
from diffusionhandles_tpu_torch.diffuser import create_sd_models, seeded_init_
from diffusionhandles_tpu_torch.geometry.transform import transform_depth
from diffusionhandles_tpu_torch.models.unet import (UNet2DConditionModel,
                                                    tiny_unet_config)
from diffusionhandles_tpu_torch.parallel import batch as tbatch
from torch_port_rig import torch_on_one_thread  # noqa: F401
from torch_port_rig import PROMPT, close, make_rig, np_

TRANSFORMS = [
    {"rotation_angle": 10.0, "rotation_axis": [0, 1, 0],
     "translation": [0.0, 0.0, 0.0]},
    {"rotation_angle": 0.0, "rotation_axis": [0, 1, 0],
     "translation": [0.05, 0.0, 0.0]},
    {"rotation_angle": -5.0, "rotation_axis": [1, 0, 0],
     "translation": [0.0, 0.02, 0.0]},
]


@pytest.fixture(scope="module")
def rig():
    return make_rig()


def _inputs(s, rec):
    return (s["depth"], PROMPT, s["fg_mask"], s["bg_depth"],
            rec["null_text_emb"], rec["init_noise"], rec["activations"])


def _single(th, s, rec, tr):
    img, _ = th.transform_foreground(
        depth=s["depth"], prompt=PROMPT, fg_mask=s["fg_mask"],
        bg_depth=s["bg_depth"], null_text_emb=rec["null_text_emb"],
        init_noise=rec["init_noise"], activations=rec["activations"],
        rot_angle=tr["rotation_angle"],
        rot_axis=np.asarray(tr["rotation_axis"], np.float32),
        translation=np.asarray(tr["translation"], np.float32))
    return img[0]


def test_edit_batch_matches_jax_rows(rig):
    """Row by row against JAX edit_batch within the pipeline test's 5e-3;
    a transform given twice gives bitwise equal rows."""
    jh, th, s, rec = rig
    trs = TRANSFORMS + [TRANSFORMS[0]]
    want = jedit_batch(jh, *_inputs(s, rec), trs)
    got = tbatch.edit_batch(th, *_inputs(s, rec), trs)
    assert isinstance(got, np.ndarray) and got.shape == (4, 3, 32, 32)
    for i in range(len(trs)):
        close(got[i], want[i], f"row {i}", 5e-3)
    np.testing.assert_array_equal(got[0], got[3])


def test_chunked_matches_unchunked(rig):
    """3 transforms in chunks of 2 (the last padded by repeating its
    transform, the pad discarded) against one batch of 3."""
    _, th, s, rec = rig
    imgs, disps = tbatch.edit_batch(th, *_inputs(s, rec), TRANSFORMS,
                                    chunk=2, return_disparities=True)
    full, full_disps = tbatch.edit_batch(th, *_inputs(s, rec), TRANSFORMS,
                                         return_disparities=True)
    assert imgs.shape == (3, 3, 32, 32) and disps.shape == (3, 1, 32, 32)
    np.testing.assert_array_equal(disps, full_disps)
    close(imgs, full, "chunked images", 1e-5)
    for tr, disp in zip(TRANSFORMS, disps):
        want, _ = transform_depth(
            s["depth"], s["bg_depth"], s["fg_mask"],
            th.diffuser.get_depth_intrinsics(), tr["rotation_angle"],
            tr["rotation_axis"], tr["translation"], device="cpu")
        np.testing.assert_array_equal(disp, np_(want)[0])


@pytest.mark.parametrize("mode", ["pc", "mesh"])
def test_batched_matches_sequential(rig, mode):
    """Batched and sequential edits are the same math in another batching,
    so fp32 sums run in another order; each DDIM step amplifies that
    (as tests/test_batch.py derives): correlation > 0.999 and max
    difference < 0.1 per row."""
    _, th, s, rec = rig
    th.conf.depth_transform_mode = mode
    try:
        imgs = tbatch.edit_batch(th, *_inputs(s, rec), TRANSFORMS[:2])
        singles = [_single(th, s, rec, tr) for tr in TRANSFORMS[:2]]
    finally:
        th.conf.depth_transform_mode = "pc"
    for a, b in zip(imgs, singles):
        a, b = a.ravel(), b.ravel()
        assert np.corrcoef(a, b)[0, 1] > 0.999
        assert np.abs(a - b).max() < 0.1


def test_stack_pcs(rig):
    _, th, s, _ = rig
    d = th.diffuser
    _, corr = transform_depth(s["depth"], s["bg_depth"], s["fg_mask"],
                              d.get_depth_intrinsics(), 10.0, device="cpu")
    pcs = [d.process_correspondences(corr, 32), d.process_correspondences(
        corr[:20], 32)]
    stacked = tbatch.stack_pcs(pcs)
    for f, pc_field in zip(stacked, zip(*pcs)):
        assert f.shape[0] == 2
        for row, want in zip(f, pc_field):
            assert torch.equal(row, want)


class _CountOps(TorchDispatchMode):
    """Counts the matmul and convolution aten ops dispatched."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.convolution.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.OPS
        return func(*args, **(kwargs or {}))


def _eps_and_grad(unet, x, ctx):
    """eps, the latents' gradient of an activation energy, and the number
    of matmuls and convolutions the backward ran."""
    lat = x.clone().requires_grad_(True)
    eps, acts, _ = unet(lat, torch.tensor(500), ctx)
    energy = sum((a ** 2).mean() for a in acts) + (eps ** 2).mean()
    with _CountOps() as count:
        (grad,) = torch.autograd.grad(energy, lat)
    return eps.detach(), grad, count.n


@pytest.mark.parametrize("remat", [True, "dots"])
def test_unet_remat_changes_no_result(remat):
    """remat=True recomputes each down and up block in the backward,
    'dots' recomputes all but the matmuls and convolutions: eps and the
    latents' gradient within 1e-6 relative of remat=False, fp32."""
    cfg = tiny_unet_config()
    base = seeded_init_(UNet2DConditionModel(cfg),
                        torch.Generator().manual_seed(0))
    base.eval().requires_grad_(False)
    other = UNet2DConditionModel(dataclasses.replace(cfg, remat=remat))
    other.load_state_dict(base.state_dict())
    other.eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 5, 8, 8), generator=gen)
    ctx = torch.randn((2, 77, 32), generator=gen)
    e0, g0, n0 = _eps_and_grad(base, x, ctx)
    e1, g1, n1 = _eps_and_grad(other, x, ctx)
    close(e1, e0, "eps", 1e-6)
    close(g1, g0, "latents' gradient", 1e-6)
    if remat is True:
        assert n1 > n0  # the blocks' matmuls and convs ran again
    else:
        assert n1 == n0  # saved, not recomputed


def test_remat_guidance_reaches_the_unet_and_batched_runner(rig,
                                                            monkeypatch):
    """remat_guidance sets UNetConfig.remat; DIFFHANDLES_BATCHED_REMAT gives
    edit_batch's guidance a remat copy of the U-Net on the same weights,
    which changes no image beyond 1e-6 relative."""
    models = create_sd_models(conf=GuidedDiffuserConfig(
        remat_guidance="dots", dtype="float32"), variant="tiny",
        device="cpu")
    assert models.unet_config.remat == "dots"
    _, th, s, rec = rig
    built = []
    real = tbatch._unet_copy

    def spy(unet, **switches):
        copy = real(unet, **switches)
        built.append(copy.config.remat)
        assert (copy.conv_in.weight.data_ptr()
                == unet.conv_in.weight.data_ptr())  # the same storage
        return copy

    monkeypatch.setattr(tbatch, "_unet_copy", spy)
    monkeypatch.delenv("DIFFHANDLES_BATCHED_REMAT", raising=False)
    plain = tbatch.edit_batch(th, *_inputs(s, rec), TRANSFORMS[1:2])
    for value, mode in (("dots", "dots"), ("1", True)):
        monkeypatch.setenv("DIFFHANDLES_BATCHED_REMAT", value)
        imgs = tbatch.edit_batch(th, *_inputs(s, rec), TRANSFORMS[1:2])
        assert built[-1] == mode
        close(imgs, plain, f"DIFFHANDLES_BATCHED_REMAT={value} images", 1e-6)
    assert len(built) == 2
