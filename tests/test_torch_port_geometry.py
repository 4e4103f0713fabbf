"""PyTorch port vs the JAX package: resize, morphology, Poisson solves,
the z-buffer splat, the pc-mode depth transform, correspondence binning
and the guidance losses. fp32 throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusionhandles_tpu import guidance as jguid
from diffusionhandles_tpu.geometry import depth as jdepth
from diffusionhandles_tpu.geometry import transform as jtrans
from diffusionhandles_tpu.ops import morphology as jmorph
from diffusionhandles_tpu.ops import poisson as jpois
from diffusionhandles_tpu.ops import resize as jresize
from diffusionhandles_tpu_torch import guidance as tguid
from diffusionhandles_tpu_torch.diffuser import GuidedStableDiffuser
from diffusionhandles_tpu_torch.geometry import depth as tdepth
from diffusionhandles_tpu_torch.geometry import transform as ttrans
from diffusionhandles_tpu_torch.ops import morphology as tmorph
from diffusionhandles_tpu_torch.ops import poisson as tpois
from diffusionhandles_tpu_torch.ops import resize as tresize

INTR = GuidedStableDiffuser.get_depth_intrinsics()


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(64, 64), (24, 40), (128, 96)])
def test_resize_matches_jax_and_interpolate(method, size):
    x = np.random.RandomState(0).randn(2, 3, 48, 48).astype(np.float32)
    got = tresize.resize_hw(_t(x), size, method)
    want = jresize.resize_hw(jnp.asarray(x), size, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ref = torch.nn.functional.interpolate(_t(x), size=size, mode=method,
                                          align_corners=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 7, 10, 12])
def test_ellipse_kernel_matches_cv2(ksize):
    cv2 = pytest.importorskip("cv2")
    want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize))
    np.testing.assert_array_equal(tmorph.ellipse_kernel(ksize), want)


@pytest.mark.parametrize("ksize", [2, 3, 4, 5, 10])
def test_morphology_matches_jax(ksize):
    """cv2 semantics incl. even-kernel anchors, exact (binary)."""
    mask = np.random.RandomState(ksize).rand(40, 40) > 0.6
    se = tmorph.ellipse_kernel(ksize)
    for tf, jf in [(tmorph.dilate, jmorph.dilate),
                   (tmorph.erode, jmorph.erode),
                   (tmorph.close, jmorph.close),
                   (tmorph.open_, jmorph.open_)]:
        np.testing.assert_array_equal(tf(_t(mask), se).numpy(),
                                      np.asarray(jf(jnp.asarray(mask), se)))
    np.testing.assert_array_equal(
        tmorph.binary_dilation_iter(_t(mask), 3).numpy(),
        np.asarray(jmorph.binary_dilation_iter(jnp.asarray(mask), 3)))


def test_harmonize_depth_matches_jax():
    """Masked CG with the same stopping rule: 1e-5 of the depth scale."""
    res = 64
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    bg = (2.0 + 0.01 * yy + 0.005 * xx).astype(np.float32)
    fg = (yy > 20) & (yy < 40) & (xx > 18) & (xx < 44)
    depth = bg.copy()
    depth[fg] -= 0.4
    got = tpois.harmonize_depth(_t(depth), _t(bg), _t(fg))
    want = jpois.harmonize_depth(depth, bg, fg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_splat_matches_jax_and_first_point_wins_ties():
    rng = np.random.RandomState(0)
    n = 500
    pts = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                    rng.choice([2.0, 2.5, 3.0], n)], -1).astype(np.float32)
    # a constructed tie: points 100 and 7 land on one pixel at one z
    pts[100] = pts[7]
    mask = rng.rand(n) > 0.5
    mask[7], mask[100] = False, True
    valid = rng.rand(n) > 0.1
    valid[7] = valid[100] = True
    got = tdepth.points_to_depth(_t(pts), _t(INTR), (32, 32),
                                 point_mask=_t(mask), valid=_t(valid))
    want = jdepth.points_to_depth(pts, INTR, (32, 32), point_mask=mask,
                                  valid=valid)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    pix = got.v[7] * 32 + got.u[7]
    assert got.winner.reshape(-1)[pix] <= 7  # 100 never beats 7
    assert not got.visible[100]


def test_normalize_and_lift_match_jax():
    d = np.random.RandomState(1).uniform(1, 3, (1, 1, 16, 24)).astype(
        np.float32)
    np.testing.assert_allclose(tdepth.normalize_depth(_t(d)).numpy(),
                               np.asarray(jdepth.normalize_depth(d)),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(
        tdepth.depth_to_world_coords(_t(d), _t(INTR)).numpy(),
        np.asarray(jdepth.depth_to_world_coords(d, INTR)), rtol=1e-6,
        atol=1e-6)


def _scene(res=64):
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    bg = (2.0 + 0.01 * yy).astype(np.float32)
    fg = ((yy >= res // 3) & (yy < 2 * res // 3)
          & (xx >= res // 3) & (xx < 2 * res // 3))
    depth = bg.copy()
    depth[fg] -= 0.4
    return (depth[None, None], bg[None, None],
            fg.astype(np.float32)[None, None])


def _pc_close(got, want):
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=0, err_msg=name)


@pytest.mark.parametrize("res,angle,axis,trans,erosion", [
    (64, 20.0, [0.0, 1.0, 0.0], [0.0, 0.0, 0.1], 0),
    (64, -35.0, [1.0, 0.3, 0.0], [0.05, -0.02, 0.0], 1),
    # 128 // 50 = 2: the mask close uses cv2's even 2x2 ellipse
    (128, 25.0, [0.0, 1.0, 0.0], [0.0, 0.0, 0.1], 0),
])
def test_transform_depth_pc_processed_matches_jax(res, angle, axis, trans,
                                                  erosion):
    """Disparity to 1e-5 of its 0..255 scale; the binned correspondences
    and background masks exactly."""
    depth, bg, fg = _scene(res)
    kw = dict(rot_angle=angle, rot_axis=np.array(axis),
              translation=np.array(trans), bg_erosion=erosion,
              max_corr=512, latent_res=16)
    got_d, got_pc = ttrans.transform_depth_pc_processed(
        depth, bg, fg, INTR, device="cpu", **kw)
    want_d, want_pc = jtrans.transform_depth_pc_processed(
        depth, bg, fg, INTR, **kw)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=0,
                               atol=1e-5 * 255)
    _pc_close(got_pc, want_pc)
    assert float(got_pc.corr_w.sum()) > 0


def test_transform_empty_foreground_matches_jax():
    depth, bg, fg = _scene()
    kw = dict(rot_angle=10.0, bg_erosion=1, max_corr=64, latent_res=16)
    got_d, got_pc = ttrans.transform_depth_pc_processed(
        depth, bg, fg * 0, INTR, device="cpu", **kw)
    want_d, want_pc = jtrans.transform_depth_pc_processed(
        depth, bg, fg * 0, INTR, **kw)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6,
                               atol=1e-4)
    _pc_close(got_pc, want_pc)


@pytest.fixture(scope="module")
def guidance_case():
    depth, bg, fg = _scene(64)
    kw = dict(rot_angle=15.0, rot_axis=np.array([0.0, 1.0, 0.0]),
              translation=np.array([0.0, 0.0, 0.1]), max_corr=1024,
              latent_res=32)
    _, tpc = ttrans.transform_depth_pc_processed(depth, bg, fg, INTR,
                                                 device="cpu", **kw)
    _, jpc = jtrans.transform_depth_pc_processed(depth, bg, fg, INTR, **kw)
    rng = np.random.RandomState(3)
    orig = rng.randn(8, 16, 16).astype(np.float32)  # [C, H, W]
    cur = rng.randn(8, 16, 16).astype(np.float32)
    return tpc, jpc, orig, cur


@pytest.mark.parametrize("patch", [1, 2, 3])
@pytest.mark.parametrize("loss_type", ["global_avg", "local_avg"])
def test_guidance_losses_and_grads_match_jax(guidance_case, patch,
                                             loss_type):
    """fg and bg energies (values and gradients w.r.t. the current
    activations): 1e-5 relative."""
    tpc, jpc, orig, cur = guidance_case
    size = (32, 32)
    hwc = lambda a: jnp.asarray(np.moveaxis(a, 0, -1))

    def jloss(c):
        fg = jguid.foreground_loss_apply(
            jguid.foreground_orig_precompute(hwc(orig), jpc, patch, size),
            c, jpc, patch, size)
        bg = jguid.background_loss_apply(
            jguid.background_orig_precompute(hwc(orig), jpc, patch, size,
                                             loss_type),
            c, jpc, patch, size, loss_type)
        return fg, bg

    jfg, jbg = jloss(hwc(cur))
    jgrad = jax.grad(lambda c: sum(jloss(c)))(hwc(cur))
    ct = _t(cur).requires_grad_(True)
    tfg = tguid.foreground_loss_apply(
        tguid.foreground_orig_precompute(_t(orig), tpc, patch, size),
        ct, tpc, patch, size)
    tbg = tguid.background_loss_apply(
        tguid.background_orig_precompute(_t(orig), tpc, patch, size,
                                         loss_type),
        ct, tpc, patch, size, loss_type)
    (tgrad,) = torch.autograd.grad(tfg + tbg, ct)
    np.testing.assert_allclose(float(tfg.detach()), float(jfg), rtol=1e-5)
    np.testing.assert_allclose(float(tbg.detach()), float(jbg), rtol=1e-5)
    jgrad = np.moveaxis(np.asarray(jgrad), -1, 0)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=0,
                               atol=1e-5 * np.abs(jgrad).max())


@pytest.mark.parametrize("schedule", ["constant", "linear", "quadratic"])
@pytest.mark.parametrize("optsteps", [3, 5])
def test_weight_schedule_matches_jax(schedule, optsteps):
    args = (1.5, 1.25, 38, 50, optsteps, schedule)
    for got, want in zip(tguid.build_guidance_weight_schedule(*args),
                         jguid.build_guidance_weight_schedule(*args)):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("method", ["bilinear", "bilinear_ac", "bicubic"])
def test_resize_nhwc_nchw_match_jax_and_interpolate(method):
    """resize_nhwc / resize_nchw, including the align-corners bilinear the
    ZoeDepth neck upsamples with, against the JAX functions and
    F.interpolate (align_corners=True for 'bilinear_ac')."""
    x = np.random.RandomState(2).randn(2, 12, 20, 3).astype(np.float32)
    for size in ((24, 40), (7, 9)):
        got = tresize.resize_nhwc(_t(x), size, method)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jresize.resize_nhwc(jnp.asarray(x),
                                                        size, method)),
            rtol=1e-5, atol=1e-5)
        nchw = np.moveaxis(x, -1, 1)
        got_nchw = tresize.resize_nchw(_t(nchw), size, method)
        np.testing.assert_array_equal(got_nchw.numpy(),
                                      np.moveaxis(got.numpy(), -1, 1))
        ref = torch.nn.functional.interpolate(
            _t(nchw), size=size, mode=method.replace("_ac", ""),
            align_corners=method == "bilinear_ac")
        np.testing.assert_allclose(got_nchw.numpy(), ref.numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_erosion_and_laplacian_solve_match_jax():
    """binary_erosion_iter (scipy semantics, border 0) bitwise, and
    solve_laplacian_depth within harmonize_depth's 1e-5 of the scale."""
    mask = np.random.RandomState(3).rand(40, 40) > 0.3
    for n in (0, 1, 3):
        np.testing.assert_array_equal(
            tmorph.binary_erosion_iter(_t(mask), n).numpy(),
            np.asarray(jmorph.binary_erosion_iter(jnp.asarray(mask), n)))
    res = 48
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    bg = (2.0 + 0.01 * yy + 0.005 * xx).astype(np.float32)
    hole = (yy > 15) & (yy < 30) & (xx > 12) & (xx < 35)
    depth = bg.copy()
    depth[hole] -= 0.4
    got = tpois.solve_laplacian_depth(_t(depth), _t(bg), _t(hole))
    want = jpois.solve_laplacian_depth(depth, bg, hole)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_lift_project_roundtrip_with_extrinsics():
    """points_to_depth applies the inverse of depth_to_world_coords'
    extrinsics (cam = R @ world + t), so a camera re-projects its own
    lifted points onto its grid (the JAX package's test of the same name);
    the splat equals the JAX package's."""
    from scipy.spatial.transform import Rotation

    res = 32
    rng = np.random.RandomState(1)
    depth = (2.0 + rng.rand(res, res)).astype(np.float32)
    R = Rotation.from_rotvec([0.0, np.deg2rad(10.0), 0.0]).as_matrix()
    t = np.array([0.05, -0.02, 0.3], np.float32)
    pts = tdepth.depth_to_world_coords(_t(depth[None, None]), INTR,
                                       extrinsics_R=R, extrinsics_t=t)
    splat = tdepth.points_to_depth(pts.reshape(-1, 3), INTR, (res, res),
                                   extrinsics_R=R, extrinsics_t=t)
    got = splat.depth_map.numpy()
    finite = np.isfinite(got)
    assert finite.mean() > 0.95
    np.testing.assert_allclose(got[finite], depth[finite], atol=2e-3)
    want = jdepth.points_to_depth(pts.reshape(-1, 3).numpy(), INTR,
                                  (res, res), extrinsics_R=R,
                                  extrinsics_t=t)
    np.testing.assert_array_equal(np.isfinite(np.asarray(want.depth_map)),
                                  finite)
    np.testing.assert_allclose(got[finite],
                               np.asarray(want.depth_map)[finite],
                               rtol=1e-5, atol=0)
