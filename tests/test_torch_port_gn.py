"""The fused GroupNorm slice of the port against the JAX package.

The port's plain versions of its GroupNorm(+SiLU) kernel (K8,
ops/groupnorm.py) and fused GroupNorm+SiLU+conv3x3 kernels (K9,
ops/gn_conv.py) against the JAX package's Pallas kernels run in interpret
mode on the CPU (as tests/test_groupnorm.py and tests/test_gn_conv.py run
them); both routing gates against the JAX gates at every 512x512 site; the
tiny U-Net with both fused switches against the JAX U-Net built with
pallas_conv='fused', pallas_gn=True on the same weights; and a short edit
(recording pass + guided denoising) through that U-Net in both packages.

Tolerances, relative to the largest value compared: fp32 1e-5 for the ops
(summation order only), 1e-4 for the U-Net's outputs (a few dozen ops deep)
and 3e-4 for its gradients: the JAX side's CPU compile evaluates exp and erf
with its own approximations and fuses differently from one compile to the
next, and the two packages' gradients have been seen 1.05e-4 apart when the
suite ran under parallel workers, 1.9e-4 with fused_gn_conv alone. bf16
2**-7 for the ops: both sides round the same fp32 values once to bf16, so
an output may differ by one bf16 ulp (2**-8 relative)
where the fp32 sums, taken in another order, straddle a rounding boundary;
two ulps of the largest value bound that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.config import GuidedDiffuserConfig as JGConfig
from diffusionhandles_tpu.diffuser import GuidedStableDiffuser as JDiffuser
from diffusionhandles_tpu.diffuser import create_sd_models as jcreate
from diffusionhandles_tpu.geometry import transform as jtrans
from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu.ops import gn_conv as jgc
from diffusionhandles_tpu.ops import groupnorm as jgn
from diffusionhandles_tpu_torch.config import GuidedDiffuserConfig as TGConfig
from diffusionhandles_tpu_torch.diffuser import \
    GuidedStableDiffuser as TDiffuser
from diffusionhandles_tpu_torch.diffuser import create_sd_models as tcreate
from diffusionhandles_tpu_torch.geometry import transform as ttrans
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.ops import gn_conv as tgc
from diffusionhandles_tpu_torch.ops import groupnorm as tgn

BF16_RTOL = 2.0 ** -7
DTYPES = {"fp32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_RTOL)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


def _close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def _gn_inputs(rng, b, h, w, c):
    x = rng.randn(b, h, w, c).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    beta = (0.1 * rng.randn(c)).astype(np.float32)
    return x, gamma, beta


# ---------------------------------------------------------------------------
# K8: GroupNorm(+SiLU)
# ---------------------------------------------------------------------------

LAYOUTS = {"nchw": torch.contiguous_format,
           "channels_last": torch.channels_last}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,hw,c,groups,act,eps", [
    (1, 8, 64, 8, True, 1e-5),
    (2, 8, 320, 32, False, 1e-6),   # SD-2 widths: group width 10
    (1, 4, 96, 32, True, 1e-5),     # group width 3
])
def test_gn_silu_matches_jax_kernel(dtype, b, hw, c, groups, act, eps,
                                    layout):
    """y, dx, dgamma and dbeta of the port's plain K8 against the JAX
    Pallas kernel (interpret mode), on NCHW and on channels-last x (the
    fused U-Net's layout); y and dx keep x's memory format."""
    tdt, jdt, rtol = DTYPES[dtype]
    fmt = LAYOUTS[layout]
    rng = np.random.RandomState(c + b)
    x, gamma, beta = _gn_inputs(rng, b, hw, hw, c)
    dy = rng.randn(*x.shape).astype(np.float32)
    assert tgn.gn_ok(x.shape, groups) and jgn.gn_ok(x.shape, groups)

    def f(x_, g_, b_):
        return jgn.gn_silu(x_, g_, b_, groups, eps, act, jdt)

    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(gamma),
                           jnp.asarray(beta))
        dx_j, dg_j, db_j = vjp(jnp.asarray(dy, jdt))

    xt = torch.from_numpy(_nchw(x)).to(tdt).contiguous(
        memory_format=fmt).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    y_t = tgn.gn_silu(xt, gt, bt, groups, eps, act, tdt)
    assert y_t.dtype == tdt and y_t.is_contiguous(memory_format=fmt)
    dx_t, dg_t, db_t = torch.autograd.grad(
        y_t, (xt, gt, bt),
        torch.from_numpy(_nchw(dy)).to(tdt).contiguous(memory_format=fmt))
    assert dx_t.is_contiguous(memory_format=fmt)
    _close(y_t, _nchw(_np(y_j)), rtol, "y")
    _close(dx_t, _nchw(_np(dx_j)), rtol, "dx")
    _close(dg_t, dg_j, rtol, "dgamma")
    _close(db_t, db_j, rtol, "dbeta")


def test_gn_silu_plain_versions_match_autograd_fp32():
    """The plain backward (with its u, v sums) is the gradient of the plain
    forward: autograd through gn_silu_fwd_ref, fp32."""
    rng = np.random.RandomState(5)
    x, gamma, beta = _gn_inputs(rng, 2, 4, 4, 64)
    xt = torch.from_numpy(_nchw(x)).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    y, mean, rsig = tgn.gn_silu_fwd_ref(xt, gt, bt, 16, 1e-5, True,
                                        torch.float32)
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    want = torch.autograd.grad(y, (xt, gt, bt), dy)
    dx, u, v = tgn.gn_silu_bwd_ref(xt.detach(), dy, gt.detach(), bt.detach(),
                                   mean.detach(), rsig.detach(), 16, True)
    for got, w_, what in zip((dx, v.sum(0), u.sum(0)), want,
                             ("dx", "dgamma", "dbeta")):
        _close(got, w_, 1e-5, what)


# ---------------------------------------------------------------------------
# K9: GroupNorm + SiLU + conv3x3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,ci,co,groups", [
    (1, 8, 64, 64, 8),
    (2, 8, 128, 64, 32),     # channel reduction, CFG batch
    (1, 6, 64, 256, 8),      # the TPU kernel's Co tiling, 6x6 image
    (1, 8, 96, 64, 32),      # group width 3
])
def test_gn_silu_conv3x3_matches_jax_kernel(dtype, b, h, ci, co, groups):
    """y, dx and the parameter gradients of the port's plain K9 against the
    JAX Pallas kernels (interpret mode)."""
    tdt, jdt, rtol = DTYPES[dtype]
    rng = np.random.RandomState(ci + co + b)
    x, gamma, beta = _gn_inputs(rng, b, h, h, ci)
    wk = (0.05 * rng.randn(3, 3, ci, co)).astype(np.float32)
    dy = rng.randn(b, h, h, co).astype(np.float32)
    assert tgc.gn_silu_conv3x3_ok(x.shape, wk.shape, groups)
    assert jgc.gn_silu_conv3x3_ok(x.shape, wk.shape, groups)

    def f(x_, g_, b_, w_):
        return jgc.gn_silu_conv3x3(x_, g_, b_, w_, groups, 1e-5)

    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(gamma),
                           jnp.asarray(beta), jnp.asarray(wk))
        dx_j, dg_j, db_j, dw_j = vjp(jnp.asarray(dy, jdt))

    xt = torch.from_numpy(_nchw(x)).to(tdt).requires_grad_(True)
    gt = torch.from_numpy(gamma).requires_grad_(True)
    bt = torch.from_numpy(beta).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(
        wk.transpose(3, 2, 0, 1))).requires_grad_(True)
    y_t = tgc.gn_silu_conv3x3(xt, gt, bt, wt, groups, 1e-5)
    assert y_t.dtype == tdt
    dx_t, dg_t, db_t, dw_t = torch.autograd.grad(
        y_t, (xt, gt, bt, wt), torch.from_numpy(_nchw(dy)).to(tdt))
    _close(y_t, _nchw(_np(y_j)), rtol, "y")
    _close(dx_t, _nchw(_np(dx_j)), rtol, "dx")
    _close(dg_t, dg_j, rtol, "dgamma")
    _close(db_t, db_j, rtol, "dbeta")
    _close(dw_t.permute(2, 3, 1, 0), dw_j, rtol, "dw")


def test_gn_silu_conv3x3_plain_dx_matches_autograd_fp32():
    """The plain dx is the input gradient of the plain forward, and the
    unfused composition computes the same function (fp32)."""
    rng = np.random.RandomState(7)
    x, gamma, beta = _gn_inputs(rng, 2, 6, 6, 64)
    wk = torch.from_numpy((0.05 * rng.randn(32, 64, 3, 3)).astype(np.float32))
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    xt = torch.from_numpy(_nchw(x)).requires_grad_(True)
    y, mean, rsig = tgc.gn_silu_conv3x3_fwd_ref(xt, gt, bt, wk, 8, 1e-5)
    _close(y, tgc.gn_silu_conv3x3_ref(xt, gt, bt, wk, 8, 1e-5), 1e-5, "y")
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    (want,) = torch.autograd.grad(y, xt, dy)
    got = tgc.gn_silu_conv3x3_dx_ref(xt.detach(), gt, bt, wk, mean.detach(),
                                     rsig.detach(), dy, 8)
    _close(got, want, 1e-5, "dx")


# ---------------------------------------------------------------------------
# The gates at the 512x512 SD-2-depth sites
# ---------------------------------------------------------------------------

def _sd2_sites():
    """(resnet halves as (x_shape, w_shape) and GroupNorm sites as x_shape,
    channels-last) of the SD-2-depth U-Net at 64x64 latents, batch 1."""
    with torch.device("meta"):
        net = tunet.UNet2DConditionModel(tunet.UNetConfig())
    res = {"down_blocks": lambda i: 64 >> i, "mid_block": lambda i: 8,
           "up_blocks": lambda i: 8 << i}
    halves, norms = [], []
    for name, mod in net.named_modules():
        if not isinstance(mod, (tunet.ResnetBlock2D,
                                tunet.Transformer2DModel)):
            continue
        parts = name.split(".")
        hw = res[parts[0]](int(parts[1]) if parts[0] != "mid_block" else 0)
        if isinstance(mod, tunet.ResnetBlock2D):
            ci, co = mod.norm1.num_channels, mod.conv1.out_channels
            halves.append(((1, hw, hw, ci), (3, 3, ci, co)))
            halves.append(((1, hw, hw, co), (3, 3, co, co)))
        elif isinstance(mod, tunet.Transformer2DModel):
            norms.append((1, hw, hw, mod.norm.num_channels))
    norms.append((1, 64, 64, net.conv_norm_out.num_channels))
    return halves, norms


def test_gates_match_jax_at_sd2_sites():
    """Site for site, the port's gates route as the JAX package's: 34 of
    the 44 resnet halves and all 17 GroupNorm sites (16 transformer norms
    and conv_norm_out) take the kernels."""
    halves, norms = _sd2_sites()
    assert len(halves) == 44 and len(norms) == 17
    k9 = [tgc.gn_silu_conv3x3_ok(x, w, 32) for x, w in halves]
    assert k9 == [jgc.gn_silu_conv3x3_ok(x, w, 32) for x, w in halves]
    k8 = [tgn.gn_ok(x, 32) for x in norms]
    assert k8 == [jgn.gn_ok(x, 32) for x in norms]
    assert sum(k9) == 34 and all(k8)
    # the refused ones are decoder conv1 halves over the concat of trunk
    # and skip (Ci 640-2560 > Co), whose VMEM estimate passes 72 MB
    assert all(x[-1] > w[-1] for (x, w), ok in zip(halves, k9) if not ok)


# ---------------------------------------------------------------------------
# The tiny U-Net and a short edit with both switches on
# ---------------------------------------------------------------------------

def _record_gates(monkeypatch):
    """Wrap both gates as the port's U-Net calls them; return the list of
    (gate, passed) calls."""
    calls = []

    def wrap(name, fn):
        def gate(*args):
            ok = fn(*args)
            calls.append((name, ok))
            return ok
        return gate

    monkeypatch.setattr(tunet, "gn_silu_conv3x3_ok",
                        wrap("k9", tgc.gn_silu_conv3x3_ok))
    monkeypatch.setattr(tgn, "gn_ok", wrap("k8", tgn.gn_ok))
    return calls


@pytest.mark.parametrize("fused_gn_conv,fused_gn", [
    (True, True), (True, False), (False, True)])
def test_tiny_fused_unet_matches_jax_with_grads(monkeypatch, fused_gn_conv,
                                                fused_gn):
    """Each switch alone and both together, against the JAX U-Net with the
    matching pallas_conv / pallas_gn: eps and the decoder activations agree
    to 1e-4, the gradients of an energy w.r.t. the latents and the context
    to 3e-4 (fp32); both the kernel route and the fallback route of each
    switched-on gate are taken, and no other gate is asked."""
    jcfg = junet.tiny_unet_config(
        pallas_conv="fused" if fused_gn_conv else False, pallas_gn=fused_gn)
    model = junet.UNet2DCondition(jcfg)
    # one set of weights for every case (the parameter tree is the same)
    _, params = junet.init_unet_params(junet.tiny_unet_config(
        pallas_conv="fused", pallas_gn=True), seed=4)
    port = tunet.UNet2DConditionModel(tunet.tiny_unet_config(
        fused_gn_conv=fused_gn_conv, fused_gn=fused_gn)).eval()
    port.load_state_dict(tweights.unet_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 8, 8, 5).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    wa = rng.randn(2, 8, 8, 32).astype(np.float32)
    t = np.array([11, 600])

    def energy(xj, cj):
        eps, acts, _ = model.apply(params, xj, jnp.asarray(t), cj)
        return jnp.sum(acts[2] * wa) + jnp.sum(eps ** 2), (eps, acts)

    with pltpu.force_tpu_interpret_mode():  # jit: one compile, not eager
        (_, (eps_j, acts_j)), (gx_j, gc_j) = jax.jit(jax.value_and_grad(
            energy, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                                   jnp.asarray(ctx))

    calls = _record_gates(monkeypatch)
    xt = torch.from_numpy(_nchw(x)).requires_grad_(True)
    ct = torch.from_numpy(ctx).requires_grad_(True)
    eps_t, acts_t, _ = port(xt, torch.from_numpy(t), ct)
    e = ((acts_t[2] * torch.from_numpy(_nchw(wa))).sum()
         + (eps_t ** 2).sum())
    gx_t, gc_t = torch.autograd.grad(e, (xt, ct))
    gates = ["k9"] * fused_gn_conv + ["k8"] * fused_gn
    assert set(calls) == {(g, ok) for g in gates for ok in (True, False)}
    _close(eps_t, _nchw(_np(eps_j)), 1e-4, "eps")
    for k in range(3):
        _close(acts_t[k], _nchw(_np(acts_j[k])), 1e-4, f"activations[{k}]")
    _close(gx_t, _nchw(_np(gx_j)), 3e-4, "d energy / d latents")
    _close(gc_t, gc_j, 3e-4, "d energy / d context")


T = 3
GMS = 2
PROMPT = "a toy cube on a table"


def _scene(res):
    yy, xx = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    bg = (2.0 + 0.01 * yy).astype(np.float32)
    fg = ((yy >= res // 3) & (yy < 2 * res // 3)
          & (xx >= res // 3) & (xx < 2 * res // 3))
    depth = bg.copy()
    depth[fg] -= 0.4
    return (depth[None, None], bg[None, None],
            fg.astype(np.float32)[None, None])


def test_fused_edit_matches_jax():
    """The recording pass and the guided denoising (U-Net forward and
    backward each step) through the fused tiny U-Net, both packages on the
    same weights and inputs, fp32. Tolerances as
    tests/test_torch_port_pipeline.py: 1e-3 on latents and activations,
    5e-3 on the edited image."""
    kw = dict(num_timesteps=T, num_optsteps=2, guidance_max_step=GMS,
              dtype="float32", param_dtype="float32",
              activation_store_dtype="float32", flash_attention=False,
              pallas_conv=False, remat_guidance=False)
    jconf, tconf = JGConfig(**kw), TGConfig(**kw)
    jm = jcreate(conf=jconf, variant="tiny")
    rng = np.random.RandomState(42)
    small = lambda tree: jax.tree.map(
        lambda a: (rng.randn(*np.shape(a)) * 0.05).astype(np.float32), tree)
    jcfg = dataclasses.replace(jm.unet_config, pallas_conv="fused",
                               pallas_gn=True)
    jm = dataclasses.replace(jm, unet=junet.UNet2DCondition(jcfg),
                             unet_config=jcfg, unet_params=small(
                                 jm.unet_params),
                             vae_params=small(jm.vae_params),
                             text_params=small(jm.text_params))
    jd = JDiffuser(jconf, models=jm)

    tm = tcreate(conf=tconf, variant="tiny", device="cpu")
    tcfg = dataclasses.replace(tm.unet_config, fused_gn_conv=True,
                               fused_gn=True)
    tm = dataclasses.replace(tm, unet=tunet.UNet2DConditionModel(tcfg),
                             unet_config=tcfg)
    tm.unet.load_state_dict(tweights.unet_state_dict(jm.unet_params),
                            strict=True)
    tm.unet.eval().requires_grad_(False)
    tm.vae.load_state_dict(tweights.vae_state_dict(jm.vae_params),
                           strict=True)
    tm.text_encoder.load_state_dict(tweights.clip_state_dict(
        jm.text_params), strict=True)
    td = TDiffuser(tconf, models=tm, device="cpu")
    assert td.models.unet.config.fused_gn_conv

    res = jd.image_res
    depth, bg, fg = _scene(res)
    disparity = (1.0 / depth).astype(np.float32)
    lat0 = np.random.RandomState(3).randn(1, 4, jd.latent_res,
                                          jd.latent_res).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j_acts, j_lat, j_unc, _ = jd.initial_inference(
            jnp.asarray(np.moveaxis(lat0, 1, -1)), disparity, None, PROMPT)
    t_acts, t_lat, t_unc, _ = td.initial_inference(
        torch.from_numpy(lat0), disparity, None, PROMPT)
    _close(t_lat, _nchw(_np(j_lat)), 1e-3, "recon latents")
    for k in range(3):
        _close(t_acts[k], _nchw(_np(j_acts[k])), 1e-3, f"activations[{k}]")

    pkw = dict(rot_angle=10.0, rot_axis=np.array([0.0, 1.0, 0.0]),
               translation=np.array([0.0, 0.0, 0.0]), bg_erosion=0,
               max_corr=tconf.max_correspondences,
               latent_res=jd.latent_res)
    intr = jd.get_depth_intrinsics()
    j_disp, j_pc = jtrans.transform_depth_pc_processed(depth, bg, fg, intr,
                                                        **pkw)
    t_disp, t_pc = ttrans.transform_depth_pc_processed(depth, bg, fg, intr,
                                                        device="cpu", **pkw)
    with pltpu.force_tpu_interpret_mode():
        j_img = jd.guided_inference(
            latents=jnp.asarray(np.moveaxis(lat0, 1, -1)), depth=j_disp,
            uncond_embeddings=j_unc, prompt=PROMPT, activations_orig=j_acts,
            correspondences=None, processed_correspondences=j_pc)
    t_img = td.guided_inference(
        latents=torch.from_numpy(lat0), depth=t_disp,
        uncond_embeddings=t_unc, prompt=PROMPT, activations_orig=t_acts,
        processed_correspondences=t_pc)
    _close(t_img, _nchw(_np(j_img)), 5e-3, "edited image")
