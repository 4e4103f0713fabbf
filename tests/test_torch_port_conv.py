"""PyTorch port vs the JAX package: the 3x3 conv kernel (K7) and the
`pallas_conv=True` U-Net.

The port's plain versions of the JAX package's Pallas `_conv3_kernel`
(forward, and dx through the same kernel with the flipped, transposed
weight) and its plain dw, through the port's differentiable `conv3x3`,
against JAX `conv3x3` and its custom VJP run in Pallas interpret mode on
the CPU; the gate against JAX `conv3x3_ok`, over a grid of shapes and site
for site at 512x512; and a tiny U-Net with `UNetConfig(conv3x3_kernel=True)`
against the JAX U-Net with `pallas_conv=True` on the same weights. The CUDA
kernel is held to these plain versions in test_torch_port_kernels.py.

Tolerances, relative to the largest value compared: fp32 1e-5 for the op
(summation order only), 1e-4 for the U-Net's eps and 3e-4 for its
gradients (as test_torch_port_gn.py). bf16 2**-7: both sides round the same
fp32 tap sums once to bf16, so an output may differ by one bf16 ulp (2**-8
relative) where sums taken in another order straddle a rounding boundary.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu.ops import conv as jconv
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.ops import conv as tconv

DTYPES = {"fp32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


def _close(got, want, rtol, what=""):
    """max |got - want| <= rtol * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)


def _sd2_conv_sites():
    """((side, Ci, Co) of every Conv3x3 of the SD-2-depth U-Net at 64x64
    latents, the gate's routing of it)."""
    with torch.device("meta"):
        net = tunet.UNet2DConditionModel(tunet.UNetConfig(
            conv3x3_kernel=True))
    res = {"down_blocks": lambda i: 64 >> i, "mid_block": lambda i: 8,
           "up_blocks": lambda i: 8 << i}
    sites = []
    for name, mod in net.named_modules():
        if isinstance(mod, tunet.Conv3x3):
            parts = name.split(".")
            side = res[parts[0]](int(parts[1]) if parts[0] != "mid_block"
                                 else 0)
            side *= 2 if "upsamplers" in name else 1
            sites.append((side, mod.in_channels, mod.out_channels))
    return sites


def test_gate_matches_jax_at_sd2_sites():
    """All 44 resnet convs and the 3 upsampler convs pass the gate at
    512x512, over 16 distinct (side, Ci, Co), in both packages."""
    sites = _sd2_conv_sites()
    assert len(sites) == 47 and len(set(sites)) == 16
    for side, ci, co in sites:
        shapes = ((1, side, side, ci), (3, 3, ci, co))
        assert tconv.conv3x3_ok(*shapes) and jconv.conv3x3_ok(*shapes)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_gate_matches_jax_over_a_grid(dtype_bytes):
    """conv3x3_ok is the JAX gate: 3x3 only, 64 channels each way, output
    rows tile-aligned, both orientations inside the VMEM budget."""
    shapes = [((b, h, w, ci), (kh, 3, ci, co))
              for b in (1, 2) for h, w in ((64, 64), (8, 8), (3, 3), (6, 5),
                                           (128, 128), (256, 256), (1, 6))
              for ci, co in ((32, 64), (64, 64), (320, 1280), (2560, 1280),
                             (1280, 2560), (960, 320))
              for kh in (3, 1)]
    for x, w in shapes + [((1, 8, 8, 64), (3, 3, 64)),
                          ((1, 8, 8, 64), (3, 64, 64, 64))]:
        assert tconv.conv3x3_ok(x, w, dtype_bytes) == jconv.conv3x3_ok(
            x, w, dtype_bytes), (x, w)
    assert any(tconv.conv3x3_ok(x, w, dtype_bytes) for x, w in shapes)
    assert not all(tconv.conv3x3_ok(x, w, dtype_bytes)
                   for x, w in shapes if w[0] == 3)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,w,ci,co", [
    (1, 8, 8, 64, 64),
    (2, 8, 24, 64, 320),     # non-square, CFG batch, Co = 320
    (1, 6, 6, 128, 64),      # Ci > Co (a decoder concat conv)
])
def test_conv3x3_matches_jax_kernel(dtype, b, h, w, ci, co):
    """y, dx and dw of the port's conv3x3 (plain versions on the CPU)
    against JAX conv3x3 and its custom VJP (Pallas kernel, interpret
    mode)."""
    tdt, jdt, rtol = DTYPES[dtype]
    rng = np.random.RandomState(ci + co + b)
    x = (0.5 * rng.randn(b, h, w, ci)).astype(np.float32)
    wk = (0.05 * rng.randn(3, 3, ci, co)).astype(np.float32)
    dy = rng.randn(b, h, w, co).astype(np.float32)
    assert tconv.conv3x3_ok(x.shape, wk.shape) and jconv.conv3x3_ok(
        x.shape, wk.shape)
    with pltpu.force_tpu_interpret_mode():
        y_j, vjp = jax.vjp(jconv.conv3x3, jnp.asarray(x, jdt),
                           jnp.asarray(wk))
        dx_j, dw_j = vjp(jnp.asarray(dy, jdt))

    xt = torch.from_numpy(_nchw(x)).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(np.ascontiguousarray(
        wk.transpose(3, 2, 0, 1))).requires_grad_(True)
    y_t = tconv.conv3x3(xt, wt)
    assert y_t.dtype == tdt
    dx_t, dw_t = torch.autograd.grad(y_t, (xt, wt),
                                     torch.from_numpy(_nchw(dy)).to(tdt))
    assert dx_t.dtype == tdt and dw_t.dtype == torch.float32
    _close(y_t, _nchw(_np(y_j)), rtol, "y")
    _close(dx_t, _nchw(_np(dx_j)), rtol, "dx")
    _close(dw_t.permute(2, 3, 1, 0), dw_j, rtol, "dw")


def test_conv3x3_plain_versions_are_the_conv_and_its_gradients():
    """fp32: the plain forward is F.conv2d, the plain dx and dw are
    autograd's gradients of it, and dw is computed only when asked."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 48, 5, 7).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.randn(80, 48, 3, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 80, 5, 7).astype(np.float32))
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = torch.nn.functional.conv2d(xg, wg, padding=1)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    _close(tconv.conv3x3_fwd_ref(x, w), y, 1e-5, "y")
    _close(tconv.conv3x3_dx_ref(dy, w, x.dtype), dx, 1e-5, "dx")
    _close(tconv.conv3x3_dw(x, dy, w.dtype), dw, 1e-5, "dw")
    (dx_only,) = torch.autograd.grad(tconv.conv3x3(xg, w), xg, dy)
    _close(dx_only, dx, 1e-5, "dx without dw")


def _tiny_conv_config(lib, **kw):
    """A two-level tiny U-Net, widths >= 64 so its convs can take the
    kernel: its 6x6 level passes the gate, its 3x3 level does not
    (3 * (3 + 2) is not a multiple of 8)."""
    return lib.tiny_unet_config(
        sample_size=6, block_out_channels=(64, 128), num_heads=(2, 2),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), **kw)


def test_tiny_conv_unet_matches_jax_with_grads(monkeypatch):
    """UNetConfig(conv3x3_kernel=True) against the JAX U-Net with
    pallas_conv=True (Pallas convs in interpret mode), the JAX parameters
    loaded strictly: eps and the decoder activation agree to 1e-4, the
    gradients of an energy w.r.t. the latents and the context to 3e-4
    (fp32), and both routes of the gate are taken."""
    jcfg = _tiny_conv_config(junet, pallas_conv=True)
    model, params = junet.init_unet_params(jcfg, seed=5)
    port = tunet.UNet2DConditionModel(_tiny_conv_config(
        tunet, conv3x3_kernel=True)).eval()
    port.load_state_dict(tweights.unet_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 6, 5).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    wa = rng.randn(2, 6, 6, 64).astype(np.float32)
    t = np.array([11, 600])

    def energy(xj, cj):
        eps, acts, _ = model.apply(params, xj, jnp.asarray(t), cj)
        return jnp.sum(acts[-1] * wa) + jnp.sum(eps ** 2), (eps, acts)

    with pltpu.force_tpu_interpret_mode():  # jit: one compile, not eager
        (_, (eps_j, acts_j)), (gx_j, gc_j) = jax.jit(jax.value_and_grad(
            energy, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                                   jnp.asarray(ctx))

    routes = []
    real = tunet.conv3x3_ok
    monkeypatch.setattr(tunet, "conv3x3_ok",
                        lambda *a, **kw: (routes.append(real(*a, **kw)),
                                          routes[-1])[1])
    xt = torch.from_numpy(_nchw(x)).requires_grad_(True)
    ct = torch.from_numpy(ctx).requires_grad_(True)
    eps_t, acts_t, _ = port(xt, torch.from_numpy(t), ct)
    e = ((acts_t[-1] * torch.from_numpy(_nchw(wa))).sum()
         + (eps_t ** 2).sum())
    gx_t, gc_t = torch.autograd.grad(e, (xt, ct))
    assert set(routes) == {True, False}
    _close(eps_t, _nchw(_np(eps_j)), 1e-4, "eps")
    _close(acts_t[-1], _nchw(_np(acts_j[-1])), 1e-4, "activations")
    _close(gx_t, _nchw(_np(gx_j)), 3e-4, "d energy / d latents")
    _close(gc_t, gc_j, 3e-4, "d energy / d context")


def test_tiny_conv_unet_assign_load_holds_kernel_layout():
    """A conv U-Net built on the meta device and loaded with
    load_state_dict(assign=True), as chip_smoke.py swaps U-Nets, ends with
    every kernel conv's weight in the kernel's layout (channels-last,
    though the loaded tensors are not); its eps and decoder activation still equal the JAX U-Net with
    pallas_conv=True to 1e-4 (fp32)."""
    jcfg = _tiny_conv_config(junet, pallas_conv=True)
    model, params = junet.init_unet_params(jcfg, seed=5)
    state = tweights.unet_state_dict(jax.tree.map(np.asarray, params))
    with torch.device("meta"):
        port = tunet.UNet2DConditionModel(_tiny_conv_config(
            tunet, conv3x3_kernel=True))
    port.load_state_dict(state, strict=True, assign=True)
    port.eval()
    kernel = [m for m in port.modules()
              if isinstance(m, tunet.Conv3x3) and m.kernel]
    assert kernel and all(tconv.in_kernel_layout(m.weight) for m in kernel)
    assert not any(tconv.in_kernel_layout(state[k]) for k in state
                   if k.endswith("conv1.weight"))

    rng = np.random.RandomState(6)
    x = rng.randn(2, 6, 6, 5).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.array([11, 600])
    with pltpu.force_tpu_interpret_mode():
        eps_j, acts_j, _ = jax.jit(lambda a, c: model.apply(
            params, a, jnp.asarray(t), c))(jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        eps_t, acts_t, _ = port(torch.from_numpy(_nchw(x)),
                                torch.from_numpy(t), torch.from_numpy(ctx))
    _close(eps_t, _nchw(_np(eps_j)), 1e-4, "eps")
    _close(acts_t[-1], _nchw(_np(acts_j[-1])), 1e-4, "activations")


def test_conv_switch_excludes_fused_gn_conv():
    """conv3x3_kernel and fused_gn_conv are two values of the JAX
    package's one pallas_conv field."""
    with pytest.raises(ValueError, match="pallas_conv"):
        tunet.UNetConfig(conv3x3_kernel=True, fused_gn_conv=True)
    cfg = tunet.UNetConfig(conv3x3_kernel=True, fused_gn=True)
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, fused_gn_conv=True)


def test_smoke_site_counts_are_the_unets_convs():
    """chip_smoke.py weights each K7 site by how many of the U-Net's 47
    eligible convs have its shape: those counts are the U-Net's."""
    import collections

    import chip_smoke
    assert chip_smoke.CONV3_SITE_COUNTS == collections.Counter(
        _sd2_conv_sites())
    assert sum(chip_smoke.CONV3_SITE_COUNTS.values()) == \
        chip_smoke.CONV3_SITES
