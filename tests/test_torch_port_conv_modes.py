"""PyTorch port vs the JAX package: the hybrid and mixed 3x3 conv routes
and the U-Nets that take them.

`conv3x3_hybrid` (the library forward with the conv kernel's dx) and
`conv3x3_mixed` (the kernel's forward with a plain backward) against
torch.autograd of the plain conv, and the tiny U-Net with
`UNetConfig(conv3x3_kernel='hybrid' | 'mixed')` against the JAX U-Net with
`pallas_conv='hybrid' | 'mixed'` on the same weights, the JAX side's
Pallas kernels in interpret mode as tests/test_pallas_conv.py runs them on
the CPU.

Tolerances, relative to the largest value compared, fp32: 1e-5 (summation
order only), for the ops and for the U-Net's eps, activations and
gradient on small weights.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.ops import conv as tconv
from torch_port_rig import close

MODES = {"hybrid": tconv.conv3x3_hybrid, "mixed": tconv.conv3x3_mixed}


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_conv_route_grads_are_the_convs(mode):
    """fp32: y, dx and dw of the route against F.conv2d and its autograd
    gradients; dw is made only when asked for."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 64, 6, 10).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.randn(80, 64, 3, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 80, 6, 10).astype(np.float32))
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = F.conv2d(xg, wg, padding=1)
    dx, dw = torch.autograd.grad(y, (xg, wg), dy)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y_r = MODES[mode](xr, wr)
    dx_r, dw_r = torch.autograd.grad(y_r, (xr, wr), dy)
    close(y_r, y, "y", 1e-5)
    close(dx_r, dx, "dx", 1e-5)
    close(dw_r, dw, "dw", 1e-5)
    (dx_only,) = torch.autograd.grad(MODES[mode](xr, w), xr, dy)
    close(dx_only, dx, "dx without dw", 1e-5)
    with torch.no_grad():
        close(MODES[mode](x, w), y, "y without a graph", 1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_conv_route_bf16_rounds_once(mode):
    """bf16: the forward is the fp32 sum rounded once (conv3x3_fwd_ref),
    dx the kernel's dx (hybrid) or the fp32 sum of the flipped conv
    rounded once (mixed), both of which are conv3x3_dx_ref on the CPU;
    dw is fp32."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(1, 64, 8, 8).astype(np.float32)).to(
        torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy((0.05 * rng.randn(64, 64, 3, 3)).astype(
        np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.randn(1, 64, 8, 8).astype(np.float32)).to(
        torch.bfloat16)
    y = MODES[mode](x, w)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    ref = lambda a: a.detach()
    assert torch.equal(y, tconv.conv3x3_fwd_ref(ref(x), ref(w)))
    assert torch.equal(dx, tconv.conv3x3_dx_ref(dy, ref(w), torch.bfloat16))
    assert torch.equal(dw, tconv.conv3x3_dw(ref(x), dy, torch.float32))


def test_conv_mode_values():
    """conv3x3_kernel takes the JAX pallas_conv values that select a conv
    op; any of them excludes fused_gn_conv; a U-Net on any holds its
    kernel convs' weights channels-last."""
    for bad in ("taps", "fused", 2):
        with pytest.raises(ValueError, match="conv3x3_kernel"):
            tunet.tiny_unet_config(conv3x3_kernel=bad)
    for mode in MODES:
        with pytest.raises(ValueError, match="pallas_conv"):
            tunet.tiny_unet_config(conv3x3_kernel=mode, fused_gn_conv=True)
        net = tunet.UNet2DConditionModel(tunet.tiny_unet_config(
            conv3x3_kernel=mode))
        convs = [m for m in net.modules() if isinstance(m, tunet.Conv3x3)]
        assert convs and all(m.kernel == mode for m in convs)
        assert all(tconv.in_kernel_layout(m.weight) for m in convs)


@pytest.fixture(scope="module")
def small_params():
    """The rig's small weights (std 0.05) in the tiny JAX U-Net's
    parameter tree, made by shape (the tree is the same for every
    pallas_conv value), and the U-Net's inputs."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 8, 8, 5).astype(np.float32)
    ctx = rng.randn(1, 77, 32).astype(np.float32)
    t = np.array([600])
    shapes = jax.eval_shape(junet.UNet2DCondition(junet.tiny_unet_config()
                                                  ).init,
                            jax.random.PRNGKey(0), x, t, ctx)
    params = jax.tree.map(
        lambda s: (0.05 * rng.randn(*s.shape)).astype(np.float32), shapes)
    weights = [rng.randn(1, r, r, c).astype(np.float32)
               for r, c in ((4, 64), (8, 64), (8, 32))]
    return params, x, ctx, t, weights


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tiny_unet_conv_mode_matches_jax(mode, small_params, monkeypatch):
    """The tiny U-Net with conv3x3_kernel=mode against the JAX U-Net with
    pallas_conv=mode on the same small weights (the rig's std 0.05; at
    flax's init scale the network amplifies fp32 summation order 10x more,
    whichever conv runs), loaded strictly: eps, the three decoder
    activations and the latents' gradient of an energy over all of them
    to 1e-5 (fp32); the mode's op takes the convs the gate passes (the
    64-wide levels), F.conv2d the rest."""
    params, x, ctx, t, weights = small_params
    model = junet.UNet2DCondition(junet.tiny_unet_config(pallas_conv=mode))
    port = tunet.UNet2DConditionModel(tunet.tiny_unet_config(
        conv3x3_kernel=mode)).eval()
    port.load_state_dict(tweights.unet_state_dict(params), strict=True)

    def energy(xj, p, cj, wj):
        eps, acts, _ = model.apply(p, xj, jnp.asarray(t), cj)
        e = jnp.sum(eps ** 2) + sum(jnp.sum(a * w) for a, w in zip(acts, wj))
        return e, (eps, acts)

    with pltpu.force_tpu_interpret_mode():  # jit: one compile, not eager
        (_, (eps_j, acts_j)), gx_j = jax.jit(jax.value_and_grad(
            energy, has_aux=True))(x, params, ctx, weights)

    calls, routes = [], []
    real_op, real_gate = tunet.CONV3X3_MODES[mode], tunet.conv3x3_ok
    monkeypatch.setitem(tunet.CONV3X3_MODES, mode,
                        lambda *a: (calls.append(1), real_op(*a))[1])
    monkeypatch.setattr(tunet, "conv3x3_ok",
                        lambda *a, **kw: (routes.append(real_gate(*a, **kw)),
                                          routes[-1])[1])
    xt = torch.from_numpy(_nchw(x)).requires_grad_(True)
    eps_t, acts_t, _ = port(xt, torch.from_numpy(t), torch.from_numpy(ctx))
    e = (eps_t ** 2).sum() + sum((a * torch.from_numpy(_nchw(w))).sum()
                                 for a, w in zip(acts_t, weights))
    (gx_t,) = torch.autograd.grad(e, xt)
    assert set(routes) == {True, False} and len(calls) == sum(routes)
    close(eps_t, _nchw(eps_j), "eps", 1e-5)
    assert len(acts_t) == len(acts_j) == 3
    for i, (a_t, a_j) in enumerate(zip(acts_t, acts_j)):
        close(a_t, _nchw(a_j), f"activations {i}", 1e-5)
    close(gx_t, _nchw(gx_j), "d energy / d latents", 1e-5)
