"""PyTorch port vs the JAX package: the flash-attention alternates.

The port's plain versions of the JAX package's forward alternates K5
(`_flash_onepass_kernel`, `fold=False`) and K4 (`_flash_kernel`,
`block_k < sk`) and backward alternates K3 (two-pass, DIFFHANDLES_FLASH_BWD
=twopass) and K6 (delta-folded, =fold), reached through the port's
`flash_fwd_impl`, `flash_attention` and `flash_attention_diff`, against the
JAX kernels run in Pallas interpret mode on the CPU; the forward-only gate
against the JAX one; and a tiny U-Net's gradient under the two-pass
backward in both packages. The CUDA routes are held to these plain versions
in test_torch_port_kernels.py.

Tolerances. fp32: rtol 2e-4 (summation order; the JAX package's own flash
tests). bf16: the recipes are the JAX kernels' step for step, so an output
differs only where fp32 sums taken in another order straddle a bf16
rounding boundary: at most 1% of the elements (0.04-0.17% seen), each by at
most 2**-8 of the largest value (forward) or 2**-7 (gradients, whose terms
are rounded twice); lse, an fp32 sum, to 1e-5. A neighbouring recipe fails
these: K1's bf16 row sum moves lse by 6e-4-1e-3, K4's chunked max against
K5's global one changes 13-23% of O, and K3's second rounding of dq at head
dim 40 changes 26% of dq.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.models import unet as junet
from diffusionhandles_tpu.ops import attention as jatt
from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import weights as tweights
from diffusionhandles_tpu_torch.ops import attention as tatt

MISMATCH = 0.01


def _data(sq, sk, h=2, d=64, seed=0, scale=1.5):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, sq, h, d).astype(np.float32) * scale,
            rng.randn(1, sk, h, d).astype(np.float32) * scale,
            rng.randn(1, sk, h, d).astype(np.float32))


def _bf16(*xs):
    return ([jnp.asarray(x, jnp.bfloat16) for x in xs],
            [torch.from_numpy(x).to(torch.bfloat16) for x in xs])


def _close_bf16(got, want, rtol, what):
    """max |got - want| <= rtol * max |want|, on at most 1% of elements."""
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=what)
    frac = float((got != want).mean())
    assert frac <= MISMATCH, f"{what}: {frac:.4f} of the elements differ"


# (route name, JAX _flash_fwd_impl keyword arguments, port counterpart)
FWD_ROUTES = {
    "K5": (dict(fold=False), dict(fold=False)),
    "K4": (dict(block_k=256), dict(block_k=256)),
}


@pytest.mark.parametrize("sq,sk", [(512, 512), (256, 1024)])
@pytest.mark.parametrize("route", sorted(FWD_ROUTES))
def test_forward_alternates_match_jax_fp32(route, sq, sk):
    """fp32, K5 and K4 through flash_fwd_impl (sq != sk included): o and lse
    to rtol 2e-4."""
    jkw, tkw = FWD_ROUTES[route]
    q, k, v = _data(sq, sk, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jatt._flash_fwd_impl(*map(jnp.asarray, (q, k, v)),
                                                **jkw)
    o, lse = tatt.flash_fwd_impl(*map(torch.from_numpy, (q, k, v)), **tkw)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("sq,sk", [(512, 512), (256, 1024)])
@pytest.mark.parametrize("route", sorted(FWD_ROUTES))
def test_forward_alternates_match_jax_bf16(route, sq, sk):
    """bf16: o within 2**-8 of max|o| on at most 1% of elements, lse 1e-5;
    the route's own plain version is what runs."""
    jkw, tkw = FWD_ROUTES[route]
    q, k, v = _data(sq, sk, seed=2)
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jatt._flash_fwd_impl(jq, jk, jv, **jkw)
    o, lse = tatt.flash_fwd_impl(tq, tk, tv, **tkw)
    plain = {"K5": tatt.flash_fwd_unfolded_ref(tq, tk, tv),
             "K4": tatt.flash_fwd_stream_ref(tq, tk, tv, 256)}[route]
    assert torch.equal(o, plain[0]) and torch.equal(lse, plain[1])
    _close_bf16(o, want_o, 2.0 ** -8, "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=0, atol=1e-5)


def test_forward_recipes_are_told_apart_bf16():
    """The tolerances above see the recipe: K1's plain version misses JAX
    K5's lse, K5's plain version misses JAX K4's o."""
    q, k, v = _data(512, 512, seed=2)
    (jq, jk, jv), (tq, tk, tv) = _bf16(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        _, lse5 = jatt._flash_fwd_impl(jq, jk, jv, fold=False)
        o4, _ = jatt._flash_fwd_impl(jq, jk, jv, block_k=256)
    lse1 = tatt.flash_fwd_ref(tq, tk, tv)[1].numpy()
    assert np.abs(lse1 - np.asarray(lse5)[..., 0]).max() > 1e-4
    o5 = tatt.flash_fwd_unfolded_ref(tq, tk, tv)[0].float().numpy()
    assert (o5 != np.asarray(o4, np.float32)).mean() > 5 * MISMATCH


@pytest.mark.parametrize("d", [64, 40])
def test_twopass_backward_matches_jax_bf16(d):
    """K3 (bf16): dq, dk, dv within 2**-7 of their max on at most 1% of
    elements; at d = 40 its second rounding of dq is seen (K2's recipe
    misses)."""
    q, k, v = _data(1024, 1024, h=1, d=d, seed=4, scale=1.0)
    do = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    (jq, jk, jv, jdo), t = _bf16(q, k, v, do)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jatt._flash_fwd_impl(jq, jk, jv)
        want = jatt._flash_bwd_impl(jq, jk, jv, o, lse, jdo)
    o_t = torch.from_numpy(np.asarray(o, np.float32)).to(torch.bfloat16)
    lse_t = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    got = tatt.flash_bwd_twopass(t[0], t[1], t[2], o_t, lse_t, t[3])
    for g, w, name in zip(got, want, "qkv"):
        _close_bf16(g, w, 2.0 ** -7, f"d{name}")
    if d == 40:
        dq2 = tatt.flash_bwd_ref(t[0], t[1], t[2], o_t, lse_t, t[3])[0]
        assert (dq2.float().numpy() != np.asarray(want[0], np.float32)
                ).mean() > 5 * MISMATCH


@pytest.mark.parametrize("sq,sk", [(1024, 1024), (512, 1024)])
def test_fold_backward_matches_jax_bf16(sq, sk):
    """K6 (bf16, sq != sk included): gradients within 2**-7 of their max on
    at most 1% of elements, and the hi/lo split of -delta is JAX's bit for
    bit (the split is all that sets K6 apart from K2)."""
    q, k, v = _data(sq, sk, h=1, seed=6, scale=1.0)
    do = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    (jq, jk, jv, jdo), t = _bf16(q, k, v, do)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jatt._flash_fwd_impl(jq, jk, jv)
        want = jatt._flash_bwd_fused_fold_impl(jq, jk, jv, o, lse, jdo)
    o_t = torch.from_numpy(np.asarray(o, np.float32)).to(torch.bfloat16)
    lse_t = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    got = tatt.flash_bwd_fold(t[0], t[1], t[2], o_t, lse_t, t[3])
    for g, w, name in zip(got, want, "qkv"):
        _close_bf16(g, w, 2.0 ** -7, f"d{name}")
    # the JAX wrapper's delta and split (attention.py:435-439) against the
    # port's: delta to fp32 summation order, the split of one delta exactly
    delta_j = jnp.sum(jdo[:, :, 0].astype(jnp.float32)
                      * o[:, :, 0].astype(jnp.float32), axis=-1)
    delta_t = tatt._delta(tatt._heads_first(o_t), tatt._heads_first(t[3]))
    np.testing.assert_allclose(delta_t[..., 0].numpy(),
                               np.asarray(delta_j), rtol=1e-5, atol=1e-6)
    hi_j = (-delta_j).astype(jnp.bfloat16)
    lo_j = (-delta_j - hi_j.astype(jnp.float32)).astype(jnp.bfloat16)
    hi_t, lo_t = tatt._delta_hi_lo(torch.tensor(np.asarray(delta_j)),
                                   torch.bfloat16)
    assert np.array_equal(hi_t.float().numpy(), np.asarray(hi_j, np.float32))
    assert np.array_equal(lo_t.float().numpy(), np.asarray(lo_j, np.float32))


@pytest.mark.parametrize("mode", ["twopass", "fold", ""])
def test_backward_switch_matches_jax_vjp_fp32(monkeypatch, mode):
    """DIFFHANDLES_FLASH_BWD, read when the backward runs, picks the route
    in both packages; gradients of sum(attention * w) through the port's
    flash_attention_diff and the JAX custom VJP agree to rtol 2e-4 (fp32,
    sq != sk)."""
    q, k, v = _data(512, 1024, seed=8, scale=1.0)
    w = np.random.RandomState(9).randn(*q.shape).astype(np.float32)
    monkeypatch.setenv(tatt.BWD_ENV, mode)

    def jloss(q, k, v):
        return jnp.sum(jatt.flash_attention_diff(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ran = []
    for name in ("flash_bwd", "flash_bwd_twopass", "flash_bwd_fold"):
        fn = getattr(tatt, name)
        monkeypatch.setattr(tatt, name, lambda *a, _n=name, _f=fn: (
            ran.append(_n), _f(*a))[1])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (tatt.flash_attention_diff(tq, tk, tv) * torch.from_numpy(w)).sum(
    ).backward()
    assert ran == [{"twopass": "flash_bwd_twopass",
                    "fold": "flash_bwd_fold"}.get(mode, "flash_bwd")]
    for got, exp, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        exp = np.asarray(exp)
        np.testing.assert_allclose(got.numpy(), exp, rtol=2e-4,
                                   atol=2e-4 * np.abs(exp).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("sq,sk,block_q,block_k,d", [
    (4096, 4096, 2048, 1 << 20, 64), (1024, 1024, 2048, 1 << 20, 40),
    (256, 77, 2048, 1 << 20, 64), (1536, 1536, 2048, 1 << 20, 64),
    (1280, 2560, 2048, 1 << 20, 64), (512, 1024, 2048, 256, 64),
    (512, 1000, 2048, 256, 64), (65536, 65536, 2048, 1 << 20, 64),
    (16384, 16384, 2048, 1 << 20, 64), (1 << 18, 1 << 18, 2048, 1 << 20,
                                         64)])
def test_forward_only_gate_matches_jax(sq, sk, block_q, block_k, d):
    """The forward-only entry's gate and blocks are the JAX package's."""
    assert tatt._fwd_blocks(sq, sk, block_q, block_k) == jatt._fwd_blocks(
        sq, sk, block_q, block_k)
    assert tatt._flash_fwd_supported(
        sq, sk, block_q, block_k, d) == jatt._flash_fwd_supported(
            sq, sk, block_q, block_k, d)
    assert tatt._flash_supported(sq, sk, head_dim=d) == jatt._flash_supported(
        sq, sk, head_dim=d)


@pytest.mark.parametrize("sq,sk,block_k", [(1536, 1536, 1 << 20),
                                           (256, 1024, 256), (64, 60, 256)])
def test_forward_only_entry_matches_jax_fp32(monkeypatch, sq, sk, block_k):
    """flash_attention (forward only) against the JAX entry: 1536 tokens
    take the kernel here though the differentiable gate refuses them, a
    short block_k takes K4, 60 keys the dense path (fp32, rtol 2e-4)."""
    q, k, v = _data(sq, sk, h=1, seed=10, scale=1.0)
    with pltpu.force_tpu_interpret_mode():
        want = jatt.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    block_k=block_k)
    ran = []
    real = tatt.flash_fwd_impl
    monkeypatch.setattr(tatt, "flash_fwd_impl",
                        lambda *a, **kw: (ran.append(1), real(*a, **kw))[1])
    got = tatt.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               block_k=block_k)
    assert bool(ran) == (sk >= 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def _tiny_flash_config(lib, **kw):
    """A two-level tiny U-Net whose 32x32 level has 1024-token
    self-attentions (the flash route in both packages)."""
    return lib.tiny_unet_config(
        sample_size=32, flash_attention=True, block_out_channels=(32, 64),
        num_heads=(2, 2),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"), **kw)


def test_tiny_unet_twopass_gradient_matches_jax(monkeypatch):
    """Under DIFFHANDLES_FLASH_BWD=twopass in both packages, eps and the
    gradient of an activation energy w.r.t. the latents agree to 1e-4 of
    the largest value (fp32), and the port ran its two-pass route."""
    monkeypatch.setenv(tatt.BWD_ENV, "twopass")
    model, params = junet.init_unet_params(_tiny_flash_config(junet), seed=3)
    port = tunet.UNet2DConditionModel(_tiny_flash_config(tunet)).eval()
    port.load_state_dict(tweights.unet_state_dict(
        jax.tree.map(np.asarray, params)), strict=True)
    rng = np.random.RandomState(1)
    x = rng.randn(1, 32, 32, 5).astype(np.float32)
    ctx = rng.randn(1, 77, 32).astype(np.float32)
    w = rng.randn(1, 32, 32, 32).astype(np.float32)

    def energy(xj):
        eps, acts, _ = model.apply(params, xj, jnp.asarray(300),
                                   jnp.asarray(ctx))
        return jnp.sum(acts[-1] * w) + jnp.sum(eps ** 2), eps

    with pltpu.force_tpu_interpret_mode():  # jit: one compile, not eager
        (_, eps_j), grad_j = jax.jit(jax.value_and_grad(
            energy, has_aux=True))(jnp.asarray(x))
    ran = []
    real = tatt.flash_bwd_twopass
    monkeypatch.setattr(tatt, "flash_bwd_twopass",
                        lambda *a: (ran.append(1), real(*a))[1])
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_(True)
    eps_t, acts_t, _ = port(xt, torch.tensor(300), torch.from_numpy(ctx))
    e = ((acts_t[-1] * torch.from_numpy(np.moveaxis(w, -1, 1).copy())).sum()
         + (eps_t ** 2).sum())
    (grad_t,) = torch.autograd.grad(e, xt)
    assert len(ran) == 3  # the three 1024-token self-attentions
    for got, want, what in ((eps_t, eps_j, "eps"),
                            (grad_t, grad_j, "d energy / d latents")):
        want = np.moveaxis(np.asarray(want), -1, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=what)
