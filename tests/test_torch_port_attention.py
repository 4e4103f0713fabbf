"""PyTorch port vs the JAX package: attention.

The port's plain flash versions and its autograd.Function (the CPU path)
against the JAX flash kernels run in Pallas interpret mode, the routing
gate against the JAX gate. The CUDA kernels themselves are held to these
plain versions in test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.ops import attention as jatt
from diffusionhandles_tpu_torch.ops import attention as tatt


def _qkv(s, h=2, d=64, b=1, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("s", [512, 1024])
def test_flash_fwd_ref_matches_jax_kernel_fp32(s):
    """fp32: the plain forward equals the JAX one-pass fold kernel up to
    summation order (rtol 2e-4, as the JAX package's own flash test)."""
    q, k, v = _qkv(s)
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jatt._flash_fwd_impl(*map(jnp.asarray, (q, k, v)))
    o, lse = tatt.flash_fwd_ref(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("s", [512, 1024])
def test_flash_fwd_ref_matches_jax_kernel_bf16(s):
    """bf16: same rounding points (q pre-scale, bf16 p summed and
    multiplied); O may differ by one bf16 ulp (2**-8 relative) from
    accumulation order, so atol 2**-8 * max|O| + 1e-6; lse to 1e-4."""
    q, k, v = _qkv(s, seed=1)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jatt._flash_fwd_impl(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = tatt.flash_fwd_ref(tq, tk, tv)
    want_o = np.asarray(want_o, np.float32)
    atol = 2.0 ** -8 * np.abs(want_o).max() + 1e-6
    np.testing.assert_allclose(o.float().numpy(), want_o, rtol=0, atol=atol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("s", [512, 1024])
def test_flash_autograd_matches_jax_vjp_fp32(s):
    """Gradients of sum(attention(q, k, v) * w) through the port's
    FlashAttention (plain versions on the CPU) and the JAX custom VJP
    (fused backward kernel, interpret mode): rtol 2e-4."""
    q, k, v = _qkv(s, seed=2)
    w = np.random.RandomState(3).randn(*q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jatt.flash_attention_diff(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jloss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tatt.flash_attention_diff(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    for got, exp, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        exp = np.asarray(exp)
        np.testing.assert_allclose(got.numpy(), exp, rtol=2e-4,
                                   atol=2e-4 * np.abs(exp).max(),
                                   err_msg=f"d{name}")


def test_flash_bwd_ref_matches_jax_kernel_bf16():
    """bf16 backward at the U-Net's 1024-token level: same rounding
    points (bf16 p for dv, bf16 ds for dq/dk, fp32 dq sum); gradients may
    differ by a bf16 ulp of single terms, so atol 2**-7 * max|grad|."""
    q, k, v = _qkv(1024, h=1, seed=4)
    do = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o, lse = jatt._flash_fwd_impl(jq, jk, jv)
        want = jatt._flash_bwd_fused_impl(jq, jk, jv, o, lse, jdo)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    o_t = torch.from_numpy(np.asarray(o, np.float32)).to(torch.bfloat16)
    lse_t = torch.from_numpy(np.asarray(lse)[..., 0].copy())
    got = tatt.flash_bwd_ref(t[0], t[1], t[2], o_t, lse_t, t[3])
    for g, w, name in zip(got, want, "qkv"):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2.0 ** -7 * np.abs(w).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("s", [77, 256, 512, 1024, 1280, 4096])
def test_gate_matches_jax(s):
    for sk in (s, 77):
        for d in (64, 40):
            assert tatt.flash_ok(s, sk, head_dim=d) == jatt._flash_ok(
                s, sk, head_dim=d)


@pytest.mark.parametrize("s", [77, 256, 1024])
def test_dot_product_attention_matches_jax(s):
    """Dense path (and the flash route where the gate takes it), with
    probability capture, fp32: rtol 1e-5."""
    q, k, v = _qkv(s, seed=6)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want, want_p = jatt.dot_product_attention(jq, jk, jv, return_probs=True)
    got, got_p = tatt.dot_product_attention(tq, tk, tv, return_probs=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-7)
    got_f = tatt.dot_product_attention(tq, tk, tv, use_flash=True)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
