"""The fp32 recipe of the general flash kernels, emulated on the CPU.

On the card the general flash kernels (csrc/flash_general.cu,
csrc/flash_general_bwd.cu) multiply fp32 operands on the tensor cores as
3xTF32: x = hi + lo, hi = tf32(x) and lo = tf32(x - hi), both rounded to
nearest with ties away from zero (`cvt.rna.tf32.f32`), each product as
lo.hi' + hi.lo' + hi.hi' summed in fp32. Here that split is emulated with
bit operations, the plain forward (K1) and backward (K2) are computed with
every product so, and the results are held to the JAX package's fp32 flash
kernels (Pallas interpret mode) within the fp32 tolerances of the general
routes' CUDA tests (tests/test_torch_port_kernels.py: O and gradients
2**-14 of the largest value, lse 2**-14). The same plain versions with one
TF32 pass a product miss those tolerances: the tolerance tells the recipe
apart from TF32.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.ops import attention as jatt
from diffusionhandles_tpu_torch.ops import attention as tatt

# As tests/test_torch_port_kernels.py (F32_RTOL, F32_LSE_ATOL), whose
# comment derives them.
F32_RTOL = 2.0 ** -14
F32_LSE_ATOL = 2.0 ** -14


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to tf32 (10 explicit significand bits), to nearest
    with ties away from zero: adding half of the dropped 13 bits' unit to
    the sign-magnitude bits carries into the kept ones exactly then."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a, b):
    """a @ b, every product as 3xTF32 summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a, b):
    """a @ b, every product as one TF32 pass."""
    return _tf32(a) @ _tf32(b)


def _fwd(q, k, v, mm):
    """K1's plain version (tatt.flash_fwd_ref) in fp32 with products `mm`."""
    qt, kt, vt = tatt._fwd_operands(q, k, v)
    s = mm(qt, kt.transpose(1, 2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return tatt._fwd_result(q, mm(p, vt), m, p.sum(dim=-1, keepdim=True))


def _bwd(q, k, v, o, lse, do, mm):
    """K2's plain version (tatt.flash_bwd_ref) in fp32 with products
    `mm`."""
    qt, kt, vt = tatt._fwd_operands(q, k, v)
    dot = tatt._heads_first(do)
    delta = tatt._delta(tatt._heads_first(o), dot)
    p = torch.exp(mm(qt, kt.transpose(1, 2)) - lse.unsqueeze(-1))
    dv = mm(p.transpose(1, 2), dot)
    ds = p * (mm(dot, vt.transpose(1, 2)) - delta)
    dq = mm(ds, kt) * (1.0 / math.sqrt(q.shape[-1]))
    return tatt._bwd_result(q, k, v, dq, mm(ds.transpose(1, 2), qt), dv)


def _case(d, seed):
    """Seeded fp32 q, k, v, dO [1, 512, 2, d] and the JAX package's fp32
    forward (o, lse) and backward (dq, dk, dv) on them, in interpret
    mode."""
    rng = np.random.RandomState(seed)
    q, k = (rng.randn(1, 512, 2, d).astype(np.float32) * 1.5
            for _ in range(2))
    v, do = (rng.randn(1, 512, 2, d).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        o, lse = jatt._flash_fwd_impl(*map(jnp.asarray, (q, k, v)))
        grads = jatt._flash_bwd_fused_impl(*map(jnp.asarray, (q, k, v)), o,
                                           lse, jnp.asarray(do))
    inputs = tuple(torch.from_numpy(x) for x in (q, k, v, do))
    want = (torch.from_numpy(np.array(o)),
            torch.from_numpy(np.array(lse)[..., 0]),
            *(torch.from_numpy(np.array(g)) for g in grads))
    return inputs, want


def _errors_over_tolerance(mm, d, seed):
    """max |err| / tolerance of o, lse, dq, dk, dv with products `mm`
    against JAX (the backward fed JAX's o and lse)."""
    (q, k, v, do), (o, lse, *grads) = _case(d, seed)
    o_got, lse_got = _fwd(q, k, v, mm)
    got = _bwd(q, k, v, o, lse, do, mm)
    ratios = [(o_got - o).abs().max().item()
              / (F32_RTOL * o.abs().max().item()),
              (lse_got - lse).abs().max().item() / F32_LSE_ATOL]
    ratios += [(g - w).abs().max().item() / (F32_RTOL * w.abs().max().item())
               for g, w in zip(got, grads)]
    return ratios


@pytest.mark.parametrize("d,seed", [(64, 0), (40, 1)])
def test_3xtf32_recipe_meets_the_fp32_tolerance(d, seed):
    """K1 and K2 with every product as 3xTF32 agree with the JAX package's
    fp32 kernels within the fp32 tolerances (o, lse, dq, dk, dv)."""
    ratios = _errors_over_tolerance(_mm3, d, seed)
    assert max(ratios) <= 1.0, dict(zip(("o", "lse", "dq", "dk", "dv"),
                                        ratios))


@pytest.mark.parametrize("d,seed", [(64, 0), (40, 1)])
def test_one_tf32_pass_misses_the_fp32_tolerance(d, seed):
    """The same with one TF32 pass a product misses the tolerances, in
    every output (o, lse, dq, dk, dv)."""
    ratios = _errors_over_tolerance(_mm1, d, seed)
    assert min(ratios) > 1.0, dict(zip(("o", "lse", "dq", "dk", "dv"),
                                       ratios))


def test_tf32_rounding_is_to_nearest_ties_away():
    """The emulated cvt.rna: tf32 values stay; a tie (half of the last kept
    bit) rounds away from zero in both signs; below a tie rounds down."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp / 2, -(1.0 + ulp / 2),
                      1.0 + ulp / 2 - 2.0 ** -23, 3.0 * 2.0 ** -130],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp), 1.0,
                         3.0 * 2.0 ** -130], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)
    lo = _tf32(x - _tf32(x))
    assert torch.equal(_tf32(lo), lo)
