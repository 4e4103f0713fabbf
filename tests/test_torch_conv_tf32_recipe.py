"""The fp32 recipe of the general conv kernel, emulated on the CPU.

On the card the general 3x3 conv (csrc/conv_general.cu: K7's general
route, and K9's general instances through it) multiplies fp32 operands on
the tensor cores as 3xTF32: x = hi + lo, hi = tf32(x) and lo = tf32(x -
hi), both rounded to nearest with ties away from zero (`cvt.rna.tf32.f32`),
each product as lo.hi' + hi.lo' + hi.hi' summed in fp32. Here that split is
emulated with bit operations, the plain forward (`conv3x3_fwd_ref`) and dx
(`conv3x3_dx_ref`) are computed with every product so, and the results are
held to the JAX package's fp32 `conv3x3` and its custom VJP (Pallas
interpret mode) within the fp32 tolerance of the general conv's CUDA tests
(tests/test_torch_port_kernels.py: 2**-14 of the largest value). The same
plain versions with one TF32 pass a product miss it: the tolerance tells
the recipe apart from TF32. The deep case (8x8, 1280 -> 640: K = 11520 for
the forward) shows the margin where K is largest.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from diffusionhandles_tpu.ops import conv as jconv
from diffusionhandles_tpu_torch.ops import conv as tconv

# As tests/test_torch_port_kernels.py (F32_CONV_RTOL), whose comment
# derives it.
F32_CONV_RTOL = 2.0 ** -14


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to tf32 (10 explicit significand bits), to nearest
    with ties away from zero: adding half of the dropped 13 bits' unit to
    the sign-magnitude bits carries into the kept ones exactly then."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _conv3(x, w):
    """conv3x3_fwd_ref's fp32 sum of products, every product as 3xTF32."""
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    return (tconv.conv3x3_fwd_ref(xl, wh) + tconv.conv3x3_fwd_ref(xh, wl)
            + tconv.conv3x3_fwd_ref(xh, wh))


def _conv1(x, w):
    """The same with one TF32 pass a product."""
    return tconv.conv3x3_fwd_ref(_tf32(x), _tf32(w))


def _dx(dy, w, conv):
    """conv3x3_dx_ref (the conv of dy with the flipped, transposed kernel)
    with products `conv`."""
    return conv(dy, w.flip(2, 3).transpose(0, 1))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _case(b, side, ci, co, seed):
    """Seeded fp32 x (1.5 N + 0.5), w (N / sqrt(9 Ci)), dy (N), and the JAX
    package's fp32 conv3x3 and dx through its custom VJP on them, in
    interpret mode, all as NCHW torch tensors (w as [Co, Ci, 3, 3])."""
    rng = np.random.RandomState(seed)
    x = (1.5 * rng.randn(b, side, side, ci) + 0.5).astype(np.float32)
    wk = (rng.randn(3, 3, ci, co) * (9 * ci) ** -0.5).astype(np.float32)
    dy = rng.randn(b, side, side, co).astype(np.float32)
    assert jconv.conv3x3_ok(x.shape, wk.shape, dtype_bytes=4)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(jconv.conv3x3, jnp.asarray(x), jnp.asarray(wk))
        (dx, _) = vjp(jnp.asarray(dy))
    w = torch.from_numpy(np.ascontiguousarray(wk.transpose(3, 2, 0, 1)))
    return (_nchw(x), w, _nchw(dy)), (_nchw(y), _nchw(dx))


CASES = [(1, 8, 1280, 640, 0), (1, 16, 320, 320, 1)]


def _errors_over_tolerance(conv, b, side, ci, co, seed):
    """max |err| / (F32_CONV_RTOL * max |JAX|) of y and dx with products
    `conv`."""
    (x, w, dy), (y, dx) = _case(b, side, ci, co, seed)
    return [(got - want).abs().max().item()
            / (F32_CONV_RTOL * want.abs().max().item())
            for got, want in ((conv(x, w), y), (_dx(dy, w, conv), dx))]


@pytest.mark.parametrize("b,side,ci,co,seed", CASES)
def test_3xtf32_recipe_meets_the_fp32_tolerance(b, side, ci, co, seed):
    """y and dx with every product as 3xTF32 agree with the JAX package's
    fp32 conv3x3 within 2**-14 of the largest value, with room (under a
    tenth of it) at K up to 11520."""
    ratios = _errors_over_tolerance(_conv3, b, side, ci, co, seed)
    assert max(ratios) <= 0.1, dict(zip(("y", "dx"), ratios))


@pytest.mark.parametrize("b,side,ci,co,seed", CASES)
def test_one_tf32_pass_misses_the_fp32_tolerance(b, side, ci, co, seed):
    """The same with one TF32 pass a product misses the tolerance, in y
    and in dx."""
    ratios = _errors_over_tolerance(_conv1, b, side, ci, co, seed)
    assert min(ratios) > 1.0, dict(zip(("y", "dx"), ratios))


def test_split_is_exact_where_the_recipe_needs_it():
    """hi + lo reproduces x to within tf32's rounding of lo (2**-22 of x),
    both halves are tf32 numbers, and a 16-bit value (fp16, bf16) is its
    own hi with lo = 0: the one exact pass of the half dtypes."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4096, generator=gen) * 3.0
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert ((hi + lo - x).abs() <= 2.0 ** -22 * x.abs()).all()
    for dt in (torch.float16, torch.bfloat16):
        h = x.to(dt).float()
        assert torch.equal(_tf32(h), h)
        assert torch.equal(_tf32(h - _tf32(h)), torch.zeros_like(h))
