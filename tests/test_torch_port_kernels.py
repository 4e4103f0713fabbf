"""The port's flash-attention kernels and their wrappers (no JAX).

On the CPU: the plain versions against straightforward dense attention
and autograd, the wrappers' dispatch and the build helper's naming. On a
machine with an NVIDIA GPU (tests marked `cuda`; they skip elsewhere): the
CUDA kernels against their plain versions. This file imports nothing of
JAX, so it also runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py
"""

import math

import pytest
import torch

from diffusionhandles_tpu_torch.ops import attention as tatt
from diffusionhandles_tpu_torch.utils import cuda_build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0, device="cpu", dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * scale).to(device, dtype)


def _dense(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


@pytest.mark.parametrize("shape", [(1, 512, 2, 64), (2, 520, 1, 64),
                                   (1, 1024, 3, 32)])
def test_plain_versions_match_dense_autograd_fp32(shape):
    """fp32 (no rounding of p or ds): the plain forward equals dense
    softmax attention and the plain backward equals autograd through it,
    to fp32 summation order (rtol 1e-5 of the largest value)."""
    q, k, v, do = (_rand(shape, i, 1.5) for i in range(4))
    o, lse = tatt.flash_fwd_ref(q, k, v)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = _dense(qq, kk, vv)
    torch.testing.assert_close(o, want.detach(), rtol=0,
                               atol=1e-5 * want.abs().max().item())
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(shape[-1])
    torch.testing.assert_close(
        lse, torch.logsumexp(logits, -1).reshape(-1, shape[1]), rtol=0,
        atol=1e-5)
    grads = torch.autograd.grad(want, (qq, kk, vv), do)
    got = tatt.flash_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, grads):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-5 * w.abs().max().item())


def test_cpu_path_launches_no_kernel():
    tatt.reset_launch_counts()
    q, k, v = (_rand((1, 512, 2, 64), i) for i in range(3))
    tatt.flash_attention(q.requires_grad_(True), k, v).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert tatt.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0}


def test_library_name_tracks_sources():
    """The built library's name hashes the sources and headers, so an edited
    kernel is rebuilt instead of a stale library loaded."""
    a = cuda_build.library_path("flash_attention", tatt.KERNEL_SOURCES)
    b = cuda_build.library_path("flash_attention", tatt.KERNEL_SOURCES[:1])
    assert a != b and a.parent == cuda_build.BUILD_DIR
    assert a == cuda_build.library_path("flash_attention",
                                        tatt.KERNEL_SOURCES)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 5, 64), (2, 1024, 10, 64),
                                   (1, 520, 2, 64)])
def test_cuda_kernels_match_plain(cuda, shape):
    """On the card: each kernel against its plain version (tolerances as
    chip_smoke.py: O 2**-7 of max|O|, lse 2**-8, grads 2**-6 of max);
    520 tokens exercise the ragged last tile."""
    q, k, v, do = (_rand(shape, i, 1.5, cuda, torch.bfloat16)
                   for i in range(4))
    tatt.reset_launch_counts()
    o, lse = tatt.flash_fwd(q, k, v)
    o_ref, lse_ref = tatt.flash_fwd_ref(q, k, v)
    assert (o.float() - o_ref.float()).abs().max() <= (
        2.0 ** -7 * o_ref.float().abs().max())
    assert (lse - lse_ref).abs().max() <= 2.0 ** -8
    got = tatt.flash_bwd(q, k, v, o_ref, lse_ref, do)
    want = tatt.flash_bwd_ref(q, k, v, o_ref, lse_ref, do)
    for g, w in zip(got, want):
        assert (g.float() - w.float()).abs().max() <= (
            2.0 ** -6 * w.float().abs().max())
    assert tatt.LAUNCHES == {"flash_fwd": 1, "flash_bwd": 1}


@pytest.mark.cuda
def test_cuda_autograd_runs_the_kernels(cuda):
    q, k, v = (_rand((1, 1024, 2, 64), i, 1.0, cuda, torch.bfloat16)
               for i in range(3))
    tatt.reset_launch_counts()
    q.requires_grad_(True)
    tatt.dot_product_attention(q, k, v, use_flash=True).float().sum(
    ).backward()
    assert torch.isfinite(q.grad.float()).all()
    assert tatt.LAUNCHES == {"flash_fwd": 1, "flash_bwd": 1}


@pytest.mark.cuda
def test_cuda_kernels_refuse_other_inputs(cuda):
    q = torch.zeros((1, 512, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_fwd(q, q, q)
    q = torch.zeros((1, 512, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        tatt.flash_fwd(q, q, q)
