"""The port's hand-written kernels and their wrappers (no JAX): flash
attention (K1, K2 and the alternates K3-K6), the 3x3 conv (K7),
GroupNorm(+SiLU) (K8) and GroupNorm+SiLU+conv3x3 (K9).

On the CPU: the plain versions against straightforward dense attention
and autograd, the wrappers' dispatch and the build helper's naming. On a
machine with an NVIDIA GPU (tests marked `cuda`; they skip elsewhere): the
CUDA kernels against their plain versions. This file imports nothing of
JAX, so it also runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py
"""

import itertools
import math
import pathlib
import re

import pytest
import torch

from diffusionhandles_tpu_torch.ops import attention as tatt
from diffusionhandles_tpu_torch.ops import conv as tconv
from diffusionhandles_tpu_torch.ops import gn_conv as tgc
from diffusionhandles_tpu_torch.ops import groupnorm as tgn
from diffusionhandles_tpu_torch.utils import cuda_build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    # the plain versions' fp32 convolutions in full fp32, not TF32
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = allow


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


# every flash counter, kernel launches and plain routes alike, at 0
NO_FLASH_LAUNCH = dict.fromkeys(tatt.LAUNCHES, 0)


def test_cpu_path_launches_no_kernel(monkeypatch):
    """Every route on CPU tensors runs its plain version: each forward
    entry and each DIFFHANDLES_FLASH_BWD backward."""
    tatt.reset_launch_counts()
    q, k, v = (_rand((1, 512, 2, 64), i) for i in range(3))
    for mode in ("", "twopass", "fold"):
        monkeypatch.setenv(tatt.BWD_ENV, mode)
        qq = q.clone().requires_grad_(True)
        tatt.flash_attention_diff(qq, k, v).sum().backward()
        assert qq.grad is not None and torch.isfinite(qq.grad).all()
    tatt.flash_fwd_impl(q, k, v, fold=False)
    tatt.flash_attention(q, k, v, block_k=256)
    assert tatt.LAUNCHES == NO_FLASH_LAUNCH


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
    assert tatt.LAUNCHES == {**NO_FLASH_LAUNCH, "flash_fwd": 1,
                             "flash_bwd": 1}


@pytest.mark.cuda
def test_cuda_autograd_runs_the_kernels(cuda):
    q, k, v = (_rand((1, 1024, 2, 64), i, 1.0, cuda, torch.bfloat16)
               for i in range(3))
    tatt.reset_launch_counts()
    q.requires_grad_(True)
    tatt.dot_product_attention(q, k, v, use_flash=True).float().sum(
    ).backward()
    assert torch.isfinite(q.grad.float()).all()
    assert tatt.LAUNCHES == {**NO_FLASH_LAUNCH, "flash_fwd": 1,
                             "flash_bwd": 1}


def _assert_within(got, want, rtol, what):
    err = (got.float() - want.float()).abs().max().item()
    tol = rtol * want.float().abs().max().item()
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


# Tolerances of the alternates, as chip_smoke.py derives them: O 2**-7 of
# max|O| (bf16 p rounded against a running max), lse 2**-12 where both sides
# sum fp32 p (K4/K5: summation order and the online rescale only), 2**-8
# where both sum bf16 p (K1), grads 2**-6 of their max.
@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1024, 1024), (1000, 1500), (4096, 1024)])
def test_cuda_alternates_match_plain(cuda, sq, sk):
    """K1/K2 at sq != sk, K5, K4 (block_k 256 and one chunk) and the K3/K6
    routes against their plain versions, each counted on its own route."""
    q = _rand((2, sq, 2, 64), 0, 1.5, cuda, torch.bfloat16)
    k, v = (_rand((2, sk, 2, 64), i, 1.5, cuda, torch.bfloat16)
            for i in (1, 2))
    do = _rand((2, sq, 2, 64), 3, 1.0, cuda, torch.bfloat16)
    tatt.reset_launch_counts()
    fwd = [(tatt.flash_fwd(q, k, v), tatt.flash_fwd_ref(q, k, v), 2.0 ** -8),
           (tatt.flash_fwd_unfolded(q, k, v),
            tatt.flash_fwd_unfolded_ref(q, k, v), 2.0 ** -12)]
    for bk in (256, sk):
        fwd.append((tatt.flash_fwd_stream(q, k, v, bk),
                    tatt.flash_fwd_stream_ref(q, k, v, bk), 2.0 ** -12))
    for (o, lse), (o_ref, lse_ref), lse_tol in fwd:
        _assert_within(o, o_ref, 2.0 ** -7, "o")
        assert (lse - lse_ref).abs().max() <= lse_tol
    o, lse = tatt.flash_fwd_ref(q, k, v)
    for route, plain in ((tatt.flash_bwd, tatt.flash_bwd_ref),
                         (tatt.flash_bwd_twopass, tatt.flash_bwd_twopass_ref),
                         (tatt.flash_bwd_fold, tatt.flash_bwd_fold_ref)):
        for g, w, name in zip(route(q, k, v, o, lse, do),
                              plain(q, k, v, o, lse, do), "qkv"):
            assert g.shape == w.shape
            _assert_within(g, w, 2.0 ** -6, f"{route.__name__} d{name}")
    assert tatt.LAUNCHES == {**NO_FLASH_LAUNCH, "flash_fwd": 1,
                             "flash_fwd_unfolded": 1, "flash_fwd_stream": 2,
                             "flash_bwd": 1, "flash_bwd_twopass": 1,
                             "flash_bwd_fold": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("mode,route", [("", "flash_bwd"),
                                        ("twopass", "flash_bwd_twopass"),
                                        ("fold", "flash_bwd_fold")])
def test_cuda_autograd_backward_switch(cuda, monkeypatch, mode, route):
    """DIFFHANDLES_FLASH_BWD, set between calls, moves the backward to its
    route's kernels; the gradients agree with the default route's."""
    q, k, v = (_rand((1, 1024, 2, 64), i, 1.0, cuda, torch.bfloat16)
               for i in range(3))

    def grads():
        qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
        out = tatt.flash_attention_diff(qq, kk, vv)
        return torch.autograd.grad(out.float().square().sum(), (qq, kk, vv))

    monkeypatch.delenv(tatt.BWD_ENV, raising=False)
    want = grads()
    monkeypatch.setenv(tatt.BWD_ENV, mode)
    tatt.reset_launch_counts()
    got = grads()
    assert tatt.LAUNCHES == {**NO_FLASH_LAUNCH, "flash_fwd": 1, route: 1}
    for g, w in zip(got, want):
        _assert_within(g, w, 2.0 ** -6, route)


@pytest.mark.cuda
def test_cuda_forward_entries_count_their_routes(cuda):
    q, k, v = (_rand((1, 1024, 2, 64), i, 1.0, cuda, torch.bfloat16)
               for i in range(3))
    tatt.reset_launch_counts()
    tatt.flash_attention(q, k, v)
    tatt.flash_attention(q, k, v, block_k=256)
    tatt.flash_fwd_impl(q, k, v, fold=False)
    assert tatt.LAUNCHES == {**NO_FLASH_LAUNCH, "flash_fwd": 1,
                             "flash_fwd_stream": 1, "flash_fwd_unfolded": 1}


@pytest.mark.cuda
def test_cuda_kernels_refuse_other_inputs(cuda):
    """The kernel wrapper raises for what the kernels are not built for
    (the routed entries send such calls to the general route)."""
    q = torch.zeros((1, 512, 2, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_fwd_cuda(q, q, q)
    q = torch.zeros((1, 512, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        tatt.flash_fwd_cuda(q, q, q)


# The forward planner and the layout the kernels read (CPU: shapes only).
# (B, Sq, Sk, H) of the U-Net's four self-attention shapes and chip_smoke.py's
# CROSS_SHAPE, with the grid of 128-row query tiles each gives
FLASH_PLAN_GRIDS = [((1, 4096, 4096, 5), 160), ((2, 4096, 4096, 5), 320),
                    ((1, 1024, 1024, 10), 80), ((2, 1024, 1024, 10), 160),
                    ((2, 1000, 4096, 5), 80)]


@pytest.mark.parametrize("shape,grid", FLASH_PLAN_GRIDS)
def test_flash_plan_grid_covers_the_queries(shape, grid):
    """The planner's grid at each shape: query tiles of 64 rows per
    warpgroup times heads times batch, covering every query row once (the
    last tile ragged), its tile one csrc/flash_fwd.cu builds; a grid that
    leaves SMs idle in its last wave says so."""
    b, sq, sk, h = shape
    plan = tatt.plan_flash(b, h, sq, sk)
    assert (plan.warpgroups, plan.block_n) in tatt.FWD_TILES
    rows = 64 * plan.warpgroups
    tiles = plan.grid // (b * h)
    assert plan.grid == grid == tiles * b * h
    assert (tiles - 1) * rows < sq <= tiles * rows
    assert plan.waves == math.ceil(grid / tatt.SMS)
    assert bool(plan.note) == (grid % tatt.SMS != 0)


def test_flash_tiles_are_the_planners_picks():
    """Every tile csrc/flash_fwd.cu instantiates is the planner's pick at
    some U-Net shape or CROSS_SHAPE, and the file has each one; the
    backward's padded rows match flash_bwd.cu's."""
    picked = {tatt.plan_flash(b, h, sq, sk).launch_args()
              for (b, sq, sk, h), _ in FLASH_PLAN_GRIDS}
    assert picked == set(tatt.FWD_TILES)
    csrc = pathlib.Path(tatt.__file__).parents[1] / "csrc"
    cases = {(int(a), int(b)) for a, b in re.findall(
        r"FWD_CASE\((\d+), (\d+)\)", (csrc / "flash_fwd.cu").read_text())}
    assert cases == set(tatt.FWD_TILES)
    pad = re.search(r"constexpr int PAD = (\d+);",
                    (csrc / "flash_bwd.cu").read_text())
    assert int(pad.group(1)) == tatt.BWD_PAD


def test_flash_operands_are_read_in_place():
    """Slices of one [B, S, 3, H, D] tensor and the U-Net's projection views
    go to the kernels as they lie, with their strides; a size-1 dim gets the
    dense stride; a strided head dim, or a stride off 16 bytes, is copied
    dense once and counted."""
    qkv = torch.zeros((2, 10, 3, 4, 64), dtype=torch.bfloat16)
    before = tatt.LAYOUT_COPIES["flash"]
    x, strides = tatt._tma_operand(qkv[:, :, 1])
    assert x.data_ptr() == qkv[:, :, 1].data_ptr()
    assert strides == (10 * 3 * 4 * 64, 3 * 4 * 64, 64)
    proj = torch.zeros((1, 10, 256), dtype=torch.bfloat16).view(1, 10, 4, 64)
    assert tatt._tma_operand(proj)[1] == (10 * 256, 256, 64)
    one = torch.zeros((1, 10, 1, 64), dtype=torch.bfloat16)
    assert tatt._tma_operand(one)[1] == (640, 64, 64)
    assert tatt.LAYOUT_COPIES["flash"] == before
    wide = torch.zeros((1, 10, 4, 128), dtype=torch.bfloat16)
    x, strides = tatt._tma_operand(wide[..., ::2])
    assert x.is_contiguous() and strides == (10 * 4 * 64, 4 * 64, 64)
    odd = torch.zeros((1, 10, 4, 68), dtype=torch.bfloat16)[..., :64]
    x, strides = tatt._tma_operand(odd)
    assert x.is_contiguous() and strides == (10 * 4 * 64, 4 * 64, 64)
    assert tatt.LAYOUT_COPIES["flash"] == before + 2


def test_smoke_flash_sites_are_the_unets():
    """chip_smoke.py sums the attention kernels over FLASH_SITES: those are
    the SD-2-depth U-Net's self-attention layers that take the kernels at
    64x64 latents (flash_attention on, as the pipeline's config has it), by
    (tokens, heads, head dim)."""
    import collections

    import chip_smoke
    from diffusionhandles_tpu_torch.models import unet as tunet
    with torch.device("meta"):
        net = tunet.UNet2DConditionModel(tunet.UNetConfig(
            flash_attention=True))
    side = {"down_blocks": lambda i: 64 >> i, "mid_block": lambda i: 8,
            "up_blocks": lambda i: 8 << i}
    sites = collections.Counter()
    for name, mod in net.named_modules():
        if isinstance(mod, tunet.Attention) and name.endswith("attn1"):
            parts = name.split(".")
            tokens = side[parts[0]](int(parts[1]) if parts[1].isdigit()
                                    else 0) ** 2
            if mod.use_flash and tatt.flash_ok(tokens, tokens, mod.head_dim):
                sites[(tokens, mod.heads, mod.head_dim)] += 1
    assert sites == chip_smoke.FLASH_SITES
    assert sum(sites.values()) == 10


def _strided_qkv(b, s, h, device, seed):
    """q, k, v as slices of one [B, S, 3, H, 64] tensor."""
    qkv = _rand((b, s, 3, h, 64), seed, 1.5, device, torch.bfloat16)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(1, 1024, 2), (2, 520, 3)])
def test_cuda_strided_qkv_are_read_in_place(cuda, b, s, h):
    """Every route on q, k, v sliced from one [B, S, 3, H, 64] tensor is
    held to its plain version, with no layout copy."""
    q, k, v = _strided_qkv(b, s, h, cuda, 0)
    do = _rand((b, s, h, 64), 1, 1.0, cuda, torch.bfloat16)
    before = tatt.LAYOUT_COPIES["flash"]
    for route, plain, lse_tol in (
            (tatt.flash_fwd, tatt.flash_fwd_ref, 2.0 ** -8),
            (tatt.flash_fwd_unfolded, tatt.flash_fwd_unfolded_ref,
             2.0 ** -12)):
        (o, lse), (o_ref, lse_ref) = route(q, k, v), plain(q, k, v)
        _assert_within(o, o_ref, 2.0 ** -7, route.__name__)
        assert (lse - lse_ref).abs().max() <= lse_tol
    o, lse = tatt.flash_fwd_ref(q, k, v)
    for route, plain in ((tatt.flash_bwd, tatt.flash_bwd_ref),
                         (tatt.flash_bwd_fold, tatt.flash_bwd_fold_ref)):
        for g, w, name in zip(route(q, k, v, o, lse, do),
                              plain(q, k, v, o, lse, do), "qkv"):
            _assert_within(g, w, 2.0 ** -6, f"{route.__name__} d{name}")
    assert tatt.LAYOUT_COPIES["flash"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(1024, 1024), (1000, 1500)])
def test_cuda_backward_is_bitwise_repeatable(cuda, sq, sk):
    """No atomics and a fixed summation order: two backward calls on the
    same inputs give the same bits, on every route."""
    q = _rand((2, sq, 2, 64), 0, 1.5, cuda, torch.bfloat16)
    k, v = (_rand((2, sk, 2, 64), i, 1.5, cuda, torch.bfloat16)
            for i in (1, 2))
    do = _rand((2, sq, 2, 64), 3, 1.0, cuda, torch.bfloat16)
    o, lse = tatt.flash_fwd(q, k, v)
    for route in (tatt.flash_bwd, tatt.flash_bwd_twopass,
                  tatt.flash_bwd_fold):
        first, second = route(q, k, v, o, lse, do), route(q, k, v, o, lse, do)
        assert all(torch.equal(a, z) for a, z in zip(first, second))


@pytest.mark.cuda
def test_cuda_strided_head_dim_is_copied_once(cuda):
    """A q whose head dim is not unit-stride gets one dense copy (counted),
    and then the result of the dense input, bit for bit."""
    wide = _rand((1, 1024, 2, 128), 0, 1.5, cuda, torch.bfloat16)
    k, v = (_rand((1, 1024, 2, 64), i, 1.0, cuda, torch.bfloat16)
            for i in (1, 2))
    q = wide[..., ::2]
    before = tatt.LAYOUT_COPIES["flash"]
    o, lse = tatt.flash_fwd(q, k, v)
    assert tatt.LAYOUT_COPIES["flash"] == before + 1
    o_dense, lse_dense = tatt.flash_fwd(q.contiguous(), k, v)
    assert torch.equal(o, o_dense) and torch.equal(lse, lse_dense)


@pytest.mark.cuda
@pytest.mark.parametrize("f32_sum", [False, True])
@pytest.mark.parametrize("warpgroups,block_n", tatt.FWD_TILES)
def test_cuda_every_forward_instance_matches_plain(cuda, warpgroups, block_n,
                                                   f32_sum):
    """Each forward kernel instance, forced through a fixed plan, against
    the plain version of its row sum (K1's bf16, K5's fp32), at a ragged
    query and key length."""
    q = _rand((2, 1000, 3, 64), 0, 1.5, cuda, torch.bfloat16)
    k, v = (_rand((2, 1500, 3, 64), i, 1.5, cuda, torch.bfloat16)
            for i in (1, 2))
    plan = tatt.fixed_flash_plan(2, 3, 1000, warpgroups, block_n)
    o, lse = tatt._fwd_launch(q, k, v, f32_sum, "flash_fwd", plan)
    plain = tatt.flash_fwd_unfolded_ref if f32_sum else tatt.flash_fwd_ref
    o_ref, lse_ref = plain(q, k, v)
    _assert_within(o, o_ref, 2.0 ** -7, "o")
    assert (lse - lse_ref).abs().max() <= (2.0 ** -12 if f32_sum
                                           else 2.0 ** -8)


# ---------------------------------------------------------------------------
# K8 and K9. Tolerance of a kernel against its plain version, bf16: both
# round the same fp32 recipe once to bf16, with sums in another order and
# SiLU through another exp, so an element may land one bf16 ulp (2**-8
# relative) away; 2**-7 of the largest value bounds that.
# ---------------------------------------------------------------------------

GN_RTOL = 2.0 ** -7


def _assert_close(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    tol = GN_RTOL * want.float().abs().max().item()
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


def _gn_params(c, device, seed):
    gamma = 1.0 + 0.1 * _rand((c,), seed, device=device)
    return gamma, 0.1 * _rand((c,), seed + 1, device=device)


def test_gn_cpu_path_launches_no_kernel():
    tgn.reset_launch_counts()
    tgc.reset_launch_counts()
    x = _rand((1, 64, 4, 4), 0).requires_grad_(True)
    g, b = _gn_params(64, "cpu", 1)
    w = _rand((64, 64, 3, 3), 2, 0.05)
    y = tgn.gn_silu(x, g, b, 32, 1e-5, True, torch.float32)
    tgc.gn_silu_conv3x3(y, g, b, w, 32, 1e-5).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert tgn.LAUNCHES == dict.fromkeys(tgn.LAUNCHES, 0)
    assert tgc.LAUNCHES == dict.fromkeys(tgc.LAUNCHES, 0)


def test_gn_library_name_tracks_sources():
    a = cuda_build.library_path("groupnorm", tgn.KERNEL_SOURCES)
    assert a != cuda_build.library_path("flash_attention",
                                        tatt.KERNEL_SOURCES)
    assert a == cuda_build.library_path("groupnorm", tgn.KERNEL_SOURCES)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("hw,c,act", [(8, 1280, False), (64, 320, True)])
def test_cuda_gn_matches_plain(cuda, b, hw, c, act):
    """K8 forward and backward against the plain versions at the U-Net's
    smallest (8x8x1280, a transformer norm) and largest (64x64x320,
    conv_norm_out) sites."""
    x = _rand((b, c, hw, hw), 0, 1.5, cuda, torch.bfloat16)
    dy = _rand((b, c, hw, hw), 1, 1.0, cuda, torch.bfloat16)
    g, beta = _gn_params(c, cuda, 2)
    eps = 1e-5 if act else 1e-6
    tgn.reset_launch_counts()
    y, mean, rsig = tgn.gn_silu_fwd(x, g, beta, 32, eps, act, torch.bfloat16)
    y_ref, mean_ref, rsig_ref = tgn.gn_silu_fwd_ref(x, g, beta, 32, eps, act,
                                                    torch.bfloat16)
    _assert_close(y, y_ref, "y")
    _assert_close(rsig, rsig_ref, "rsig")
    got = tgn.gn_silu_bwd(x, dy, g, beta, mean_ref, rsig_ref, 32, act)
    want = tgn.gn_silu_bwd_ref(x, dy, g, beta, mean_ref, rsig_ref, 32, act)
    for gt, wt, what in zip(got, want, ("dx", "u", "v")):
        _assert_close(gt, wt, what)
    assert tgn.LAUNCHES == {**dict.fromkeys(tgn.LAUNCHES, 0),
                            "gn_silu_fwd": 1, "gn_silu_bwd": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("hw,ci,co", [(8, 1280, 1280), (64, 320, 320)])
def test_cuda_gn_conv_matches_plain(cuda, b, hw, ci, co):
    """K9 forward and dx against the plain versions at the U-Net's
    smallest (8x8, 1280 -> 1280) and largest (64x64, 320 -> 320) resnet
    halves."""
    x = _rand((b, ci, hw, hw), 0, 1.5, cuda, torch.bfloat16)
    w = _rand((co, ci, 3, 3), 1, (9 * ci) ** -0.5, cuda, torch.bfloat16)
    dy = _rand((b, co, hw, hw), 2, 1.0, cuda, torch.bfloat16)
    g, beta = _gn_params(ci, cuda, 3)
    tgc.reset_launch_counts()
    y, mean, rsig = tgc.gn_silu_conv3x3_fwd(x, g, beta, w, 32, 1e-5)
    y_ref, mean_ref, rsig_ref = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w,
                                                            32, 1e-5)
    _assert_close(y, y_ref, "y")
    _assert_close(rsig, rsig_ref, "rsig")
    dx = tgc.gn_silu_conv3x3_dx(x, g, beta, w, mean_ref, rsig_ref, dy, 32)
    dx_ref = tgc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean_ref, rsig_ref,
                                        dy, 32)
    _assert_close(dx, dx_ref, "dx")
    assert tgc.LAUNCHES == {**dict.fromkeys(tgc.LAUNCHES, 0),
                            "gn_silu_conv3x3_fwd": 1,
                            "gn_silu_conv3x3_dx": 1}


@pytest.mark.cuda
def test_cuda_gn_kernels_ragged_tiles(cuda):
    """Shapes off the U-Net's grid: 12x12 pixels (a partial 64-pixel
    tile), 48 -> 80 channels (partial 64-channel tiles), group width 6."""
    x = _rand((2, 48, 12, 12), 0, 1.5, cuda, torch.bfloat16)
    w = _rand((80, 48, 3, 3), 1, (9 * 48) ** -0.5, cuda, torch.bfloat16)
    dy = _rand((2, 80, 12, 12), 2, 1.0, cuda, torch.bfloat16)
    g, beta = _gn_params(48, cuda, 3)
    y, mean, rsig = tgc.gn_silu_conv3x3_fwd(x, g, beta, w, 8, 1e-5)
    y_ref, mean_ref, rsig_ref = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, 8,
                                                            1e-5)
    _assert_close(y, y_ref, "y")
    dx = tgc.gn_silu_conv3x3_dx(x, g, beta, w, mean_ref, rsig_ref, dy, 8)
    _assert_close(dx, tgc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean_ref,
                                                 rsig_ref, dy, 8), "dx")
    z = tgn.gn_silu_fwd(x, g, beta, 8, 1e-5, True, torch.bfloat16)[0]
    _assert_close(z, tgn.gn_silu_fwd_ref(x, g, beta, 8, 1e-5, True,
                                         torch.bfloat16)[0], "gn y")


@pytest.mark.cuda
def test_cuda_gn_autograd_runs_the_kernels(cuda):
    x = _rand((1, 320, 16, 16), 0, 1.0, cuda, torch.bfloat16)
    x.requires_grad_(True)
    g, beta = _gn_params(320, cuda, 1)
    w = _rand((320, 320, 3, 3), 2, 0.02, cuda, torch.bfloat16)
    tgn.reset_launch_counts()
    tgc.reset_launch_counts()
    y = tgn.gn_silu(x, g, beta, 32, 1e-6, False, torch.bfloat16)
    tgc.gn_silu_conv3x3(y, g, beta, w, 32, 1e-5).float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
    assert tgn.LAUNCHES == {**dict.fromkeys(tgn.LAUNCHES, 0),
                            "gn_silu_fwd": 1, "gn_silu_bwd": 1}
    assert tgc.LAUNCHES == {**dict.fromkeys(tgc.LAUNCHES, 0),
                            "gn_silu_conv3x3_fwd": 1,
                            "gn_silu_conv3x3_dx": 1}


@pytest.mark.cuda
def test_cuda_gn_kernels_refuse_other_inputs(cuda):
    """The kernel wrappers raise for what the kernels are not built for
    (the routed entries send such calls to the general route)."""
    x = torch.zeros((1, 64, 8, 8), device=cuda)
    g, beta = _gn_params(64, cuda, 0)
    with pytest.raises(TypeError):
        tgn.gn_silu_fwd_cuda(x, g, beta, 32, 1e-5, True, torch.float32)
    xb = x.to(torch.bfloat16)
    with pytest.raises(TypeError, match="writes bfloat16"):
        tgn.gn_silu_fwd_cuda(xb, g, beta, 32, 1e-5, True, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        tgn.gn_silu_fwd_cuda(xb[:, :, :3, :3], g, beta, 32, 1e-5, True,
                             torch.bfloat16)
    with pytest.raises(ValueError, match="groups"):
        tgn.gn_silu_fwd_general(x[:, :60], g[:60], beta[:60], 32, 1e-5,
                                True, torch.float32)
    mean = torch.zeros((1, 32), device=cuda)
    with pytest.raises(ValueError, match="dy"):
        tgn.gn_silu_bwd_cuda(xb, xb[:, :32], g, beta, mean, mean, 32, True)
    w = torch.zeros((64, 64, 3, 3), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tgc.gn_silu_conv3x3_fwd_cuda(xb[:, :36], g[:36], beta[:36],
                                     w[:, :36], 4, 1e-5)


# ---------------------------------------------------------------------------
# K8's planner and layouts (CPU), and the kernel at the U-Net's sites (card)
# ---------------------------------------------------------------------------

# (side, channels) of the U-Net's 17 GroupNorm sites at 512x512: five
# transformer norms at 64x64x320 and conv_norm_out (SiLU) there, five at
# 32x32x640, five at 16x16x1280, one at 8x8x1280 (the mid block)
GN_SITES = [(64, 320)] * 6 + [(32, 640)] * 5 + [(16, 1280)] * 5 + [(8, 1280)]
GN_SITE_SHAPES = sorted(set(GN_SITES), reverse=True)
# Shapes gn_ok admits whose slab no cluster's shared memory holds: (B, C,
# side) of a 512x512 latent at 320 channels, and a 1024x1024 one at 64
LARGE_GN_SHAPES = [(1, 320, 512), (1, 64, 1024)]
LAYOUTS = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}


def _assert_plan_fits(plan, c, groups, es, channels_last, bwd):
    cg = c // groups
    assert plan.slab % cg == 0 and c % plan.slab == 0, plan
    if channels_last:
        assert plan.slab * es % 16 == 0, plan
    assert plan.smem <= 227 * 1024, plan
    assert plan.smem == tgn.smem_bytes(es, channels_last, bwd, plan.slab,
                                       plan.chunk, plan.cluster)
    assert 1 <= plan.cluster <= 16 and plan.ppc % 8 == 0, plan
    assert plan.chunk % 8 == 0 and plan.chunk <= plan.ppc, plan


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,c", GN_SITE_SHAPES)
def test_gn_plan_at_unet_sites(side, c, b, dtype, layout):
    """At each GroupNorm site shape of the U-Net, both directions: the slab
    is whole groups (channels-last: a multiple of 16 bytes a pixel), a CTA
    takes at most 227 KB of shared memory, the cluster at most 16 CTAs, no
    CTA of a cluster is idle, and the plan is one launch."""
    cl = layout == "channels_last"
    es = dtype.itemsize
    for bwd in (False, True):
        plan = tgn.plan_gn(b, c, side * side, 32, dtype, dtype, cl, bwd)
        _assert_plan_fits(plan, c, 32, es, cl, bwd)
        assert not plan.streaming and plan.launches == 1, plan
        assert (plan.cluster - 1) * plan.ppc < side * side <= (
            plan.cluster * plan.ppc), plan
        assert plan.grid == b * (c // plan.slab) * plan.cluster


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,side", LARGE_GN_SHAPES)
def test_gn_plan_streams_what_no_cluster_holds(b, c, side, dtype, layout):
    """A shape the gate admits but no cluster holds takes the streaming
    plan (two launches, chunks within shared memory) in both directions."""
    cl = layout == "channels_last"
    es = dtype.itemsize
    assert tgn.gn_ok((b, side, side, c), 32, es)
    for bwd in (False, True):
        plan = tgn.plan_gn(b, c, side * side, 32, dtype, dtype, cl, bwd)
        _assert_plan_fits(plan, c, 32, es, cl, bwd)
        assert plan.streaming and plan.launches == 2, plan
        assert plan.cluster * plan.ppc >= side * side > plan.chunk, plan


def test_gn_plan_forced_options():
    """`cluster` forces a fused plan of that size (refused where it cannot
    hold the slab), `stream` the streaming plan at any shape; a
    channels-last slab that is not 16 bytes wide has no plan."""
    plan = tgn.plan_gn(1, 320, 4096, 32, torch.bfloat16, None, True, False,
                       cluster=16)
    assert (plan.cluster, plan.ppc, plan.streaming) == (16, 256, False)
    with pytest.raises(ValueError, match="cannot hold"):
        tgn.plan_gn(1, 320, 4096, 32, torch.bfloat16, None, True, True,
                    cluster=1)
    with pytest.raises(ValueError, match="not one of"):
        tgn.plan_gn(1, 320, 4096, 32, torch.bfloat16, None, True, False,
                    cluster=3)
    plan = tgn.plan_gn(1, 1280, 64, 32, torch.bfloat16, None, False, True,
                       stream=True)
    assert plan.streaming and plan.launches == 2
    assert tgn.slab_of(100, 4, 2, True) is None  # lcm(25, 8) > 100
    with pytest.raises(ValueError, match="no plan"):
        tgn.plan_gn(1, 100, 64, 4, torch.bfloat16, None, True, False)


def test_gn_memory_format_of():
    x = torch.zeros((2, 64, 4, 4))
    assert tgn.memory_format_of(x) == torch.contiguous_format
    xl = x.contiguous(memory_format=torch.channels_last)
    assert tgn.memory_format_of(xl) == torch.channels_last
    # a channel slice of a channels-last concat: not dense, still its
    # channels innermost
    cat = torch.zeros((2, 96, 4, 4)).contiguous(
        memory_format=torch.channels_last)
    assert tgn.memory_format_of(cat[:, :64]) == torch.channels_last
    assert tgn.memory_format_of(torch.zeros((2, 64, 1, 1))) == (
        torch.contiguous_format)
    assert tgn.memory_format_of(torch.zeros((2, 64, 16))) == (
        torch.contiguous_format)


def test_gn_autograd_keeps_memory_format():
    """On the CPU, gn_silu on a channels-last x copies nothing into another
    layout (LAYOUT_COPIES stays 0), returns y and dx channels-last, and
    gives the values of the same call on NCHW x (fp32, to 1e-5 of the
    largest value: the group sums run over the view in another order)."""
    x = _rand((2, 96, 8, 8), 0, 1.5)
    g, beta = _gn_params(96, "cpu", 1)
    dy = _rand((2, 96, 8, 8), 3)
    outs = {}
    copies = tgn.LAYOUT_COPIES["gn"]
    for name, fmt in LAYOUTS.items():
        xt = x.contiguous(memory_format=fmt).requires_grad_(True)
        y = tgn.gn_silu(xt, g, beta, 32, 1e-5, True, torch.float32)
        dx, = torch.autograd.grad(y, xt, dy.contiguous(memory_format=fmt))
        assert y.is_contiguous(memory_format=fmt), name
        assert dx.is_contiguous(memory_format=fmt), name
        outs[name] = (y, dx)
    assert tgn.LAYOUT_COPIES["gn"] == copies
    for got, want in zip(outs["channels_last"], outs["nchw"]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


def _gn_case(b, side, c, device, dtype, fmt, seed=0):
    x = _rand((b, c, side, side), seed, 1.5, device, dtype) + 0.5
    dy = _rand((b, c, side, side), seed + 1, 1.0, device, dtype)
    g, beta = _gn_params(c, device, seed + 2)
    return (x.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt),
            g, beta)


def _gn_check(x, dy, g, beta, groups, eps, act, out_dtype, fwd, bwd,
              what):
    """Forward and backward kernel calls (`fwd`, `bwd`) against the plain
    versions, each output in x's memory format; a repeated call gives the
    same bits."""
    y, mean, rsig = fwd(x, g, beta, groups, eps, act, out_dtype)
    y_ref, mean_ref, rsig_ref = tgn.gn_silu_fwd_ref(x, g, beta, groups, eps,
                                                    act, out_dtype)
    fmt = tgn.memory_format_of(x)
    assert y.dtype == out_dtype and y.is_contiguous(memory_format=fmt), what
    _assert_close(y, y_ref, f"{what} y")
    _assert_close(mean, mean_ref, f"{what} mean")
    _assert_close(rsig, rsig_ref, f"{what} rsig")
    got = bwd(x, dy, g, beta, mean_ref, rsig_ref, groups, act)
    want = tgn.gn_silu_bwd_ref(x, dy, g, beta, mean_ref, rsig_ref, groups,
                               act)
    assert got[0].dtype == x.dtype, what
    assert got[0].is_contiguous(memory_format=fmt), what
    for gt, wt, name in zip(got, want, ("dx", "u", "v")):
        _assert_close(gt, wt, f"{what} {name}")
    again = fwd(x, g, beta, groups, eps, act, out_dtype)
    assert all(torch.equal(a, b_) for a, b_ in zip((y, mean, rsig), again))
    again = bwd(x, dy, g, beta, mean_ref, rsig_ref, groups, act)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), what


def _forced(**force):
    """K8's bf16 launches with plans forced through plan_gn(**force), by
    the wrappers' inner calls, returning what the public wrappers return."""
    def plan(x, bwd_, out_dtype):
        b, c = x.shape[:2]
        return tgn.plan_gn(b, c, x[0, 0].numel(), 32, x.dtype, out_dtype,
                           tgn.memory_format_of(x) == torch.channels_last,
                           bwd_, card=True, **force)

    def f(x, g, beta, groups, eps, act, out_dtype):
        y, stats = tgn._fwd_stats(x, g, beta, groups, eps, act, out_dtype,
                                  "gn_silu_fwd", plan(x, False, out_dtype))
        return y, stats[0], stats[1]

    def b_(x, dy, g, beta, mean, rsig, groups, act):
        dx, uv = tgn._bwd_uv(x, dy, g, beta, mean.data_ptr(),
                             rsig.data_ptr(), groups, act, "gn_silu_bwd",
                             plan(x, True, x.dtype))
        return dx, uv[0], uv[1]
    return f, b_


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["planner", "stream"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,c,act", [(64, 320, True), (64, 320, False),
                                        (32, 640, False), (16, 1280, False),
                                        (8, 1280, False)])
def test_cuda_gn_sites_match_plain(cuda, side, c, act, b, layout, plan):
    """K8 at every GroupNorm site shape of the U-Net, in both layouts, with
    the planner's plan and with the streaming plan forced: forward (y,
    mean, rsig) and backward (dx, u, v) within GN_RTOL of the plain
    versions, outputs in x's layout, bitwise repeatable; one launch a
    direction (two when streaming) and no layout copy."""
    x, dy, g, beta = _gn_case(b, side, c, cuda, torch.bfloat16,
                              LAYOUTS[layout])
    fwd, bwd = tgn.gn_silu_fwd_cuda, tgn.gn_silu_bwd_cuda
    if plan == "stream":
        fwd, bwd = _forced(stream=True)
    copies = tgn.LAYOUT_COPIES["gn"]
    _gn_check(x, dy, g, beta, 32, 1e-5 if act else 1e-6, act,
              torch.bfloat16, fwd, bwd, (side, c, b, layout, plan))
    assert tgn.LAYOUT_COPIES["gn"] == copies


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("cluster", tgn.CLUSTERS)
def test_cuda_gn_every_cluster_size(cuda, cluster, layout):
    """Each cluster size (distributed shared memory across 1-16 CTAs) at
    32x32x320, B=2, where every size holds the slab in both directions."""
    x, dy, g, beta = _gn_case(2, 32, 320, cuda, torch.bfloat16,
                              LAYOUTS[layout], seed=4)
    fwd, bwd = _forced(cluster=cluster)
    _gn_check(x, dy, g, beta, 32, 1e-5, True, torch.bfloat16, fwd, bwd,
              (cluster, layout))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float16, torch.float16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_cuda_gn_general_instances_match_plain(cuda, dtype, out_dtype,
                                               layout):
    """The fp32 and fp16 instances (and mixed x / y types) of the same
    kernel in both layouts, at 32x32x640 and group width 3, against the
    plain versions with fp16 or bf16 parameters read as they are."""
    for side, c, groups in ((32, 640, 32), (8, 96, 32)):
        x, dy, g, beta = _gn_case(1, side, c, cuda, dtype, LAYOUTS[layout])
        g, beta = g.to(torch.float16), beta.to(torch.float16)
        tgn.reset_launch_counts()
        _gn_check(x, dy, g, beta, groups, 1e-5, True, out_dtype,
                  tgn.gn_silu_fwd_general, tgn.gn_silu_bwd_general,
                  (side, c, dtype, out_dtype, layout))
        assert tgn.LAUNCHES == _counted(tgn.LAUNCHES, gn_silu_fwd_general=2,
                                        gn_silu_bwd_general=2)


@pytest.mark.cuda
def test_cuda_gn_layout_copies_only_where_counted(cuda):
    """A channels-last slice of a concat is copied once into the kernel's
    layout, a channels-last x whose groups make no 16-byte slab is read as
    NCHW (x in, y back: two copies), each counted; the results agree with
    the plain versions and keep x's memory format."""
    cat = _rand((1, 96, 16, 16), 0, 1.0, cuda, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    g, beta = _gn_params(64, cuda, 1)
    copies = tgn.LAYOUT_COPIES["gn"]
    y = tgn.gn_silu_fwd_cuda(cat[:, :64], g, beta, 32, 1e-5, True,
                             torch.bfloat16)[0]
    assert tgn.LAYOUT_COPIES["gn"] == copies + 1
    assert y.is_contiguous(memory_format=torch.channels_last)
    _assert_close(y, tgn.gn_silu_fwd_ref(cat[:, :64], g, beta, 32, 1e-5,
                                         True, torch.bfloat16)[0], "slice")
    x = _rand((1, 100, 8, 8), 2, 1.0, cuda, torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    g, beta = _gn_params(100, cuda, 3)
    y = tgn.gn_silu_fwd_cuda(x, g, beta, 4, 1e-5, False, torch.bfloat16)[0]
    assert tgn.LAYOUT_COPIES["gn"] == copies + 3
    assert y.is_contiguous(memory_format=torch.channels_last)
    _assert_close(y, tgn.gn_silu_fwd_ref(x, g, beta, 4, 1e-5, False,
                                         torch.bfloat16)[0], "no slab")


@pytest.mark.cuda
def test_cuda_gn_transformer_gradient_is_read_in_place(cuda):
    """The transformer's pattern: y of a channels-last x viewed as [B, HW,
    C]; its gradient comes back as a permuted view, channels-last, and the
    backward reads it in place: no layout copy either way, dx
    channels-last."""
    x = _rand((1, 640, 32, 32), 0, 1.0, cuda, torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    g, beta = _gn_params(640, cuda, 1)
    w = _rand((640, 640), 2, 0.03, cuda, torch.bfloat16)
    copies = tgn.LAYOUT_COPIES["gn"]
    tgn.reset_launch_counts()
    y = tgn.gn_silu(x, g, beta, 32, 1e-6, False, torch.bfloat16)
    h = y.permute(0, 2, 3, 1).reshape(1, 32 * 32, 640)
    assert h.is_contiguous() and h.data_ptr() == y.data_ptr()  # a view
    (h @ w).float().square().sum().backward()
    assert tgn.LAYOUT_COPIES["gn"] == copies
    assert x.grad.is_contiguous(memory_format=torch.channels_last)
    assert tgn.LAUNCHES == _counted(tgn.LAUNCHES, gn_silu_fwd=1,
                                    gn_silu_bwd=1)


@pytest.mark.cuda
def test_cuda_gn_library_agrees_with_the_planner(cuda):
    """The library's shared-memory size of a plan is the planner's copy's
    (smem_bytes, which plans off the card), and the card schedules every
    plan the planner picks at the sites."""
    lib = tgn.kernel_library()
    for side, c in GN_SITE_SHAPES + [(s_, c_) for _, c_, s_ in
                                     LARGE_GN_SHAPES]:
        for dt, cl, bwd in itertools.product(
                (torch.bfloat16, torch.float32), (True, False),
                (False, True)):
            plan = tgn.plan_gn(1, c, side * side, 32, dt, dt, cl, bwd,
                               card=True)
            es = dt.itemsize
            assert lib.gn_smem_bytes(es, int(cl), int(bwd), plan.slab,
                                     plan.chunk, plan.cluster) == plan.smem
            assert tgn.smem_bytes(es, cl, bwd, plan.slab, plan.chunk,
                                  plan.cluster) == plan.smem
            code = cuda_build.ELEM_CODES[dt]
            assert lib.gn_max_clusters(int(bwd), code, code, int(cl),
                                       plan.cluster, plan.smem) >= 1


# ---------------------------------------------------------------------------
# K7. Tolerance of the kernel against its plain version, bf16: both round
# the same fp32 tap sums once to bf16, summed in another order, so an
# element may land one bf16 ulp (2**-8 relative) away; 2**-7 of the largest
# value bounds that.
# ---------------------------------------------------------------------------

def test_conv_cpu_path_launches_no_kernel():
    tconv.reset_launch_counts()
    x = _rand((1, 64, 6, 6), 0).requires_grad_(True)
    w = _rand((64, 64, 3, 3), 1, 0.05)
    tconv.conv3x3(x, w).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert tconv.LAUNCHES == dict.fromkeys(tconv.LAUNCHES, 0)


# (side, Ci, Co) of the 16 distinct 3x3 convs of the SD-2-depth conv U-Net
# at 64x64 latents (44 resnet halves and 3 upsamplers)
SD2_CONV_SITES = [(64, 320, 320), (64, 640, 320), (64, 640, 640),
                  (64, 960, 320), (32, 320, 640), (32, 640, 640),
                  (32, 960, 640), (32, 1280, 640), (32, 1280, 1280),
                  (32, 1920, 640), (16, 640, 1280), (16, 1280, 1280),
                  (16, 1920, 1280), (16, 2560, 1280), (8, 1280, 1280),
                  (8, 2560, 1280)]


def _site_plans(b, side, ci, co):
    """The planner's forward (K = 9 Ci, N = Co) and dx (K = 9 Co, N = Ci)
    plans of a site."""
    return {"fwd": (ci, tconv.plan_conv3x3(b, side, side, ci, co)),
            "dx": (co, tconv.plan_conv3x3(b, side, side, co, ci))}


def _assert_boxes_tile_each_image(plan, b, side, what):
    """The M tiles, decomposed from the grid index as the kernel does
    (column tile fastest, then row tile, then image tile), cover every
    pixel of every image exactly once (boxes clipped at the edge)."""
    bw, bh, bb = plan.box
    assert bw * bh * bb == 64 * plan.warpgroups, what
    tiles_w, tiles_h = math.ceil(side / bw), math.ceil(side / bh)
    assert plan.m_tiles == tiles_w * tiles_h * math.ceil(b / bb), what
    covered = torch.zeros((b, side, side), dtype=torch.int32)
    for t in range(plan.m_tiles):
        w0, h0 = t % tiles_w * bw, t // tiles_w % tiles_h * bh
        b0 = t // (tiles_w * tiles_h) * bb
        covered[b0:b0 + bb, h0:h0 + bh, w0:w0 + bw] += 1
    assert bool((covered == 1).all()), what


def _assert_splits_cover_k(plan, kch, what):
    """K is 9 taps x ceil(channels / 64) steps; the splits' step ranges
    (as the kernel cuts them) are contiguous, each at least one step, and
    together exactly K."""
    assert plan.k_steps == 9 * math.ceil(kch / tconv.K_STEP), what
    ranges = plan.split_ranges()
    assert len(ranges) == plan.splits >= 1, what
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_steps, what
    assert all(end - start >= 1 for start, end in ranges), what
    assert all(a[1] == z[0] for a, z in zip(ranges, ranges[1:])), what


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,ci,co", SD2_CONV_SITES)
def test_conv_plan_pixel_boxes_tile_each_image(b, side, ci, co):
    """Each plan's M tiles cover every pixel of every image exactly once."""
    for what, (_, plan) in _site_plans(b, side, ci, co).items():
        _assert_boxes_tile_each_image(plan, b, side, what)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,ci,co", SD2_CONV_SITES)
def test_conv_plan_splits_cover_k_exactly(b, side, ci, co):
    """Each plan's K splits cover K exactly."""
    for what, (kch, plan) in _site_plans(b, side, ci, co).items():
        _assert_splits_cover_k(plan, kch, what)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,ci,co", SD2_CONV_SITES)
def test_conv_plan_grid_fills_a_wave_or_says_why(b, side, ci, co):
    """Each plan's grid (M tiles x N tiles x splits) reaches one wave of
    the card's 132 SMs, or its note says why not; its tile is one the
    kernel file has."""
    for what, (_, plan) in _site_plans(b, side, ci, co).items():
        assert (plan.warpgroups, plan.block_n) in tconv.TILES, what
        assert plan.grid >= tconv.SMS or plan.note, (what, plan)


def test_conv_tiles_are_the_planners_picks():
    """Every tile csrc/conv.cu instantiates is the planner's pick at some
    site of the U-Net (B 1 or 2, forward or dx): no kernel instance is
    built that the main path never launches; and the file has each one."""
    picked = {(plan.warpgroups, plan.block_n)
              for b in (1, 2) for side, ci, co in SD2_CONV_SITES
              for _, plan in _site_plans(b, side, ci, co).values()}
    assert picked == set(tconv.TILES)
    source = (pathlib.Path(tconv.__file__).parents[1] / "csrc"
              / "conv.cu").read_text()
    cases = {(int(a), int(b)) for a, b in
             re.findall(r"CONV_CASE\((\d+), (\d+)\)", source)}
    assert cases == set(tconv.TILES)


def _general_plans(b, side, ci, co):
    """The general kernel's plans at a site: forward (K = 9 Ci, N = Co),
    dx (K = 9 Co, N = Ci), and K9's dx (fp32 out, the caller sums)."""
    return {"fwd": (ci, co, tconv.plan_conv3x3_general(b, side, side, ci,
                                                       co)),
            "dx": (co, ci, tconv.plan_conv3x3_general(b, side, side, co,
                                                      ci)),
            "k9_dx": (co, ci, tconv.plan_conv3x3_general(
                b, side, side, co, ci, f32_out=True))}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,ci,co", SD2_CONV_SITES)
def test_conv_general_plans_cover_the_gemm(b, side, ci, co):
    """The general kernel's plans at the U-Net's sites: a tile it builds
    (GENERAL_TILES), pixel boxes tiling each image and N tiles covering the
    GEMM, K in 32-channel steps per tap, each split at least
    GENERAL_MIN_SPLIT_STEPS steps and the grid within two waves where it
    splits."""
    for what, (kch, nch, plan) in _general_plans(b, side, ci, co).items():
        assert (plan.warpgroups, plan.block_n) in tconv.GENERAL_TILES, what
        _assert_boxes_tile_each_image(plan, b, side, what)
        assert plan.n_tiles == math.ceil(nch / plan.block_n), what
        assert plan.k_steps == 9 * math.ceil(kch / tconv.GENERAL_K_STEP)
        assert plan.splits == 1 or (
            plan.k_steps // plan.splits >= tconv.GENERAL_MIN_SPLIT_STEPS
            and plan.grid <= 2 * tconv.SMS), (what, plan)
        assert plan.launch_args() == (plan.warpgroups, plan.block_n,
                                      *plan.box, plan.splits)


def test_conv_general_tiles_are_the_kernels():
    """Every tile csrc/conv_general.cu instantiates is the general
    planner's pick at some site of the U-Net (B 1 or 2, forward, dx or
    K9's dx), and the file has each tile the planner may pick."""
    picked = {(plan.warpgroups, plan.block_n)
              for b in (1, 2) for side, ci, co in SD2_CONV_SITES
              for *_, plan in _general_plans(b, side, ci, co).values()}
    assert picked == set(tconv.GENERAL_TILES)
    source = (pathlib.Path(tconv.__file__).parents[1] / "csrc"
              / "conv_general.cu").read_text()
    cases = {(int(a), int(b)) for a, b in
             re.findall(r"GEN_CASE\((\d+), (\d+)\)", source)}
    assert cases == set(tconv.GENERAL_TILES)


# (side, Ci, Co) of the fused U-Net's K9 sites at 64x64 latents (34 of its
# 44 resnet halves; chip_smoke.py's CONV_SHAPES)
SD2_GN_CONV_SITES = [(64, 320, 320), (32, 320, 640), (32, 640, 640),
                     (32, 960, 640), (32, 1280, 640), (16, 640, 1280),
                     (16, 1280, 1280), (8, 1280, 1280)]


def _gn_conv_plans(b, side, ci, co):
    """K9's forward plan (K7's: K = 9 Ci, N = Co, bf16 out) and dx plan
    (K = 9 Co, N = Ci, fp32 out: its epilogue pass sums the splits)."""
    return {"fwd": (ci, tconv.plan_conv3x3(b, side, side, ci, co)),
            "dx": (co, tconv.plan_conv3x3(b, side, side, co, ci,
                                          f32_out=True))}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("side,ci,co", SD2_GN_CONV_SITES)
def test_gn_conv_plans_tile_cover_k_and_use_built_tiles(b, side, ci, co):
    """K9's plans at the fused U-Net's sites: pixel boxes tile each image,
    the splits cover K, and every picked tile is one csrc/conv.cu builds
    (TILES); its grid fills a wave or its note says why."""
    for what, (kch, plan) in _gn_conv_plans(b, side, ci, co).items():
        _assert_boxes_tile_each_image(plan, b, side, what)
        _assert_splits_cover_k(plan, kch, what)
        assert (plan.warpgroups, plan.block_n) in tconv.TILES, what
        assert plan.grid >= tconv.SMS or plan.note, (what, plan)


def test_gn_conv_prologue_plain_version_is_the_forwards_z():
    """The prologue's plain version gives, bit for bit, the z the forward's
    plain version convolves (the JAX kernel's rounding point: the fp32
    normalize, affine and SiLU rounded once to x's dtype); and the
    forward's y is the conv of it."""
    b, ci, co, hw, groups = 2, 48, 32, 6, 8
    x = _rand((b, ci, hw, hw), 0, 1.5).to(torch.bfloat16)
    w = _rand((co, ci, 3, 3), 1, (9 * ci) ** -0.5).to(torch.bfloat16)
    g, beta = _gn_params(ci, "cpu", 2)
    y, mean, rsig = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, groups, 1e-5)
    z = tgc.gn_silu_z_ref(x, mean, rsig, g, beta, groups)
    xg = x.float().reshape(b, groups, ci // groups, hw * hw)
    xh = (xg - mean[:, :, None, None]) * rsig[:, :, None, None]
    want = torch.nn.functional.silu(
        xh * g.reshape(1, groups, -1, 1) + beta.reshape(1, groups, -1, 1))
    assert z.dtype == torch.bfloat16
    assert torch.equal(z, want.reshape(x.shape).to(torch.bfloat16))
    assert torch.equal(y, tconv.conv3x3_fwd_ref(z, w))


# ---------------------------------------------------------------------------
# Routes: every call a copied gate admits has a kernel on the card (the
# Hopper kernel, or the op's general kernel, counted as its general route).
# ---------------------------------------------------------------------------

DTYPES = (torch.float32, torch.float16, torch.bfloat16)
HALF = (torch.float16, torch.bfloat16)  # the Hopper kernels' instances
DEVICES = (torch.device("cpu"), torch.device("cuda"))


def _assert_routed(r, device, kernel_takes, what):
    if device.type == "cpu":
        assert r == "cpu", what
    else:
        assert r == ("kernel" if kernel_takes else "general"), what


def test_routes_cover_every_gate_admitted_call():
    """For every op, each dtype x shape its gate admits gets a route on
    each device: "cpu" on the CPU; on the card "kernel" exactly where the
    Hopper kernel is built for the dtype and shape (bf16 and fp16 at head
    dim 64, or channels multiples of 8; K8 bf16 in and out), else
    "general"."""
    admitted = {"flash": 0, "conv": 0, "gn": 0, "gn_conv": 0}
    for dev in DEVICES:
        for dt in DTYPES:
            nbytes = torch.finfo(dt).bits // 8
            for sq, sk, hd in itertools.product(
                    (512, 1000, 1024, 4096), (512, 1024, 4096),
                    (32, 40, 64, 80, 128)):
                if not tatt.flash_ok(sq, sk, head_dim=hd):
                    continue
                admitted["flash"] += 1
                _assert_routed(tatt.flash_route(dev, dt, hd), dev,
                               dt in HALF and hd == 64, (sq, sk, hd, dt))
            for side, ci, co in itertools.product(
                    (6, 8, 16, 64), (64, 100, 320, 1280, 2560),
                    (64, 100, 320, 1280)):
                x_shape, w_shape = (2, side, side, ci), (3, 3, ci, co)
                if tconv.conv3x3_ok(x_shape, w_shape, dtype_bytes=nbytes):
                    admitted["conv"] += 1
                    _assert_routed(
                        tconv.conv3x3_route(dev, dt, ci, co), dev,
                        dt in HALF and ci % 8 == 0 and co % 8 == 0,
                        (side, ci, co, dt))
                for groups in (32, 4):
                    if tgc.gn_silu_conv3x3_ok(x_shape, w_shape, groups):
                        admitted["gn_conv"] += 1
                        _assert_routed(
                            tgc.gn_conv_route(dev, dt, ci, co), dev,
                            dt in HALF and ci % 8 == 0 and co % 8 == 0,
                            (side, ci, co, groups, dt))
                    for out in DTYPES:
                        if not tgn.gn_ok((2, side, side, ci), groups,
                                         dtype_bytes=nbytes):
                            continue
                        admitted["gn"] += 1
                        _assert_routed(tgn.gn_route(dev, dt, out), dev,
                                       dt == out == torch.bfloat16,
                                       (side, ci, dt, out))
    assert all(n > 0 for n in admitted.values()), admitted


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("hw,ci,co", [(64, 320, 320), (8, 2560, 1280),
                                      (16, 1920, 1280), (12, 48, 80),
                                      (5, 64, 96)])
def test_cuda_conv_matches_plain(cuda, b, hw, ci, co):
    """K7 forward and dx against the plain versions: the U-Net's largest
    (64x64, 320 -> 320) and smallest (8x8 decoder concat, 2560 -> 1280)
    sites, a Ci != Co concat site with 1920 channels, and ragged pixel
    boxes and channel tiles (12x12, 48 -> 80; 5x5, 64 -> 96), which TMA's
    zero fill and clipped stores serve. Outputs are channels-last."""
    x = _rand((b, ci, hw, hw), 0, 1.0, cuda, torch.bfloat16)
    w = _rand((co, ci, 3, 3), 1, (9 * ci) ** -0.5, cuda, torch.bfloat16)
    dy = _rand((b, co, hw, hw), 2, 1.0, cuda, torch.bfloat16)
    tconv.reset_launch_counts()
    y = tconv.conv3x3_fwd(x, w)
    dx = tconv.conv3x3_dx(dy, w, x.dtype)
    _assert_within(y, tconv.conv3x3_fwd_ref(x, w), GN_RTOL, "y")
    _assert_within(dx, tconv.conv3x3_dx_ref(dy, w, x.dtype), GN_RTOL, "dx")
    assert tconv.in_kernel_layout(y) and tconv.in_kernel_layout(dx)
    assert tconv.LAUNCHES == {**dict.fromkeys(tconv.LAUNCHES, 0),
                              "conv3x3_fwd": 1, "conv3x3_dx": 1}


def _conv_launch(name, src, w, plan):
    """One K7 launch with a forced plan, on channels-last copies."""
    return tconv._launch(name, tconv.to_kernel_layout(src),
                         tconv.to_kernel_layout(w), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("warpgroups,block_n", tconv.TILES)
def test_cuda_conv_every_instance_matches_plain(cuda, warpgroups, block_n,
                                                splits):
    """Each kernel instance (consumer warpgroups x N tile), whole and
    split-K, forced through a fixed plan, against the plain versions; 640
    output channels leave a ragged N tile at 128 and 256."""
    b, hw, ci, co = 2, 16, 320, 640
    x = _rand((b, ci, hw, hw), 0, 1.0, cuda, torch.bfloat16)
    w = _rand((co, ci, 3, 3), 1, (9 * ci) ** -0.5, cuda, torch.bfloat16)
    dy = _rand((b, co, hw, hw), 2, 1.0, cuda, torch.bfloat16)
    fwd = tconv.fixed_plan(b, hw, hw, ci, co, warpgroups, block_n, splits)
    bwd = tconv.fixed_plan(b, hw, hw, co, ci, warpgroups, block_n, splits)
    _assert_within(_conv_launch("conv3x3_fwd", x, w, fwd),
                   tconv.conv3x3_fwd_ref(x, w), GN_RTOL, "y")
    _assert_within(_conv_launch("conv3x3_dx", dy, w, bwd),
                   tconv.conv3x3_dx_ref(dy, w, x.dtype), GN_RTOL, "dx")


@pytest.mark.cuda
def test_cuda_conv_autograd_and_channels_last(cuda):
    """The autograd op runs both kernels on an input with channels-last
    strides (the layout the kernel reads) and an fp32 weight (cast)."""
    x = _rand((1, 320, 16, 16), 0, 1.0, cuda, torch.bfloat16)
    w = _rand((640, 320, 3, 3), 1, 0.02, cuda, torch.float32)
    xl = x.to(memory_format=torch.channels_last).requires_grad_(True)
    tconv.reset_launch_counts()
    y = tconv.conv3x3(xl, w)
    _assert_within(y, tconv.conv3x3_fwd_ref(x, w), GN_RTOL, "y")
    y.float().sum().backward()
    assert torch.isfinite(xl.grad.float()).all()
    assert tconv.LAUNCHES == {**dict.fromkeys(tconv.LAUNCHES, 0),
                              "conv3x3_fwd": 1, "conv3x3_dx": 1}


@pytest.mark.cuda
def test_cuda_conv_nchw_and_channels_last_inputs_agree(cuda):
    """An NCHW input is copied to channels-last, never read through the
    wrong strides: it gives the channels-last input's result bit for bit,
    in both directions, and the output is channels-last either way."""
    x = _rand((2, 320, 32, 32), 0, 1.0, cuda, torch.bfloat16)
    dy = _rand((2, 640, 32, 32), 1, 1.0, cuda, torch.bfloat16)
    w = tconv.to_kernel_layout(_rand((640, 320, 3, 3), 2, 0.02, cuda,
                                     torch.bfloat16))
    y_n = tconv.conv3x3_fwd(x, w)
    y_l = tconv.conv3x3_fwd(tconv.to_kernel_layout(x), w)
    dx_n = tconv.conv3x3_dx(dy, w, torch.bfloat16)
    dx_l = tconv.conv3x3_dx(tconv.to_kernel_layout(dy), w, torch.bfloat16)
    assert torch.equal(y_n, y_l) and torch.equal(dx_n, dx_l)
    assert all(tconv.in_kernel_layout(t) for t in (y_n, y_l, dx_n, dx_l))
    # an NCHW weight is copied to the kernel's layout: the same result
    assert torch.equal(tconv.conv3x3_fwd(x, w.contiguous()), y_n)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,ci,co", [(8, 2560, 1280), (16, 1280, 1280)])
def test_cuda_conv_split_k_is_deterministic(cuda, hw, ci, co):
    """Split-K sums its fp32 partials in a fixed order: two calls give the
    same bits, with the planner's split and with a forced one of 6."""
    x = _rand((1, ci, hw, hw), 0, 1.0, cuda, torch.bfloat16)
    dy = _rand((1, co, hw, hw), 1, 1.0, cuda, torch.bfloat16)
    w = tconv.to_kernel_layout(_rand((co, ci, 3, 3), 2, (9 * ci) ** -0.5,
                                     cuda, torch.bfloat16))
    forced = (tconv.fixed_plan(1, hw, hw, ci, co, 2, 128, 6),
              tconv.fixed_plan(1, hw, hw, co, ci, 2, 128, 6))
    for fwd, bwd in ((None, None), forced):
        runs = [(_conv_launch("conv3x3_fwd", x, w, fwd),
                 _conv_launch("conv3x3_dx", dy, w, bwd))
                for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])
        _assert_within(runs[0][0], tconv.conv3x3_fwd_ref(x, w), GN_RTOL,
                       "y")


@pytest.mark.cuda
def test_cuda_conv_refuses_other_inputs(cuda):
    """The kernel wrapper raises for what the kernel is not built for
    (the routed entries send such calls to the general route)."""
    x = torch.zeros((1, 64, 8, 8), device=cuda)
    w = torch.zeros((64, 64, 3, 3), device=cuda)
    with pytest.raises(TypeError):
        tconv.conv3x3_fwd_cuda(x, w)
    xb = torch.zeros((1, 36, 8, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tconv.conv3x3_fwd_cuda(xb, w[:, :36])


def _counted(launches, **moved):
    """`launches` with every counter at 0 except `moved`."""
    return {**dict.fromkeys(launches, 0), **moved}


# Tolerances of the fp32 general routes against their plain versions (fp32
# end to end, products in full fp32 on the card or the CPU). The kernels
# multiply fp32 on the tensor cores as 3xTF32: x = hi + lo with hi and lo
# tf32 (11 significant bits each, rounded to nearest), each product as
# lo.hi' + hi.lo' + hi.hi' summed in fp32. What is dropped, lo.lo' and
# the rounding of lo, is below 2**-21 of |x y| a product. A logit sums 40-
# 160 such products of magnitude < 1 (q pre-scaled by 1/sqrt(d)), so it
# moves by < 2**-17 absolute, p = exp(s - m) and lse by as much relative
# and absolute; the value products and the gradients' sums (p or ds times
# v, dO, q_s or k, over up to 4096 rows) add another 2**-21 relative a
# term. O and the gradients stay within ~2**-17 of their largest value and
# lse within 2**-17; 2**-14 leaves 8x. One TF32 pass (each operand rounded
# to 11 bits, 2**-11 a product) moves a logit by ~2**-11 and misses these:
# lse by 2**-12 or more, and ds = p (dp - delta) with dp 2**-11 off moves
# the gradients by ~2**-11 of their largest value
# (tests/test_torch_flash_tf32_recipe.py shows both on the CPU).
F32_RTOL = 2.0 ** -14      # O and gradients, of the largest value
F32_LSE_ATOL = 2.0 ** -14  # lse, absolute
# The fp32 general conv (K7 and K9 general, csrc/conv_general.cu) against
# its plain version (fp32 products): the kernel multiplies as 3xTF32 too,
# each product within 2**-21, and an output (a sum of 9 * Ci of them)
# lands ~2**-21 of the largest value away; one TF32 pass (2**-11 a
# product) lands ~2**-12 away and misses 2**-14
# (tests/test_torch_conv_tf32_recipe.py, emulated at K up to 11520: the
# recipe at 0.007-0.010x of it, one TF32 pass at 4.7-5.1x).
F32_CONV_RTOL = 2.0 ** -14
# The half dtypes' (chip_smoke.py's): O 2**-7 of the largest value, lse
# 2**-8 absolute, gradients 2**-6
HALF_TOLS = (2.0 ** -7, 2.0 ** -8, 2.0 ** -6)


def _general_tols(dtype):
    """(O rtol, lse atol, gradient rtol) of a general route in `dtype`."""
    if dtype == torch.float32:
        return F32_RTOL, F32_LSE_ATOL, F32_RTOL
    return HALF_TOLS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,head_dim", [(torch.float32, 64),
                                            (torch.float16, 80),
                                            (torch.bfloat16, 40),
                                            (torch.float32, 128)])
def test_cuda_flash_general_route_matches_cpu(cuda, dtype, head_dim):
    """A flash call the gate admits in a dtype or head dim the Hopper
    kernels are not built for runs the general kernels on the card,
    counted as their route, forward and backward, and agrees with the same
    call on the CPU (_general_tols: fp32 O and gradients 2**-14, fp16 and
    bf16 O 2**-7 and gradients 2**-6 of the largest value)."""
    shape = (1, 512, 2, head_dim)
    assert tatt.flash_ok(512, 512, head_dim=head_dim)
    o_tol, _, g_tol = _general_tols(dtype)
    outs = {}
    for dev in ("cpu", cuda):
        q, k, v = (_rand(shape, i, 1.5, dev, dtype).requires_grad_(True)
                   for i in range(3))
        tatt.reset_launch_counts()
        o = tatt.dot_product_attention(q, k, v, use_flash=True)
        o.float().square().sum().backward()
        outs[str(dev)] = (o, q.grad, k.grad, v.grad)
    assert tatt.LAUNCHES == _counted(tatt.LAUNCHES, flash_fwd_general=1,
                                     flash_bwd_general=1)
    o, *grads = outs["cuda"]
    o_cpu, *grads_cpu = outs["cpu"]
    assert o.dtype == dtype
    _assert_within(o.cpu(), o_cpu, o_tol, "o")
    for g, w in zip(grads, grads_cpu):
        _assert_within(g.cpu(), w, g_tol, "grad")


GENERAL_FWD = (("flash_fwd", tatt.flash_fwd_ref),
               ("flash_fwd_unfolded", tatt.flash_fwd_unfolded_ref),
               ("flash_fwd_stream",
                lambda q, k, v: tatt.flash_fwd_stream_ref(q, k, v, 512)))
GENERAL_BWD = (("flash_bwd", tatt.flash_bwd_ref),
               ("flash_bwd_twopass", tatt.flash_bwd_twopass_ref),
               ("flash_bwd_fold", tatt.flash_bwd_fold_ref))


def _general_variants(q, k, v, do):
    """Each general forward (K1, K5, K4) and backward (K2, K3, K6) entry on
    q, k, v, dO against its plain version on the same card inputs, within
    _general_tols, each counted on its route; each backward bitwise
    repeatable. Returns the outputs, forward then backward."""
    dtype = q.dtype
    o_tol, lse_tol, g_tol = _general_tols(dtype)
    outs = []
    for name, ref in GENERAL_FWD:
        tatt.reset_launch_counts()
        o, lse = getattr(tatt, f"{name}_general")(q, k, v)
        assert tatt.LAUNCHES == _counted(tatt.LAUNCHES,
                                         **{f"{name}_general": 1})
        o_ref, lse_ref = ref(q, k, v)
        assert o.dtype == dtype and o.shape == q.shape
        _assert_within(o, o_ref, o_tol, f"{name} o")
        err = (lse - lse_ref).abs().max().item()
        assert err <= lse_tol, f"{name} lse: {err:.3e} > {lse_tol:.3e}"
        outs += [o, lse]
    o, lse = tatt.flash_fwd_ref(q, k, v)
    for name, ref in GENERAL_BWD:
        kernel = getattr(tatt, f"{name}_general")
        got = kernel(q, k, v, o, lse, do)
        want = ref(q, k, v, o, lse, do)
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == dtype and g.shape == w.shape
            _assert_within(g, w, g_tol, f"{name} {what}")
        again = kernel(q, k, v, o, lse, do)
        assert all(torch.equal(g, a) for g, a in zip(got, again)), name
        outs += list(got)
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_cuda_flash_general_variants_match_plain(cuda, dtype):
    """Every general entry (_general_variants) at ragged lengths (sq 200,
    sk 300), head dim 72 (two head-dim chunks, the second ragged) and k, v
    sliced from one [B, S, 3, H, D] tensor (16-byte copies)."""
    b, sq, sk, h, d = 2, 200, 300, 3, 72
    q = _rand((b, sq, h, d), 0, 1.5, cuda, dtype)
    kv = _rand((b, sk, 3, h, d), 1, 1.5, cuda, dtype)
    do = _rand((b, sq, h, d), 2, 1.0, cuda, dtype)
    _general_variants(q, kv[:, :, 0], kv[:, :, 2], do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_general_wide_head_matches_plain(cuda, dtype):
    """Head dim 160 (SD-1.x's widest): three head-dim chunks, held whole by
    the forward, in two passes by the backward kernels; every entry
    within _general_tols."""
    b, sq, sk, h, d = 1, 200, 300, 2, 160
    q = _rand((b, sq, h, d), 0, 1.5, cuda, dtype)
    k, v = (_rand((b, sk, h, d), i, 1.5, cuda, dtype) for i in (1, 2))
    do = _rand((b, sq, h, d), 3, 1.0, cuda, dtype)
    _general_variants(q, k, v, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_general_misaligned_views_match_aligned(cuda, dtype):
    """q, k, v, dO as views whose base is one element off 16 bytes and
    whose head stride is odd (element loads) give the same bits as dense
    copies of the same values (16-byte copies), and both are within
    _general_tols of the plain versions."""
    b, sq, sk, h, d = 2, 130, 190, 3, 64
    qx = _rand((b, sq, 2, h, d + 1), 0, 1.5, cuda, dtype)
    kv = _rand((b, sk, 2, h, d + 1), 1, 1.5, cuda, dtype)
    views = (qx[:, :, 0, :, 1:], kv[:, :, 0, :, 1:], kv[:, :, 1, :, :d],
             qx[:, :, 1, :, :d])
    assert all(x.data_ptr() % 16 for x in views)
    misaligned = _general_variants(*views)
    dense = _general_variants(*(x.contiguous() for x in views))
    assert all(torch.equal(a, z) for a, z in zip(misaligned, dense))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", [n for n, _ in GENERAL_BWD])
def test_cuda_flash_general_backward_is_bitwise_repeatable(cuda, dtype,
                                                           name):
    """Each general backward mode (K2, K3, K6), free of atomics, gives the
    same bits on a second call, at a U-Net site's shape."""
    q, k, v, do = (_rand((1, 1024, 10, 64), i, 1.0, cuda, dtype)
                   for i in range(4))
    o, lse = tatt.flash_fwd_ref(q, k, v)
    kernel = getattr(tatt, f"{name}_general")
    first, second = (kernel(q, k, v, o, lse, do) for _ in range(2))
    assert all(torch.equal(a, z) for a, z in zip(first, second))


@pytest.mark.cuda
def test_cuda_fp16_calls_take_the_hopper_kernels(cuda):
    """fp16 at the kernels' shapes (head dim 64, channels multiples of 8)
    runs their fp16 instances: a flash call forward and backward, a K7
    conv and a K9 half, each counted on its kernel route and none on a
    general one, and agreeing with the same calls on the CPU (O 2**-7,
    gradients 2**-6, convs GN_RTOL of the largest value)."""
    f16 = torch.float16
    outs = {}
    for dev in ("cpu", cuda):
        q, k, v = (_rand((1, 512, 2, 64), i, 1.5, dev,
                         f16).requires_grad_(True) for i in range(3))
        x = _rand((1, 64, 16, 16), 3, 1.0, dev, f16).requires_grad_(True)
        w = _rand((96, 64, 3, 3), 4, 0.05, dev, f16)
        g, beta = _gn_params(96, dev, 5)
        w2 = _rand((64, 96, 3, 3), 6, 0.05, dev, f16)
        for mod in (tatt, tconv, tgc):
            mod.reset_launch_counts()
        o = tatt.dot_product_attention(q, k, v, use_flash=True)
        y = tconv.conv3x3(x, w)
        z = tgc.gn_silu_conv3x3(y, g, beta, w2, 32, 1e-5)
        (o.float().square().sum() + z.float().square().sum()).backward()
        outs[str(dev)] = (o, q.grad, k.grad, v.grad, y, z, x.grad)
    assert tatt.LAUNCHES == _counted(tatt.LAUNCHES, flash_fwd=1, flash_bwd=1)
    assert tconv.LAUNCHES == _counted(tconv.LAUNCHES, conv3x3_fwd=1,
                                      conv3x3_dx=1)
    assert tgc.LAUNCHES == _counted(tgc.LAUNCHES, gn_silu_conv3x3_fwd=1,
                                    gn_silu_conv3x3_dx=1)
    got, want = outs["cuda"], outs["cpu"]
    assert all(t.dtype == f16 for t in got)
    _assert_within(got[0].cpu(), want[0], 2.0 ** -7, "o")
    for i in (1, 2, 3):
        _assert_within(got[i].cpu(), want[i], 2.0 ** -6, "grad")
    for i, what in ((4, "y"), (5, "z"), (6, "dx")):
        _assert_within(got[i].cpu(), want[i], GN_RTOL, what)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("warpgroups,block_n", tconv.TILES)
def test_cuda_fp16_conv_instances_match_plain(cuda, warpgroups, block_n,
                                              splits):
    """Every fp16 K7 instance, whole and split, and K9 on it (forward and
    dx), against the plain versions on the same inputs (GN_RTOL)."""
    b, hw, ci, co = 2, 16, 128, 320
    x = _rand((b, ci, hw, hw), 0, 1.0, cuda, torch.float16)
    w = _rand((co, ci, 3, 3), 1, (9 * ci) ** -0.5, cuda, torch.float16)
    dy = _rand((b, co, hw, hw), 2, 1.0, cuda, torch.float16)
    g, beta = _gn_params(ci, cuda, 3)
    xl, wl, dyl = (tconv.to_kernel_layout(t) for t in (x, w, dy))
    fwd = tconv.fixed_plan(b, hw, hw, ci, co, warpgroups, block_n, splits)
    dxp = tconv.fixed_plan(b, hw, hw, co, ci, warpgroups, block_n, splits)
    y = tconv._launch("conv3x3_fwd", xl, wl, fwd)
    dx = tconv._launch("conv3x3_dx", dyl, wl, dxp)
    _assert_within(y, tconv.conv3x3_fwd_ref(x, w), GN_RTOL, "y")
    _assert_within(dx, tconv.conv3x3_dx_ref(dy, w, torch.float16), GN_RTOL,
                   "dx")
    y, mean, rsig = tgc._fwd_launch(xl, g, beta, wl, 32, 1e-5, fwd)
    y_ref, mean_ref, rsig_ref = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w,
                                                            32, 1e-5)
    _assert_close(y, y_ref, "k9 y")
    dxp = tconv.fixed_plan(b, hw, hw, co, ci, warpgroups, block_n, splits,
                           f32_out=True)
    dx = tgc._dx_launch(xl, g, beta, wl, mean_ref, rsig_ref, dyl, 32, dxp)
    _assert_close(dx, tgc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean_ref,
                                                 rsig_ref, dy, 32), "k9 dx")
    assert y.dtype == dx.dtype == torch.float16


@pytest.mark.cuda
@pytest.mark.parametrize("f32_sum", [False, True])
def test_cuda_fp16_flash_instances_match_plain(cuda, f32_sum):
    """The fp16 flash instances, forward (K1's row sum or the fp32 one)
    and backward (K2, K3, K6), at ragged lengths, against the plain
    versions on the same inputs: O 2**-7 and lse 2**-8 of the largest
    value, gradients 2**-6."""
    f16 = torch.float16
    q = _rand((2, 1000, 3, 64), 0, 1.5, cuda, f16)
    k, v = (_rand((2, 1500, 3, 64), i, 1.5, cuda, f16) for i in (1, 2))
    do = _rand((2, 1000, 3, 64), 3, 1.0, cuda, f16)
    kernel = (tatt.flash_fwd_unfolded_cuda if f32_sum
              else tatt.flash_fwd_cuda)
    plain = tatt.flash_fwd_unfolded_ref if f32_sum else tatt.flash_fwd_ref
    o, lse = kernel(q, k, v)
    o_ref, lse_ref = plain(q, k, v)
    assert o.dtype == f16
    _assert_within(o, o_ref, 2.0 ** -7, "o")
    _assert_within(lse, lse_ref, 2.0 ** -8, "lse")
    for name in ("flash_bwd", "flash_bwd_twopass", "flash_bwd_fold"):
        got = getattr(tatt, f"{name}_cuda")(q, k, v, o_ref, lse_ref, do)
        want = getattr(tatt, f"{name}_ref")(q, k, v, o_ref, lse_ref, do)
        for g_, w_, what in zip(got, want, ("dq", "dk", "dv")):
            assert g_.dtype == f16
            _assert_within(g_, w_, 2.0 ** -6, f"{name} {what}")


@pytest.mark.cuda
def test_cuda_conv_general_route_at_100_channels(cuda):
    """A conv of 100 -> 100 channels passes the gate but not the Hopper
    kernel's multiples of 8: forward and dx run the general kernel on the
    card, counted, and agree with the CPU (2**-7 of the largest value)."""
    assert tconv.conv3x3_ok((1, 16, 16, 100), (3, 3, 100, 100))
    outs = {}
    for dev in ("cpu", cuda):
        x = _rand((1, 100, 16, 16), 0, 1.0, dev,
                  torch.bfloat16).requires_grad_(True)
        w = _rand((100, 100, 3, 3), 1, 0.03, dev, torch.bfloat16)
        tconv.reset_launch_counts()
        y = tconv.conv3x3(x, w)
        y.float().square().sum().backward()
        outs[str(dev)] = (y, x.grad)
    assert tconv.LAUNCHES == _counted(tconv.LAUNCHES, conv3x3_fwd_general=1,
                                      conv3x3_dx_general=1)
    for got, want, what in zip(outs["cuda"], outs["cpu"], ("y", "dx")):
        _assert_within(got.cpu(), want, GN_RTOL, what)


def _conv_general_rtol(dtype):
    """The general conv's tolerance in `dtype`: fp32's (its 3xTF32
    products), else the half dtypes' one rounding (GN_RTOL)."""
    return F32_CONV_RTOL if dtype == torch.float32 else GN_RTOL


def _conv_general_case(cuda, dtype, b, hw, ci, co, plan=None):
    """The general conv kernel's forward and dx (with `plan`, or the
    planner's) on NCHW inputs, held to the plain versions on the same card
    inputs; its outputs are channels-last in x's dtype. Returns dx and a
    second dx from the same call."""
    x = _rand((b, ci, hw, hw), 0, 1.0, cuda, dtype)
    w = _rand((co, ci, 3, 3), 1, (9 * ci) ** -0.5, cuda, dtype)
    dy = _rand((b, co, hw, hw), 2, 1.0, cuda, dtype)
    if plan is None:
        def fwd():
            return tconv.conv3x3_fwd_general(x, w)

        def dxf():
            return tconv.conv3x3_dx_general(dy, w, dtype)
    else:
        fplan = tconv.general_fixed_plan(b, hw, hw, ci, co, *plan)
        dplan = tconv.general_fixed_plan(b, hw, hw, co, ci, *plan)

        def fwd():
            return tconv._general_launch("conv3x3_fwd", x, w, dtype, fplan)

        def dxf():
            return tconv._general_launch("conv3x3_dx", dy, w, dtype, dplan)
    y, dx = fwd(), dxf()
    for got, want, what in ((y, tconv.conv3x3_fwd_ref(x, w), "y"),
                            (dx, tconv.conv3x3_dx_ref(dy, w, dtype), "dx")):
        assert got.dtype == dtype and tconv.in_kernel_layout(got)
        _assert_within(got, want, _conv_general_rtol(dtype), what)
    return dx, dxf()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("b,hw,ci,co", [(2, 8, 1280, 640), (1, 20, 72, 100)])
def test_cuda_conv_general_kernel_matches_plain(cuda, dtype, b, hw, ci, co):
    """The general conv kernel, forward and dx, in fp32 and fp16 on NCHW
    inputs, against the plain versions on the same card inputs (fp32
    2**-14 of the largest value, which one TF32 pass misses; fp16
    GN_RTOL); its outputs are channels-last in x's dtype."""
    _conv_general_case(cuda, dtype, b, hw, ci, co)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("hw,ci,co", [(8, 2560, 1280), (16, 1920, 1280),
                                      (64, 320, 320)])
def test_cuda_conv_general_deep_sites_match_plain(cuda, b, hw, ci, co):
    """fp32 at the U-Net's deepest K (8x8 2560 -> 1280: 23040 terms; 16x16
    1920 -> 1280) and its largest site, forward and dx, within 2**-14 of
    the largest value: the fresh accumulator a K step keeps the tensor
    cores' truncating adds from drifting over K. dx is bitwise
    repeatable (its K splits are summed in a fixed order)."""
    dx, again = _conv_general_case(cuda, torch.float32, b, hw, ci, co)
    assert torch.equal(dx, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("warpgroups,block_n", tconv.GENERAL_TILES)
def test_cuda_conv_general_every_instance_matches_plain(cuda, dtype, splits,
                                                        warpgroups,
                                                        block_n):
    """Every tile the general kernel builds, whole and split over K, fp32
    and bf16, at ragged channels (100 -> 36: element loads, N and K tails)
    and at aligned ones (96 -> 200: cp.async), forward and dx; dx is
    bitwise repeatable."""
    for b, hw, ci, co in ((2, 12, 100, 36), (1, 10, 96, 200)):
        dx, again = _conv_general_case(cuda, dtype, b, hw, ci, co,
                                       (warpgroups, block_n, splits))
        assert torch.equal(dx, again), (b, hw, ci, co)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_cuda_gn_general_routes(cuda, dtype):
    """fp32 and fp16 GroupNorm+SiLU (K8's op) at U-Net shapes runs its
    general instances on the card, counted, forward and backward; GN+SiLU+
    conv (K9's op) its general instances in fp32 and its Hopper kernels'
    fp16 instances in fp16; all agree with the CPU (K8's h GN_RTOL of the
    largest value; K9's y and dx 2**-14 in fp32, GN_RTOL in fp16)."""
    outs = {}
    for dev in ("cpu", cuda):
        x = _rand((1, 320, 16, 16), 0, 1.5, dev,
                  dtype).requires_grad_(True)
        g, beta = _gn_params(320, dev, 1)
        w = _rand((640, 320, 3, 3), 2, (9 * 320) ** -0.5, dev, dtype)
        tgn.reset_launch_counts()
        tgc.reset_launch_counts()
        h = tgn.gn_silu(x, g, beta, 32, 1e-6, True, dtype)
        y = tgc.gn_silu_conv3x3(h, g, beta, w, 32, 1e-5)
        y.float().square().sum().backward()
        outs[str(dev)] = (h, y, x.grad)
    assert tgn.LAUNCHES == _counted(tgn.LAUNCHES, gn_silu_fwd_general=1,
                                    gn_silu_bwd_general=1)
    k9 = "" if dtype == torch.float16 else "_general"
    assert tgc.LAUNCHES == _counted(tgc.LAUNCHES,
                                    **{f"gn_silu_conv3x3_fwd{k9}": 1,
                                       f"gn_silu_conv3x3_dx{k9}": 1})
    rtols = (GN_RTOL, _conv_general_rtol(dtype), _conv_general_rtol(dtype))
    for got, want, what, rtol in zip(outs["cuda"], outs["cpu"],
                                     ("h", "y", "dx"), rtols):
        assert got.dtype == dtype
        _assert_within(got.cpu(), want, rtol, what)


@pytest.mark.cuda
def test_cuda_gn_conv_general_at_ragged_channels(cuda):
    """K9's op at 100 -> 36 channels (4 groups): its general instances in
    bf16, forward and dx, against the plain versions on the same inputs
    (GN_RTOL); dx is bitwise repeatable."""
    x = _rand((2, 100, 12, 12), 0, 1.5, cuda, torch.bfloat16)
    w = _rand((36, 100, 3, 3), 1, 0.03, cuda, torch.bfloat16)
    dy = _rand((2, 36, 12, 12), 2, 1.0, cuda, torch.bfloat16)
    g, beta = _gn_params(100, cuda, 3)
    assert tgc.gn_conv_route(cuda, torch.bfloat16, 100, 36) == "general"
    y, mean, rsig = tgc.gn_silu_conv3x3_fwd_general(x, g, beta, w, 4, 1e-5)
    y_ref, mean_ref, rsig_ref = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, 4,
                                                            1e-5)
    _assert_close(y, y_ref, "y")
    _assert_close(mean, mean_ref, "mean")
    _assert_close(rsig, rsig_ref, "rsig")
    dx = tgc.gn_silu_conv3x3_dx_general(x, g, beta, w, mean, rsig, dy, 4)
    again = tgc.gn_silu_conv3x3_dx_general(x, g, beta, w, mean, rsig, dy, 4)
    assert torch.equal(dx, again)
    _assert_close(dx, tgc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean, rsig,
                                                 dy, 4), "dx")


def _gn_conv_inputs(b, hw, ci, co, device, seed=0):
    x = _rand((b, ci, hw, hw), seed, 1.5, device, torch.bfloat16)
    w = _rand((co, ci, 3, 3), seed + 1, (9 * ci) ** -0.5, device,
              torch.bfloat16)
    dy = _rand((b, co, hw, hw), seed + 2, 1.0, device, torch.bfloat16)
    g, beta = _gn_params(ci, device, seed + 3)
    return x, w, dy, g, beta


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("warpgroups,block_n", tconv.TILES)
def test_cuda_gn_conv_every_instance_matches_plain(cuda, warpgroups, block_n,
                                                   splits):
    """K9 forward and dx on each K7 instance (consumer warpgroups x N
    tile), whole and split-K, forced through a fixed plan, against the
    plain versions; 640 output channels leave a ragged N tile at 128 and
    256, and 10 channels a group straddle the prologue's 8-channel
    vectors."""
    b, hw, ci, co, groups = 2, 16, 320, 640, 32
    x, w, dy, g, beta = _gn_conv_inputs(b, hw, ci, co, cuda)
    xl, wl, dyl = (tconv.to_kernel_layout(t) for t in (x, w, dy))
    fwd = tconv.fixed_plan(b, hw, hw, ci, co, warpgroups, block_n, splits)
    bwd = tconv.fixed_plan(b, hw, hw, co, ci, warpgroups, block_n, splits,
                           f32_out=True)
    y, mean, rsig = tgc._fwd_launch(xl, g, beta, wl, groups, 1e-5, fwd)
    y_ref, mean_ref, rsig_ref = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w,
                                                            groups, 1e-5)
    _assert_close(y, y_ref, "y")
    _assert_close(rsig, rsig_ref, "rsig")
    dx = tgc._dx_launch(xl, g, beta, wl, mean_ref, rsig_ref, dyl, groups,
                        bwd)
    _assert_close(dx, tgc.gn_silu_conv3x3_dx_ref(x, g, beta, w, mean_ref,
                                                 rsig_ref, dy, groups), "dx")
    assert tconv.in_kernel_layout(y) and tconv.in_kernel_layout(dx)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,ci,co", [(1, 64, 320, 320),
                                        (2, 8, 1280, 1280)])
def test_cuda_gn_conv_dx_is_bitwise_repeatable(cuda, b, hw, ci, co):
    """dx sums its splits, its slots and its groups in a fixed order (no
    atomics): two calls give the same bits, with the planner's plan (whole
    at 64x64, split at 8x8) and with a forced split of 6."""
    x, w, dy, g, beta = _gn_conv_inputs(b, hw, ci, co, cuda)
    xl, wl, dyl = (tconv.to_kernel_layout(t) for t in (x, w, dy))
    _, mean, rsig = tgc.gn_silu_conv3x3_fwd_ref(x, g, beta, w, 32, 1e-5)
    forced = tconv.fixed_plan(b, hw, hw, co, ci, 2, 128, 6, f32_out=True)
    for plan in (None, forced):
        runs = [tgc._dx_launch(xl, g, beta, wl, mean, rsig, dyl, 32, plan)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        _assert_close(runs[0], tgc.gn_silu_conv3x3_dx_ref(
            x, g, beta, w, mean, rsig, dy, 32), "dx")


@pytest.mark.cuda
def test_cuda_gn_conv_nchw_and_channels_last_inputs_agree(cuda):
    """An NCHW x, w or dy is copied to channels-last (counted in
    LAYOUT_COPIES), never read through the wrong strides: the results are
    the channels-last inputs' bit for bit, and channels-last either way."""
    x, w, dy, g, beta = _gn_conv_inputs(2, 32, 320, 640, cuda)
    xl, wl, dyl = (tconv.to_kernel_layout(t) for t in (x, w, dy))
    before = tgc.LAYOUT_COPIES["gn_conv"]
    y_l, mean, rsig = tgc.gn_silu_conv3x3_fwd_cuda(xl, g, beta, wl, 32, 1e-5)
    dx_l = tgc.gn_silu_conv3x3_dx_cuda(xl, g, beta, wl, mean, rsig, dyl, 32)
    assert tgc.LAYOUT_COPIES["gn_conv"] == before
    y_n, mean_n, rsig_n = tgc.gn_silu_conv3x3_fwd_cuda(x, g, beta, w, 32,
                                                       1e-5)
    dx_n = tgc.gn_silu_conv3x3_dx_cuda(x, g, beta, w, mean, rsig, dy, 32)
    assert tgc.LAYOUT_COPIES["gn_conv"] == before + 5
    assert torch.equal(y_n, y_l) and torch.equal(dx_n, dx_l)
    assert torch.equal(mean_n, mean) and torch.equal(rsig_n, rsig)
    assert all(tconv.in_kernel_layout(t) for t in (y_n, y_l, dx_n, dx_l))
    # a channels-last channel slice (a concat's gradient) is not dense:
    # copied, not read through its strides
    wide = tconv.to_kernel_layout(torch.cat([dy, dy], dim=1))[:, :640]
    dx_s = tgc.gn_silu_conv3x3_dx_cuda(xl, g, beta, wl, mean, rsig, wide, 32)
    assert tgc.LAYOUT_COPIES["gn_conv"] == before + 6
    assert torch.equal(dx_s, dx_l)
