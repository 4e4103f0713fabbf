"""The foreground guidance term's slot order and its kernel pair (no JAX).

On the CPU: `guidance.fg_slot_order` on both correspondence paths (host
[N, 4] rows and device binning) and at their edges, and the kernel route
of `guidance.foreground_loss_apply` run with the kernel pair's formulas,
written here in plain PyTorch over the slot order, against autograd of the
plain route. On a machine with an NVIDIA GPU (tests marked `cuda`; they
skip elsewhere): the kernel pair against autograd of the plain expression
at SD-2's and SDXL's term shapes, its bits over two runs, and its capture
in a CUDA graph. This file imports nothing of JAX, so it also runs on the
GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_port_fg_loss.py
"""

import contextlib

import numpy as np
import pytest
import torch

from diffusionhandles_tpu_torch import guidance
from diffusionhandles_tpu_torch.ops import fg_loss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _host_pc(rows, img_res, latent_res, max_corr, device="cpu"):
    return guidance.process_correspondences(
        np.asarray(rows, np.int64).reshape(-1, 4), img_res,
        max_corr=max_corr, latent_res=latent_res, device=device)


def _rows(n, img_res, seed, spread=6):
    """Random rows around a box foreground, some transformed pixels
    outside the image."""
    rng = np.random.RandomState(seed)
    o = rng.randint(img_res // 4, 3 * img_res // 4, (n, 2))
    t = np.clip(o + rng.randint(-spread, spread + 1, (n, 2)), -3,
                img_res + 2)
    return np.concatenate([o, t], 1)


def _device_pc(u, v, fg, img_res, latent_res, max_corr):
    n = img_res * img_res
    return guidance.process_correspondences_device(
        torch.as_tensor(u), torch.as_tensor(v), torch.ones(n, dtype=bool),
        torch.ones((img_res, img_res), dtype=bool), torch.as_tensor(fg),
        img_res, max_corr=max_corr, latent_res=latent_res)


def _slot_case(path, case):
    """(pc, latent_res) of one correspondence path at one edge."""
    res, lat = 32, 8
    max_corr = 16 if case == "truncated" else 1024
    if path == "host":
        rows = {"realistic": _rows(300, res, 0),
                "empty": np.zeros((0, 4)),
                "one_cell": np.concatenate(
                    [_rows(200, res, 1)[:, :2],
                     np.full((200, 2), 5)], 1),
                "truncated": _rows(300, res, 2)}[case]
        warns = (pytest.warns(UserWarning, match="truncating")
                 if case == "truncated" else contextlib.nullcontext())
        with warns:
            return _host_pc(rows, res, lat, max_corr), lat
    rng = np.random.RandomState(3)
    n = res * res
    fg = np.zeros((res, res), np.float32)
    if case != "empty":
        fg[4:28, 4:28] = 1.0
    idx = np.arange(n)
    if case == "one_cell":
        u = v = np.full(n, 5)
    else:
        u = np.clip(idx % res + rng.randint(-6, 7, n), 0, res - 1)
        v = np.clip(idx // res + rng.randint(-6, 7, n), 0, res - 1)
    return _device_pc(u, v, fg, res, lat, max_corr), lat


@pytest.mark.parametrize("path", ["host", "device"])
@pytest.mark.parametrize("case", ["realistic", "empty", "one_cell",
                                  "truncated"])
def test_slot_order(path, case):
    """The live slots sorted stably by transformed cell, each cell's run
    at its offsets, fixed sizes, the empty slots last with weight 0."""
    pc, lat = _slot_case(path, case)
    order = guidance.fg_slot_order(pc, (lat, lat))
    max_corr = pc.corr_w.numel()
    w = pc.corr_w.numpy()
    cell = (pc.corr_ty * lat + pc.corr_tx).numpy()
    live = [s for s in range(max_corr) if w[s] > 0]
    want = sorted(live, key=lambda s: (cell[s], s))
    n = len(want)
    assert {"empty": n == 0, "one_cell": len(set(cell[live])) == 1,
            "truncated": n == max_corr,
            "realistic": 0 < n < max_corr}[case]
    assert order.slots.shape == order.cells.shape == (max_corr,)
    assert order.weights.shape == (max_corr,)
    assert order.offsets.shape == (lat * lat + 1,)
    assert order.cells.dtype == order.offsets.dtype == torch.int32
    assert order.slots[:n].tolist() == want
    assert sorted(order.slots.tolist()) == list(range(max_corr))
    assert order.cells[:n].tolist() == cell[want].tolist()
    assert order.weights[:n].tolist() == w[want].tolist()
    assert not order.weights[n:].any() and not order.cells[n:].any()
    offsets = order.offsets.tolist()
    assert offsets[0] == 0 and offsets[-1] == n
    for k in range(lat * lat):
        assert order.cells[offsets[k]:offsets[k + 1]].tolist() == \
            [k] * (offsets[k + 1] - offsets[k])


class _SlotFormulas(torch.autograd.Function):
    """The kernel pair's arithmetic in plain PyTorch over the slot order:
    S[c] = sum_s w_s |f1[c, s] - f2[c, k_s]|, and grad_f2[c, k] = -g[c] *
    sum over cell k's slots of w_s sign(f1[c, s] - f2[c, k]) (integer
    weights: the run's sum is exact, as the kernel's fp32 sum is)."""

    @staticmethod
    def forward(ctx, f2, f1, cells, weights, offsets):
        ctx.save_for_backward(f2, f1, cells, weights, offsets)
        c = f2.shape[0]
        at = f2.reshape(c, -1)[:, cells.long()]
        return (weights * (f1 - at).abs()).sum(1)

    @staticmethod
    def backward(ctx, g):
        f2, f1, cells, weights, offsets = ctx.saved_tensors
        c, hw = f2.shape[0], f2[0].numel()
        n = int(offsets[-1])
        at = f2.reshape(c, -1)[:, cells[:n].long()]
        terms = weights[:n] * torch.sign(f1[:, :n] - at)
        runs = torch.zeros(c, hw, dtype=torch.float64).index_add_(
            1, cells[:n].long(), terms.double())
        return (-g[:, None] * runs.float()).reshape(f2.shape), None, None, \
            None, None


# Scaled-down term shapes: (channels, activation side) per recorded stack
# on a latent grid of side L; SD-2 records three stacks, SDXL two.
TERMS = {"sd2": (16, [(64, 4), (32, 8), (16, 16)]),
         "sdxl": (32, [(64, 16), (32, 32)])}


@pytest.mark.parametrize("model,stack", [("sd2", 0), ("sd2", 1),
                                         ("sd2", 2), ("sdxl", 0),
                                         ("sdxl", 1)])
@pytest.mark.parametrize("patch", [1, 3])
def test_kernel_route_formulas_match_plain_autograd(monkeypatch, model,
                                                    stack, patch):
    """The kernel route of foreground_loss (the slot layout of the orig
    features, the order carried in the precompute, the division and the
    mean) with the formulas above in place of the kernel pair, against the
    plain route's loss and its gradient to the activations, on
    correspondences whose slots are mostly empty. Both routes
    count their applications in FG_LOSS_CALLS."""
    lat, stacks = TERMS[model]
    ch, side = stacks[stack]
    res = 4 * lat
    max_corr = 4 * lat * lat
    pc = _host_pc(_rows(max_corr // 4, res, stack + 10 * patch, spread=9),
                  res, lat, max_corr)
    live = int((pc.corr_w > 0).sum())
    assert 0.05 * max_corr < live < 0.3 * max_corr
    gen = torch.Generator().manual_seed(stack)
    orig, cur = (torch.randn(ch, side, side, generator=gen)
                 for _ in range(2))
    size = (lat, lat)

    def loss_and_grad():
        act = cur.clone().requires_grad_(True)
        loss = guidance.foreground_loss(act, orig, pc, patch, size)
        return loss.detach(), torch.autograd.grad(loss, act)[0]

    before = dict(guidance.FG_LOSS_CALLS)
    want, want_grad = loss_and_grad()
    assert guidance.FG_LOSS_CALLS["plain"] == before["plain"] + 1
    monkeypatch.setattr(guidance, "route", lambda device, takes: "kernel")
    monkeypatch.setattr(guidance, "fg_l1", _SlotFormulas.apply)
    got, got_grad = loss_and_grad()
    assert guidance.FG_LOSS_CALLS["kernel"] == before["kernel"] + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    # the formula's runs are exact sums; autograd's index_put sums each
    # run's terms one rounding at a time
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-5,
                               atol=1e-6 * want_grad.abs().max().item())


def test_kernel_refuses_cpu_tensors():
    """The card's route takes CUDA tensors only; the CPU has the plain
    route."""
    f2 = torch.zeros(4, 2, 2)
    cells = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fg_loss.fg_l1(f2, torch.zeros(4, 3), cells, torch.zeros(3),
                      torch.zeros(5, dtype=torch.int32))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# (channels, latent side) of each recorded stack's term at the real widths
CARD_TERMS = [("sd2", 1280, 64), ("sd2", 640, 64), ("sd2", 320, 64),
              ("sdxl", 1280, 128), ("sdxl", 640, 128)]


def _card_term(dev, ch, lat, seed, max_corr=16384):
    """(pc, the orig features [C, L, L] pooled, f2) on the card: a box
    foreground of about a fifth of the image moved by up to 9 pixels, so
    most of the 16384 slots stay empty."""
    res = 8 * lat
    pc = _host_pc(_rows(max_corr // 3, res, seed, spread=9), res, lat,
                  max_corr, dev)
    gen = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn(ch, lat, lat, generator=gen).to(dev)
              for _ in range(2))
    return pc, f1, f2


def _plain_term(pc, f1, f2):
    """Autograd of the plain expression: (S [C], grad_f2 of sum(S * g))."""
    f2 = f2.clone().requires_grad_(True)
    g = torch.linspace(0.5, 1.5, f2.shape[0], device=f2.device)
    d = (f1[:, pc.corr_oy, pc.corr_ox].T - f2[:, pc.corr_ty, pc.corr_tx].T)
    s = (d.abs() * pc.corr_w[:, None]).sum(0)
    return s.detach(), torch.autograd.grad(s, f2, g)[0], g


def _kernel_term(pc, f1, f2, order, g):
    f2 = f2.clone().requires_grad_(True)
    f1s = f1[:, pc.corr_oy[order.slots], pc.corr_ox[order.slots]]
    s = fg_loss.fg_l1(f2, f1s.contiguous(), order.cells, order.weights,
                      order.offsets)
    return s.detach(), torch.autograd.grad(s, f2, g)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("model,ch,lat", CARD_TERMS)
def test_cuda_kernel_pair_matches_autograd(cuda, model, ch, lat):
    """Forward within 1e-6 relative of autograd's; gradient within fp32
    rounding of autograd's index_put (rtol 1e-5, atol 1e-6 of its
    largest element: autograd rounds each term of a cell's run, the kernel
    sums the run's integer weights exactly and rounds once); the same bits
    over two runs."""
    pc, f1, f2 = _card_term(cuda, ch, lat, seed=ch + lat)
    order = guidance.fg_slot_order(pc, (lat, lat))
    live = int(order.offsets[-1])
    assert 0 < live < 16384 // 2
    want, want_grad, g = _plain_term(pc, f1, f2)
    fg_loss.reset_launch_counts()
    got, got_grad = _kernel_term(pc, f1, f2, order, g)
    assert fg_loss.LAUNCHES == {"fg_l1_fwd": 1, "fg_l1_bwd": 1}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-5,
                               atol=1e-6 * want_grad.abs().max().item())
    again, again_grad = _kernel_term(pc, f1, f2, order, g)
    assert torch.equal(again, got) and torch.equal(again_grad, got_grad)


@pytest.mark.cuda
def test_cuda_kernel_pair_in_a_graph(cuda):
    """Forward and backward captured in a CUDA graph replay the eager
    result, bit for bit, on new values in the captured f2."""
    pc, f1, f2 = _card_term(cuda, 640, 64, seed=5)
    order = guidance.fg_slot_order(pc, (64, 64))
    f1s = f1[:, pc.corr_oy[order.slots], pc.corr_ox[order.slots]]
    f1s = f1s.contiguous()
    static = f2.clone().requires_grad_(True)

    def step():
        s = fg_loss.fg_l1(static, f1s, order.cells, order.weights,
                          order.offsets)
        loss = s.mean()
        return loss, torch.autograd.grad(loss, static)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss_g, grad_g = step()
    new = torch.randn_like(f2)
    with torch.no_grad():
        static.copy_(new)
    graph.replay()
    torch.cuda.synchronize()
    with torch.no_grad():
        static.copy_(new)
    loss_e, grad_e = step()
    assert torch.equal(loss_g, loss_e) and torch.equal(grad_g, grad_e)
