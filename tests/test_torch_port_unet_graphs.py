"""The U-Net's CUDA-graph replay (`models/unet_graphs.py`).

On the CPU: which path a call takes, as a pure function of what the code
observes (the device, `capture_attention`, hooks, tensor-parallel layers,
remat, trainable parameters, a signature seen before), the signature's
key, what the U-Net observes of itself, and that CPU calls run eagerly.
On a machine with an NVIDIA GPU (tests marked `cuda`; they skip
elsewhere): replayed calls against eager ones on the tiny U-Net and at
SD-2's widths on the default and the fused routes. This file imports
nothing of JAX, so it also runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_port_unet_graphs.py
"""

import functools

import pytest
import torch

from diffusionhandles_tpu_torch.models import unet as tunet
from diffusionhandles_tpu_torch.models import unet_graphs
from diffusionhandles_tpu_torch.ops import attention as tatt
from diffusionhandles_tpu_torch.ops import conv as tconv
from diffusionhandles_tpu_torch.ops import gn_conv as tgc
from diffusionhandles_tpu_torch.ops import groupnorm as tgn
from diffusionhandles_tpu_torch.parallel import sharding

# a call that could replay: on CUDA, nothing in the way, its graphs ready
_REPLAYABLE = dict(cuda=True, capture_attention=False, hooked=False,
                   tensor_parallel=False, remat=False, trainable=False,
                   seen=True, captured=True, pending=False)


@pytest.mark.parametrize("change, want", [
    ({}, "replay"),
    ({"cuda": False}, "eager"),
    ({"capture_attention": True}, "eager"),
    ({"hooked": True}, "eager"),
    ({"tensor_parallel": True}, "eager"),
    ({"remat": True}, "eager"),
    ({"remat": "dots"}, "eager"),
    ({"trainable": True}, "eager"),
    ({"seen": False, "captured": False}, "eager"),   # a first call
    ({"captured": False}, "capture"),                # the second
    ({"pending": True}, "eager"),  # a forward whose backward has not run
    ({"cuda": False, "seen": False, "captured": False}, "eager"),
    ({"hooked": True, "captured": False}, "eager"),
], ids=lambda v: str(v) if isinstance(v, str) else
   "-".join(f"{k}={x}" for k, x in v.items()) or "replayable")
def test_mode(change, want):
    assert unet_graphs.mode(**{**_REPLAYABLE, **change}) == want


def test_signature_separates_batch_grad_and_capture():
    x1, x2 = torch.zeros(1, 5, 8, 8), torch.zeros(2, 5, 8, 8)
    t = torch.tensor(7)
    c1, c2 = torch.zeros(1, 77, 32), torch.zeros(2, 77, 32)
    sig = unet_graphs.signature
    with torch.no_grad():
        fwd1 = sig(x1, t, c1, False)
        assert fwd1 == sig(x1.clone(), torch.tensor(9), c1.clone(), False)
        assert fwd1 != sig(x2, t, c2, False)
        assert fwd1 != sig(x1, t, c1, True)
        assert fwd1 != sig(x1, t.float(), c1, False)
    x1g = x1.clone().requires_grad_(True)
    c1g = c1.clone().requires_grad_(True)
    to_latents = sig(x1g, t, c1, False)
    to_context = sig(x1, t, c1g, False)
    assert len({fwd1, to_latents, to_context, sig(x1, t, c1, False)}) == 4
    with torch.no_grad():  # no grad mode: requires_grad does not count
        assert sig(x1g, t, c1g, False) == fwd1


@pytest.fixture(scope="module", autouse=True)
def torch_on_one_thread():
    """The tiny U-Net's ops are too small to share out: under the suite's
    parallel workers a multi-threaded CPU forward oversubscribes the
    cores (0.7 s alone, 29 s there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    return tunet.UNet2DConditionModel(tunet.tiny_unet_config()).eval()


def _inputs(b=1, seed=0, device="cpu", dtype=torch.float32, res=8,
            ctx_dim=32):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, 5, res, res, generator=gen).to(device, dtype)
    ctx = torch.randn(b, 77, ctx_dim, generator=gen).to(device, dtype)
    return x, torch.tensor(500, device=device), ctx


def test_observe_hooks_sharding_and_trainable(tiny):
    graphs = unet_graphs.UNetGraphs()
    tiny.requires_grad_(False)
    assert graphs._observe(tiny) == (False, False, False)
    # a hook on the U-Net itself runs around the replay: not in the way
    top = tiny.register_forward_hook(lambda *a: None)
    assert graphs._observe(tiny) == (False, False, False)
    top.remove()
    for register in ("register_forward_hook", "register_forward_pre_hook",
                     "register_full_backward_hook"):
        h = getattr(tiny.up_blocks[1], register)(lambda *a: None)
        assert graphs._observe(tiny)[0], register
        h.remove()
        assert not graphs._observe(tiny)[0]
    h = torch.nn.modules.module.register_module_forward_hook(
        lambda *a: None)
    assert graphs._observe(tiny)[0]
    h.remove()
    tiny.requires_grad_(True)
    assert graphs._observe(tiny)[2]
    with torch.no_grad():
        assert not graphs._observe(tiny)[2]
    tiny.requires_grad_(False)
    other = tunet.UNet2DConditionModel(tunet.tiny_unet_config())
    ff = other.down_blocks[0].attentions[0].transformer_blocks[0].ff
    sharding._swap(ff, sharding.TPFeedForward, None)
    assert unet_graphs.UNetGraphs()._observe(other)[1]


def test_cpu_calls_run_eagerly(tiny):
    """CPU calls take the eager forward, counted as such, with its results
    bitwise; no signature is recorded."""
    x, t, ctx = _inputs(2)
    before = dict(tunet.GRAPH_CALLS)
    with torch.no_grad():
        outs = [tiny(x, t, ctx) for _ in range(3)]
        want = tiny._forward(x, t, ctx, False)
    assert tunet.GRAPH_CALLS["eager"] - before["eager"] == 3
    assert tunet.GRAPH_CALLS["capture"] == before["capture"]
    assert tunet.GRAPH_CALLS["replay"] == before["replay"]
    assert tunet.GRAPH_CALLS is unet_graphs.GRAPH_CALLS
    for eps, acts, attn in outs:
        assert attn is None and torch.equal(eps, want[0])
        assert all(torch.equal(a, b) for a, b in zip(acts, want[1]))
    assert not tiny._graphs.seen and not tiny._graphs.graphs


def test_conversions_drop_the_graphs(tiny):
    """The graphs read the parameters in place: `.to` and
    `load_state_dict`, which may put other tensors in their place, drop
    them."""
    u = tunet.UNet2DConditionModel(tunet.tiny_unet_config())
    u._graphs.seen.add("key")
    u.to(torch.float32)
    assert not u._graphs.seen
    u._graphs.seen.add("key")
    u.load_state_dict(tiny.state_dict())
    assert not u._graphs.seen


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    # the fp32 convolutions (the tiny U-Net's, conv_out) in full fp32
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = allow


_SD2 = dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16,
            flash_attention=True)
CONFIGS = {
    "tiny": lambda: tunet.tiny_unet_config(),
    "sd2": lambda: tunet.UNetConfig(**_SD2),
    "sd2-fused": lambda: tunet.UNetConfig(**_SD2, fused_gn=True,
                                          fused_gn_conv=True),
}


@functools.lru_cache(maxsize=None)
def _built(kind: str):
    torch.manual_seed(0)
    with torch.device("cuda"):
        return tunet.UNet2DConditionModel(CONFIGS[kind]()).eval(
        ).requires_grad_(False)


def _unet(kind: str):
    """A U-Net of `kind` on the card, its graphs dropped."""
    u = _built(kind)
    u._graphs = unet_graphs.UNetGraphs()
    return u


def _card_inputs(kind, b=1, seed=0):
    cfg = CONFIGS[kind]()
    return _inputs(b, seed, "cuda", torch.float32, cfg.sample_size,
                   cfg.cross_attention_dim)


def _calls(before):
    return {k: n - before[k] for k, n in tunet.GRAPH_CALLS.items()}


def _equal(got, want, what):
    assert got.shape == want.shape and torch.equal(got, want), (
        what, (got.float() - want.float()).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kind, b", [("tiny", 1), ("tiny", 2), ("sd2", 1),
                                     ("sd2", 2), ("sd2-fused", 1)])
def test_forward_replay_matches_eager(cuda, kind, b):
    """Forward-only calls: eager, capture, then replays, each bitwise the
    eager forward on its own inputs; a replay's outputs are its own (the
    next replay leaves them as they were)."""
    u = _unet(kind)
    inputs = [_card_inputs(kind, b, s) for s in range(4)]
    before = dict(tunet.GRAPH_CALLS)
    with torch.no_grad():
        got = [u(*x) for x in inputs]
        want = [u._forward(*x, False) for x in inputs]
    assert _calls(before) == {"eager": 1, "capture": 1, "replay": 2}
    for i, ((eps, acts, attn), (weps, wacts, _)) in enumerate(
            zip(got, want)):
        assert attn is None
        _equal(eps, weps, f"eps {i}")
        for k, (a, w) in enumerate(zip(acts, wacts)):
            _equal(a, w, f"act {k} of call {i}")


def _grad_call(u, x, t, ctx, target, weights):
    """The loops' use of a call that records a graph: the guidance energy's
    gradient to the latents, or the null-text loss's to the context.
    Returns (eps, acts, gradient)."""
    lat = x[:, :4].detach().requires_grad_(target == "latents")
    c = ctx.detach().requires_grad_(target == "context")
    with torch.enable_grad():
        sample = torch.cat([lat, x[:, 4:]], dim=1)
        eps, acts, _ = u(sample, t, c)
        if target == "latents":
            loss = sum((a * w).sum() for a, w in zip(acts, weights))
        else:
            loss = ((eps - weights[0]) ** 2).mean()
        (grad,) = torch.autograd.grad(loss, lat if target == "latents"
                                      else c)
    return eps.detach(), [a.detach() for a in acts], grad


def _weights(u, x, t, ctx):
    with torch.no_grad():
        eps, acts, _ = u._forward(x, t, ctx, False)
    gen = torch.Generator(device="cuda").manual_seed(3)
    return [torch.randn(a.shape, generator=gen, device="cuda")
            for a in (eps, *acts)]


class _Eager:
    """The U-Net's eager forward as a callable."""

    def __init__(self, u):
        self.u = u

    def __call__(self, *args):
        return self.u._forward(*args, False)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, target", [
    ("tiny", "latents"), ("tiny", "context"), ("sd2", "latents"),
    ("sd2", "context"), ("sd2-fused", "latents")])
def test_grad_replay_matches_eager(cuda, kind, target, monkeypatch):
    """Calls that record a graph, each followed by its backward: eager,
    capture, replays; outputs and the gradient to the latents or to the
    text context bitwise the eager U-Net's. The tiny fp32 U-Net takes
    cuDNN's deterministic algorithms: its eager backward otherwise differs
    from itself run to run (by 1.5e-4 in the gradient to the latents), and
    could not be the yardstick bit for bit."""
    if kind == "tiny":
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    u = _unet(kind)
    inputs = [_card_inputs(kind, 1, s) for s in range(4)]
    w = _weights(u, *inputs[0])
    weights = w[1:] if target == "latents" else w[:1]
    before = dict(tunet.GRAPH_CALLS)
    got = [_grad_call(u, *x, target, weights) for x in inputs]
    assert _calls(before) == {"eager": 1, "capture": 1, "replay": 2}
    for i, x in enumerate(inputs):
        want = _grad_call(_Eager(u), *x, target, weights)
        _equal(got[i][0], want[0], f"eps {i}")
        for k, (a, b) in enumerate(zip(got[i][1], want[1])):
            _equal(a, b, f"act {k} of call {i}")
        _equal(got[i][2], want[2], f"gradient of call {i}")


@pytest.mark.cuda
def test_forward_with_a_backward_pending_runs_eagerly(cuda):
    """A second forward of a replayed signature before the first's
    backward runs eagerly (the replay would overwrite the saved tensors);
    both gradients come out right, in either order of the backwards; a
    backward run twice raises."""
    u = _unet("sd2")
    x0, x1, x2, x3 = (_card_inputs("sd2", 1, s) for s in range(4))
    for x in (x0, x1):  # eager, capture
        _grad_call(u, *x, "latents", _weights(u, *x0)[1:])
    weights = _weights(u, *x0)[1:]
    outs = []
    before = dict(tunet.GRAPH_CALLS)
    for sample, t, ctx in (x2, x3):
        lat = sample[:, :4].detach().requires_grad_(True)
        with torch.enable_grad():
            _, acts, _ = u(torch.cat([lat, sample[:, 4:]], dim=1), t, ctx)
            outs.append((lat, sum((a * w).sum()
                                  for a, w in zip(acts, weights))))
    assert _calls(before) == {"eager": 1, "capture": 0, "replay": 1}
    grads = [torch.autograd.grad(loss, lat, retain_graph=True)[0]
             for lat, loss in reversed(outs)][::-1]
    for x, g in zip((x2, x3), grads):
        _equal(g, _grad_call(_Eager(u), *x, "latents", weights)[2],
               "gradient")
    with pytest.raises(RuntimeError, match="backward ran twice"):
        torch.autograd.grad(outs[0][1], outs[0][0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sd2", "sd2-fused"])
def test_replay_counts_the_launches_of_its_capture(cuda, kind):
    """A replayed forward and backward advance the kernels' launch
    counters by what their capture launched, and the capture call by
    that alone: what an eager call launches, and where an output gets no
    gradient (eps, here) the backward of its own branch, which the
    captured backward runs on zeros (K8's backward at conv_norm_out on
    the fused route)."""
    u = _unet(kind)
    xs = [_card_inputs(kind, 1, s) for s in range(3)]
    weights = _weights(u, *xs[0])[1:]
    counters = [tatt.LAUNCHES, tgn.LAUNCHES, tgc.LAUNCHES, tconv.LAUNCHES]
    counts = []
    for x in xs:  # eager, capture, replay
        before = [dict(c) for c in counters]
        _grad_call(u, *x, "latents", weights)
        counts.append([{k: n - b[k] for k, n in c.items() if n != b[k]}
                       for c, b in zip(counters, before)])
    assert counts[0][0], "the flash kernels did not launch"
    if kind == "sd2-fused":
        assert counts[0][2], "K9 did not launch"
    assert counts[1] == counts[2]
    extra = [{k: n - eager.get(k, 0) for k, n in replay.items()
              if n != eager.get(k, 0)}
             for replay, eager in zip(counts[2], counts[0])]
    assert extra == ([{}, {"gn_silu_bwd": 1}, {}, {}] if kind == "sd2-fused"
                     else [{}] * 4)


@pytest.mark.cuda
def test_hooked_calls_run_eagerly(cuda):
    """A hook on a submodule sends a captured signature's calls back to
    the eager forward, where the hook fires; without it they replay."""
    u = _unet("tiny")
    x = _card_inputs("tiny")
    fired = []
    with torch.no_grad():
        u(*x)
        u(*x)
        h = u.up_blocks[1].register_forward_hook(
            lambda *a: fired.append(1))
        before = dict(tunet.GRAPH_CALLS)
        eps, _, _ = u(*x)
        h.remove()
        assert _calls(before) == {"eager": 1, "capture": 0, "replay": 0}
        assert fired == [1]
        again, _, _ = u(*x)
        assert _calls(before) == {"eager": 1, "capture": 0, "replay": 1}
    _equal(again, eps, "eps")
