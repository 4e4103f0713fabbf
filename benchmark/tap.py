"""What the harness observes of the program's denoiser, at its module
boundary.

`UNetTap` wraps the `__call__` of the denoiser's class (the model family's
`tap(cfg)` names the class, and how to read a call's arguments) for the
length of a run, so that it sees every instance, the copies that batched
editing builds per request included. For each call it keeps the latents
it was given (a detached reference to the input, no copy and no device
sync), whether the call records a graph for a backward, and the host
nanoseconds the call took to enqueue. At the call indices in `keep` that
record a graph it also keeps the activations the call returned, copied
without a sync into host buffers made before the request. While tracing
it also records the shapes of the kernel sites that the roofline shares
need: the long self-attentions and the resnet halves.
"""

from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class Call:
    grad: bool            # the call records a graph for a backward
    batch: int
    timestep: torch.Tensor
    latents: torch.Tensor  # [batch, C, h, w], the latent channels
    host_ns: int
    acts: Optional[list] = None  # the returned activations, where kept
    start_ns: int = 0      # the host clock at the call's start


class UNetTap:
    """Record the calls of `cls` into `self.calls` (one list per request,
    started with `begin`). `parse(args, kwargs)` reads a call's arguments
    as (the latents [batch, C, h, w], detached; the timestep; the tensors
    through which the call records a graph where one requires grad). A
    call returns (eps, activations, ...)."""

    def __init__(self, cls: type, parse: Callable):
        self.cls = cls
        self.parse = parse
        self.calls: List[Call] = []
        # call indices whose returned activations are kept, and the host
        # buffers made for them before the request
        self.keep: set = set()
        self._shapes: Optional[list] = None
        self._buffers: dict = {}
        # called before each call with its index in the request and the
        # denoiser instance
        self.on_call: Optional[Callable[[int, torch.nn.Module], None]] = \
            None
        self._orig = None

    def __enter__(self):
        self._orig = self.cls.__call__
        orig, tap = self._orig, self

        def call(module, *args, **kwargs):
            latents, t, inputs = tap.parse(args, kwargs)
            if tap.on_call is not None:
                tap.on_call(len(tap.calls), module)
            grad = torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in inputs)
            start = time.perf_counter_ns()
            out = orig(module, *args, **kwargs)
            took = time.perf_counter_ns() - start
            acts = (tap._kept(len(tap.calls), out[1])
                    if grad and len(tap.calls) in tap.keep else None)
            tap.calls.append(Call(grad, int(latents.shape[0]), t,
                                  latents, took, acts, start))
            return out

        self.cls.__call__ = call
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self._orig
        return False

    def begin(self) -> List[Call]:
        """Start a request's record; make the host buffers of the kept
        activations once their shapes are known (from a call of the
        set-up)."""
        self.calls = []
        self._buffers = {}
        if self._shapes is not None and torch.cuda.is_available():
            self._buffers = {
                i: [torch.empty(shape, dtype=dtype, pin_memory=True)
                    for shape, dtype in self._shapes] for i in self.keep}
        return self.calls

    def _kept(self, index: int, acts) -> list:
        acts = [a.detach() for a in acts]
        bufs = self._buffers.get(index)
        if bufs is None or [tuple(b.shape) for b in bufs] != [
                tuple(a.shape) for a in acts]:
            self._shapes = [(tuple(a.shape), a.dtype) for a in acts]
            return [a.clone() for a in acts]
        for b, a in zip(bufs, acts):
            b.copy_(a, non_blocking=True)
        return bufs


def launch_counter(spec) -> int:
    """The program's launch count named by a kernels.json "counter" entry
    ([module, name, ...]): the sum of its names."""
    mod = importlib.import_module(spec[0])
    return sum(mod.LAUNCHES[n] for n in spec[1:])


class SiteRecorder:
    """While tracing: the shapes of the long self-attentions (those the
    program sends to its flash kernels: `use_flash` set and at least
    MIN_KEYS keys) and of the resnet halves that took the fused
    GroupNorm+conv kernel (read from the program's launch counter around
    each resnet block)."""

    MIN_KEYS = 512  # the program's flash gate: at least 512 keys

    def __init__(self):
        self.attention: list = []   # (b, sq, sk, h, d, graph)
        self.halves: list = []      # (b, h, w, ci, co, groups, graph)
        self._handles: list = []
        self._attached: set = set()

    def attach(self, unet: torch.nn.Module):
        """Hook `unet`'s sites (once per instance)."""
        from diffusionhandles_tpu_torch.ops import gn_conv
        if id(unet) in self._attached:
            return
        self._attached.add(id(unet))
        for mod in unet.modules():
            kind = type(mod).__name__
            if kind == "Attention" and getattr(mod, "use_flash", False):
                self._handles.append(mod.register_forward_pre_hook(
                    self._attention, with_kwargs=True))
            elif kind == "ResnetBlock2D":
                self._handles.append(mod.register_forward_pre_hook(
                    self._block_pre))
                self._handles.append(mod.register_forward_hook(
                    lambda m, a, o, g=gn_conv: self._block_post(m, a, g)))

    def detach(self):
        for h in self._handles:
            h.remove()
        self._handles = []
        self._attached = set()

    def _attention(self, mod, args, kwargs):
        x = args[0]
        ctx = args[1] if len(args) > 1 else kwargs.get("context")
        capture = kwargs.get("capture_probs", False)
        if ctx is not None or capture:
            return
        b, s, _ = x.shape
        if s >= self.MIN_KEYS:
            self.attention.append((b, s, s, mod.heads, mod.head_dim,
                                   torch.is_grad_enabled()
                                   and x.requires_grad))

    def _block_pre(self, mod, args):
        from diffusionhandles_tpu_torch.ops import gn_conv
        mod._bench_k9 = gn_conv.LAUNCHES["gn_silu_conv3x3_fwd"]

    def _block_post(self, mod, args, gn_conv):
        took = gn_conv.LAUNCHES["gn_silu_conv3x3_fwd"] - mod._bench_k9
        if not took:
            return
        x = args[0]
        b, ci, h, w = x.shape
        co = mod.conv1.out_channels
        halves = [(ci, co), (co, co)]
        # one half refused: the gate grows with the input channels, so the
        # narrower half is the one that ran
        if took == 1:
            halves = [min(halves)]
        g = mod.norm1.num_groups
        graph = torch.is_grad_enabled() and x.requires_grad
        for a, c in halves:
            self.halves.append((b, h, w, a, c, g, graph))
