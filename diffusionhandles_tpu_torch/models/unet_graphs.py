"""CUDA-graph replay of the U-Net's calls (`UNet2DConditionModel.forward`).

Every U-Net call of an edit or an inversion repeats one of a few
signatures (`signature`: the device; the shapes and dtypes of the latents,
the timestep, the text context and the call's further inputs, SDXL's
control image, pooled text vector and size ids; grad mode and which of the
latents and the context require grad), with the same weights and kernels
each time, and the host's enqueue of one call and its backward outlasts
the card's work on it. So on each instance the first call of a signature
runs eagerly (it warms cuDNN and sets the kernels' attributes), the second
captures it into CUDA graphs, and every later call replays them:

- a forward-only call copies its inputs into static buffers, replays the
  captured forward and returns clones of the static outputs (eps and the
  activations; callers keep outputs across calls);
- a call that records a graph for a backward goes through `_Replayed`, an
  autograd Function whose forward replays the captured forward and whose
  backward copies the incoming gradients into static buffers (zeros for an
  output that got none), replays the captured backward to the inputs that
  require grad and returns clones of their gradients. The captured
  forward's saved tensors live in the graph's pool until its backward
  replays, so a second forward of the signature that arrives before then
  runs eagerly.

A call stays eager wherever a replay would not do what the eager call
does (`mode`): off CUDA; with `capture_attention` (the probabilities are a
Python structure of tensors); while a submodule or the process holds a
module hook (a replay runs no Python, so the hook would silently not fire;
the benchmark's traced calls are such calls); in a tensor-parallel U-Net
(its layers run collectives in the forward); with `remat` (checkpointing
under capture is untested on the card); with grad on and a parameter that
requires grad (the captured backward computes no parameter gradient).

The kernels' launch counters (`LAUNCHES` and `LAYOUT_COPIES` of the ops
modules) advance on a replay by what its capture counted, so that they
still say what the card launched. `GRAPH_CALLS` counts the calls by path.

The forward-only graphs of an instance share one memory pool: they replay
one at a time on one stream, and their outputs are cloned out. Each
signature that records a graph keeps a pool of its own for its forward and
backward. The graphs read the parameters in place, so an update in place
reaches them; `UNet2DConditionModel` drops its graphs where its parameters
may be replaced (`_apply`, `load_state_dict`). The same holds for the
ControlNet and U-Net of SDXL (`controlnet.ControlNetDenoiser`): one call
of the pair is one graph.
"""

from __future__ import annotations

import os
import weakref
from operator import attrgetter
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.nn.modules import module as _module

from diffusionhandles_tpu_torch.ops import attention, conv, gn_conv, groupnorm

# U-Net calls by path, since the process started: run eagerly, captured
# (and replayed once), replayed
GRAPH_CALLS: Dict[str, int] = {"eager": 0, "capture": 0, "replay": 0}

# the kernels' counters that a replay advances by its capture's counts
_COUNTERS = [getattr(m, n) for m in (attention, groupnorm, gn_conv, conv)
             for n in ("LAUNCHES", "LAYOUT_COPIES") if hasattr(m, n)]

# the process's module hooks, which fire in every module's call
_GLOBAL_HOOKS = [getattr(_module, f"_global_{n}", {}) for n in (
    "forward_hooks", "forward_pre_hooks", "backward_hooks",
    "backward_pre_hooks")]

Counts = List[Dict[str, int]]


def _wants(sample, context) -> Tuple[bool, bool]:
    """Whether the call records a graph to the latents, to the context."""
    grad = torch.is_grad_enabled()
    return grad and sample.requires_grad, grad and context.requires_grad


def signature(sample: torch.Tensor, timesteps: torch.Tensor,
              context: torch.Tensor, capture_attention: bool,
              extra: tuple = ()) -> tuple:
    """The key of a call's graphs: the device, each input's shape and
    dtype (`extra`: the further inputs), grad mode and which inputs
    require grad, `capture_attention`, and the process's switches that
    pick the kernels a call runs (the flash backward's route, TF32,
    cuDNN's deterministic algorithms)."""
    return (sample.device,
            tuple(sample.shape), sample.dtype,
            tuple(timesteps.shape), timesteps.dtype,
            tuple(context.shape), context.dtype,
            tuple((tuple(x.shape), x.dtype) for x in extra),
            torch.is_grad_enabled(), _wants(sample, context),
            bool(capture_attention),
            os.environ.get(attention.BWD_ENV),
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


def mode(*, cuda: bool, capture_attention: bool, hooked: bool,
         tensor_parallel: bool, remat, trainable: bool, seen: bool,
         captured: bool, pending: bool) -> str:
    """How one call runs: "eager", "capture" or "replay".

    cuda: the call is on a CUDA device; hooked: a submodule or the process
    holds a module hook; tensor_parallel: a layer runs collectives; remat:
    the config's remat; trainable: grad is on and a parameter requires
    grad; seen: an earlier call of the signature could have replayed;
    captured: its graphs exist; pending: the backward of its last replayed
    forward has not run yet."""
    if (not cuda or capture_attention or hooked or tensor_parallel or remat
            or trainable):
        return "eager"
    if captured:
        return "eager" if pending else "replay"
    return "capture" if seen else "eager"


def _snapshot() -> Counts:
    return [dict(c) for c in _COUNTERS]


def _taken(before: Counts) -> Counts:
    """The counts added since `before`, which the counters return to: a
    capture launches nothing."""
    delta = []
    for c, b in zip(_COUNTERS, before):
        delta.append({k: n - b[k] for k, n in c.items() if n != b[k]})
        c.update(b)
    return delta


def _advance(delta: Counts) -> None:
    for c, d in zip(_COUNTERS, delta):
        for k, n in d.items():
            c[k] += n


class _Graph:
    """One signature's captured forward (and backward), its static
    buffers, and the counts its capture took. The inputs are (sample,
    timesteps, context, *extra); only the sample and the context can
    require grad."""

    def __init__(self, forward: Callable, inputs: tuple, pool,
                 wants: Tuple[bool, bool]):
        self.wants = wants  # (sample, context) require grad
        grad = any(wants)
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                       for x in inputs]
        self.inputs[0].requires_grad_(wants[0])
        self.inputs[2].requires_grad_(wants[1])
        self.pending: Optional[weakref.ref] = None

        before = _snapshot()
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, pool=pool), \
                torch.set_grad_enabled(grad):
            eps, acts, _ = forward(*self.inputs[:3], False,
                                   *self.inputs[3:])
        outs = (eps, *acts)
        self.fwd_counts = _taken(before)
        self.out = tuple(o.detach() for o in outs)
        if not grad:
            return
        self.grad_out = [torch.empty_like(o) for o in self.out]
        before = _snapshot()
        self.bwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.bwd, pool=pool):
            self.grad_in = torch.autograd.grad(
                outs, [x for x, w in zip(self.inputs[:3:2], wants) if w],
                self.grad_out)
        self.bwd_counts = _taken(before)

    def forward(self, inputs: tuple) -> tuple:
        """Replay the forward on these inputs: clones of the outputs."""
        with torch.no_grad():
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x)
            self.fwd.replay()
            _advance(self.fwd_counts)
            return tuple(o.clone() for o in self.out)

    def backward(self, grads) -> list:
        """Replay the backward on these output gradients (None: zeros):
        clones of the gradients of the inputs that require grad."""
        for buf, g in zip(self.grad_out, grads):
            if g is None:
                buf.zero_()
            else:
                buf.copy_(g)
        self.bwd.replay()
        _advance(self.bwd_counts)
        return [g.clone() for g in self.grad_in]

    def is_pending(self) -> bool:
        return self.pending is not None and self.pending() is not None


class _Replayed(torch.autograd.Function):
    """A call that records a graph, replayed: forward and backward are the
    captured graphs of `graph`."""

    @staticmethod
    def forward(ctx, graph: _Graph, sample, timesteps, context, *extra):
        ctx.set_materialize_grads(False)
        ctx.graph = graph
        ctx.n_extra = len(extra)
        outs = graph.forward((sample, timesteps, context, *extra))
        graph.pending = weakref.ref(ctx)
        return outs

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        graph = ctx.graph
        if graph.pending is None or graph.pending() is not ctx:
            raise RuntimeError(
                "a replayed U-Net call's backward ran twice, or after a "
                "later call of its signature replayed over its saved "
                "tensors")
        graph.pending = None
        grad_in = iter(graph.backward(grads))
        g_sample, g_context = (next(grad_in) if w else None
                               for w in graph.wants)
        return (None, g_sample, None, g_context) + (None,) * ctx.n_extra


class UNetGraphs:
    """One U-Net instance's graphs, by signature."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen: set = set()  # signatures called once, eligibly
        self.pools: Dict[torch.device, tuple] = {}  # forward-only graphs'
        self._dicts: Optional[list] = None
        self._params: Optional[list] = None

    def _observe(self, unet: torch.nn.Module) -> Tuple[bool, bool, bool]:
        """(hooked, tensor_parallel, trainable) of `unet` now."""
        if self._dicts is None:
            subs = list(unet.modules())[1:]
            self._dicts = [m.__dict__ for m in subs]
            self._params = list(unet.parameters())
        hooked = any(_GLOBAL_HOOKS) or any(
            d["_forward_hooks"] or d["_forward_pre_hooks"]
            or d["_backward_hooks"] or d["_backward_pre_hooks"]
            for d in self._dicts)
        # the parallel layers hold their process group (parallel/sharding.py)
        tensor_parallel = any("tp" in d for d in self._dicts)
        trainable = torch.is_grad_enabled() and any(
            map(attrgetter("requires_grad"), self._params))
        return hooked, tensor_parallel, trainable

    def call(self, unet: torch.nn.Module, forward: Callable, sample,
             timesteps, context, capture_attention: bool, extra: tuple = ()):
        """`forward(sample, timesteps, context, capture_attention, *extra)`
        (the eager U-Net, or SDXL's ControlNet and U-Net), or its graphs'
        replay. `unet.config.remat` is read."""
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        cuda = sample.device.type == "cuda"
        remat = unet.config.remat
        key = graph = None
        hooked = tensor_parallel = trainable = False
        # observing costs a walk over the modules: only where the cheap
        # conditions leave a replay possible
        if cuda and not capture_attention and not remat:
            key = signature(sample, timesteps, context, capture_attention,
                            extra)
            graph = self.graphs.get(key)
            hooked, tensor_parallel, trainable = self._observe(unet)
        how = mode(cuda=cuda, capture_attention=capture_attention,
                   hooked=hooked, tensor_parallel=tensor_parallel,
                   remat=remat, trainable=trainable, seen=key in self.seen,
                   captured=graph is not None,
                   pending=graph is not None and graph.is_pending())
        if key is not None and not (hooked or tensor_parallel or trainable):
            self.seen.add(key)
        GRAPH_CALLS[how] += 1
        if how == "eager":
            return forward(sample, timesteps, context, capture_attention,
                           *extra)
        inputs = (sample, timesteps, context, *extra)
        with torch.cuda.device(sample.device):
            if how == "capture":
                graph = self._capture(forward, key, inputs)
            if any(graph.wants):
                outs = _Replayed.apply(graph, *inputs)
            else:
                outs = graph.forward(inputs)
        return outs[0], tuple(outs[1:]), None

    def _capture(self, forward, key, inputs: tuple) -> _Graph:
        sample, _, context = inputs[:3]
        wants = _wants(sample, context)
        if any(wants):
            pool = torch.cuda.graph_pool_handle()
        else:
            pool = self.pools.setdefault(sample.device,
                                         torch.cuda.graph_pool_handle())
        graph = self.graphs[key] = _Graph(forward, inputs, pool, wants)
        return graph
