"""Tensor parallelism for the U-Net: the JAX package's parameter specs
(`parallel/sharding.py`) on the port's state-dict names, and the layers
that run a U-Net sharded by them.

The JAX package annotates parameters with PartitionSpecs and XLA's SPMD
partitioner inserts the collectives. Here one process drives one GPU: a
rank holds only its shards, and the layers issue the collectives
themselves over the mesh's model axis, Megatron-style, computing the same
function as the replicated U-Net:

* column-parallel (output features or channels sharded): to_q/k/v, the
  GEGLU projection, proj_in, time_embedding.linear_1, every convolution
  and the resnets' time_emb_proj. The layer copies its input into the
  model region (identity forward, all-reduce backward) and computes its
  rank's outputs with the slice of its bias for them; where the next op
  needs every channel (GroupNorm, LayerNorm, the next conv, a residual),
  the slices are all-gathered (slice backward).
* row-parallel (input features sharded): to_out, the feed-forward output,
  proj_out, time_embedding.linear_2. The layer multiplies its rank's
  input slice (a replicated input is sliced first: all-gather backward),
  sums the partial products with an all-reduce (identity backward), then
  adds its bias once.
* the pairs run with no collective between them: to_q/k/v -> attention
  over the rank's heads -> to_out; GEGLU -> the feed-forward output;
  linear_1 -> SiLU -> linear_2.
* norms, biases and embeddings: replicated by spec.
A tensor whose sharded dim the model axis does not divide stays
replicated, as under the JAX package's `_divisible` fallback, and its
layer runs replicated.

Deviations from the JAX package's spec:
* heads: JAX shards to_q/k/v on their output features and XLA reshards
  around the head reshape. An attention here runs locally over whole
  heads, so where a block's heads do not divide the model axis its
  to_q/k/v/to_out stay replicated (`replicated_attentions`; SD-2 at
  model_parallel 2: the 5-head attentions of the 320-wide blocks,
  down_blocks.0 and up_blocks.3, ten of them).
* GEGLU: JAX splits the [hidden | gate] projection's outputs in
  contiguous blocks; here each rank holds its slice of both halves, so
  that its hidden and gate channels pair up.
* the fused GN+SiLU+conv U-Net (UNetConfig.fused_gn_conv) is not sharded:
  its resnet halves hand the conv weights to one kernel.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from diffusionhandles_tpu_torch.models import unet as unet_lib

# Linear weights [out, in] sharded on output features (column-parallel),
# by module path: the JAX package's _COL_PARALLEL under the port's names.
_COL_PARALLEL = ("to_q", "to_k", "to_v", "ff.net.0.proj", "proj_in",
                 "time_embedding.linear_1", "q_proj", "k_proj", "v_proj",
                 "fc1")
# ... and on input features (row-parallel): its _ROW_PARALLEL.
_ROW_PARALLEL = ("to_out.0", "ff.net.2", "proj_out", "out_proj", "fc2",
                 "time_embedding.linear_2")
_GEGLU = "ff.net.0.proj"
_ATTENTION_LINEARS = ("to_q", "to_k", "to_v", "to_out.0")


def _name(path) -> str:
    return path if isinstance(path, str) else ".".join(path)


def _is(module: str, names: Sequence[str]) -> bool:
    return any(module == n or module.endswith("." + n) for n in names)


def param_spec(path, value, model_axis: str = "model"):
    """The spec of one parameter by its state-dict name (a dotted string,
    or its parts) and shape: a tuple with `model_axis` at the dim it
    shards, None elsewhere; () for replicated (the JAX package's
    PartitionSpec, on torch layouts: Linear [out, in], conv [Co, Ci, kh,
    kw])."""
    module, _, leaf = _name(path).rpartition(".")
    ndim = value.dim() if isinstance(value, torch.Tensor) else len(value)
    if (leaf != "weight" or ndim < 2
            or module.rpartition(".")[2].endswith("embedding")):
        return ()
    if _is(module, _COL_PARALLEL):
        return (model_axis,) + (None,) * (ndim - 1)
    if _is(module, _ROW_PARALLEL):
        return (None, model_axis) + (None,) * (ndim - 2)
    if ndim in (2, 4):
        # other dense kernels and the convolutions: output features
        return (model_axis,) + (None,) * (ndim - 1)
    return ()


def unet_param_spec(params: Mapping[str, torch.Tensor],
                    model_axis: str = "model") -> Dict[str, tuple]:
    """name -> param_spec of every tensor of a state dict."""
    return {k: param_spec(k, v, model_axis) for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def replicated_attentions(config: unet_lib.UNetConfig,
                          model_parallel: int) -> List[str]:
    """The attention modules of a U-Net on `config` whose heads the model
    axis does not divide: they run replicated (the head deviation from the
    JAX spec)."""
    with torch.device("meta"):
        net = unet_lib.UNet2DConditionModel(config)
    return [name for name, m in net.named_modules()
            if isinstance(m, unet_lib.Attention) and m.heads % model_parallel]


def sharded_dims(params: Mapping[str, torch.Tensor], model_parallel: int,
                 config: Optional[unet_lib.UNetConfig] = None,
                 model_axis: str = "model") -> Dict[str, Optional[int]]:
    """name -> the dim each rank holds a slice of, or None (replicated):
    param_spec, less the tensors the model axis does not divide and the
    attentions of replicated_attentions(config) (default: SD-2's
    UNetConfig()); a column-parallel layer's bias follows its weight."""
    config = config or unet_lib.UNetConfig()
    heads = tuple(f"{a}.{n}." for a in replicated_attentions(
        config, model_parallel) for n in _ATTENTION_LINEARS)
    dims = {}
    for name, value in params.items():
        spec = param_spec(name, value, model_axis)
        dim = spec.index(model_axis) if model_axis in spec else None
        if dim is not None:
            # GEGLU: each half divides
            n = value.shape[dim] // (2 if _GEGLU in name else 1)
            if n % model_parallel or name.startswith(heads):
                dim = None
        dims[name] = dim
    for name in params:
        if name.endswith(".bias"):
            dims[name] = 0 if dims.get(name[:-4] + "weight") == 0 else None
    return dims


def _local(name: str, t: torch.Tensor, dim: Optional[int], rank: int,
           size: int) -> torch.Tensor:
    """The rank's slice of `t` (GEGLU: its slice of both halves), a copy
    of its own so that the full tensor can be freed."""
    if dim is None:
        return t
    if _GEGLU in name:
        return torch.cat([h.chunk(size)[rank] for h in t.chunk(2)])
    return t.chunk(size, dim)[rank].clone()


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of `mesh`'s dimension `axis` (1 where it has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def shard_params(params: Mapping[str, torch.Tensor], mesh: DeviceMesh,
                 model_axis: str = "model",
                 config: Optional[unet_lib.UNetConfig] = None
                 ) -> Dict[str, torch.Tensor]:
    """This rank's tensors of a U-Net state dict: its slices of the
    sharded ones (sharded_dims; `config` the U-Net's, default SD-2's),
    the replicated ones whole."""
    size = axis_size(mesh, model_axis)
    rank = mesh.get_local_rank(model_axis) if size > 1 else 0
    dims = sharded_dims(params, size, config, model_axis)
    return {k: _local(k, v, dims[k], rank, size) for k, v in params.items()}


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def replicate(tree, mesh: DeviceMesh):
    """The rank's full copy of a tensor, or a list, tuple or dict of them,
    on the mesh's device (every rank passes the same values)."""
    dev = _device(mesh)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return tree


def shard_batch(x: torch.Tensor, mesh: DeviceMesh,
                data_axis: str = "data") -> torch.Tensor:
    """The rank's slice of x's leading (batch) dim over the data axis, on
    the mesh's device. Raises where the axis does not divide the batch, as
    the JAX package's placement with P('data') does."""
    size = axis_size(mesh, data_axis)
    if x.shape[0] % size:
        raise ValueError(f"the '{data_axis}' axis of size {size} does not "
                         f"divide a batch of {x.shape[0]}")
    n = x.shape[0] // size
    rank = mesh.get_local_rank(data_axis) if size > 1 else 0
    return x[rank * n:(rank + 1) * n].to(_device(mesh))


def gather_batch(x: torch.Tensor, mesh: DeviceMesh,
                 data_axis: str = "data") -> torch.Tensor:
    """shard_batch's inverse: every rank's slice, concatenated in rank
    order (no gradient)."""
    if axis_size(mesh, data_axis) == 1:
        return x
    return _all_gather(x, 0, mesh.get_group(data_axis))


# ---------------------------------------------------------------------------
# The collectives of the model region, each with its Megatron pairing
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _CopyToModelRegion(torch.autograd.Function):
    """Identity forward; the backward sums the ranks' partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromModelRegion(torch.autograd.Function):
    """All-reduce forward (the row-parallel sum); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModelRegion(torch.autograd.Function):
    """All-gather of the ranks' slices along `dim`; the backward takes the
    rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.start = dist.get_rank(group) * ctx.n
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.start, ctx.n), None, None


class _ScatterToModelRegion(torch.autograd.Function):
    """The rank's slice along `dim` of a replicated tensor; the backward
    all-gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // dist.get_world_size(group)
        return x.narrow(dim, dist.get_rank(group) * n, n)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, ctx.dim, ctx.group), None, None


# ---------------------------------------------------------------------------
# The layers. shard_unet swaps a layer's class for its parallel one in
# place, so that the state-dict names and the module tree stay the U-Net's.
# ---------------------------------------------------------------------------

class _ColumnParallel:
    """A Linear or conv holding its rank's outputs: the input copied into
    the model region, the outputs all-gathered (unless not `tp_gather`)."""

    tp: dist.ProcessGroup  # the model axis's group
    tp_gather: bool = True

    def forward(self, x):
        y = super().forward(_CopyToModelRegion.apply(x, self.tp))
        if self.tp_gather:
            dim = 1 if isinstance(self, unet_lib.Conv2d) else y.dim() - 1
            y = _GatherFromModelRegion.apply(y, dim, self.tp)
        return y


class ColumnParallelLinear(_ColumnParallel, unet_lib.Linear):
    pass


class ColumnParallelConv2d(_ColumnParallel, unet_lib.Conv2d):
    pass


class ColumnParallelConv3x3(_ColumnParallel, unet_lib.Conv3x3):
    """The gate (conv3x3_ok) still sees the layer's full output channels,
    as the JAX package's gate sees the unpartitioned conv."""


class RowParallelLinear(unet_lib.Linear):
    """A Linear holding its rank's input features: a replicated input is
    sliced (unless `tp_input_parallel`), the partial products are summed
    with an all-reduce, then the bias is added."""

    tp: dist.ProcessGroup  # the model axis's group
    tp_input_parallel: bool = False

    def forward(self, x):
        g = self.tp
        if not self.tp_input_parallel:
            x = _ScatterToModelRegion.apply(x, x.dim() - 1, g)
        dt = self.compute_dtype
        y = _ReduceFromModelRegion.apply(
            F.linear(x.to(dt), self.weight.to(dt)), g)
        return y if self.bias is None else y + self.bias.to(dt)


class TPAttention(unet_lib.Attention):
    """An attention over the rank's heads (`heads` is the local count):
    x and the context copied into the model region once, to_q/k/v
    holding the rank's heads' outputs, to_out row-parallel. Captured
    probabilities are all-gathered over the heads."""

    tp: dist.ProcessGroup  # the model axis's group

    def forward(self, x, context=None, capture_probs: bool = False):
        g = self.tp
        x = _CopyToModelRegion.apply(x, g)
        if context is not None:
            context = _CopyToModelRegion.apply(context, g)
        out, probs = super().forward(x, context, capture_probs)
        if probs is not None:
            probs = _GatherFromModelRegion.apply(probs, 1, g)
        return out, probs


class TPFeedForward(unet_lib.FeedForward):
    """The GEGLU feed-forward over the rank's hidden channels: x copied
    into the model region, the projection holding the rank's slices of
    both halves, the output row-parallel."""

    tp: dist.ProcessGroup  # the model axis's group

    def forward(self, x):
        return super().forward(_CopyToModelRegion.apply(x, self.tp))


_COLUMN_CLASSES = ((unet_lib.Conv3x3, ColumnParallelConv3x3),
                   (unet_lib.Conv2d, ColumnParallelConv2d),
                   (unet_lib.Linear, ColumnParallelLinear))


def _swap(module, cls, group, **flags) -> None:
    module.__class__ = cls
    module.tp = group
    for k, v in flags.items():
        setattr(module, k, v)


def shard_unet(unet: unet_lib.UNet2DConditionModel, mesh: DeviceMesh,
               model_axis: str = "model",
               params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> unet_lib.UNet2DConditionModel:
    """Shard `unet` over the mesh's model axis in place: its parameters
    become this rank's (`params`, shard_params' output for its state dict,
    made here when None) and its sharded layers the parallel layers above.
    Every rank of the axis then runs it in step. Returns `unet`; with a
    model axis of 1, unchanged."""
    size = axis_size(mesh, model_axis)
    if size == 1:
        return unet
    if unet.config.fused_gn_conv:
        raise ValueError("shard_unet: the fused GN+SiLU+conv U-Net hands "
                         "the conv weights to one kernel; it is not "
                         "sharded")
    full = unet.state_dict()
    dims = sharded_dims(full, size, unet.config, model_axis)
    if params is None:
        params = shard_params(full, mesh, model_axis, unet.config)
    group = mesh.get_group(model_axis)
    mods = dict(unet.named_modules())

    def col(name):
        return dims.get(f"{name}.weight") == 0

    def row(name):
        return dims.get(f"{name}.weight") == 1

    # the pairs: column outputs kept sharded into a row layer's input
    kept, fed = set(), set()
    for name, m in mods.items():
        if isinstance(m, unet_lib.Attention) and col(f"{name}.to_q"):
            kept |= {f"{name}.{n}" for n in ("to_q", "to_k", "to_v")}
            fed.add(f"{name}.to_out.0")
            _swap(m, TPAttention, group)
            m.heads //= size
        elif isinstance(m, unet_lib.FeedForward) and col(f"{name}.net.0.proj"):
            kept.add(f"{name}.net.0.proj")
            fed.add(f"{name}.net.2")
            _swap(m, TPFeedForward, group)
    if col("time_embedding.linear_1"):
        kept.add("time_embedding.linear_1")
        fed.add("time_embedding.linear_2")
    for name in kept | fed:
        if not (col(name) if name in kept else row(name)):
            raise ValueError(f"shard_unet: {name} breaks its pair's "
                             "sharding")

    for name, m in mods.items():
        if col(name):
            if name == "time_embedding.linear_1":
                _swap(m, ColumnParallelLinear, group, tp_gather=False)
            elif name not in kept:
                cls = next(c for base, c in _COLUMN_CLASSES
                           if isinstance(m, base))
                _swap(m, cls, group)
        elif row(name):
            _swap(m, RowParallelLinear, group,
                  tp_input_parallel=name in fed)
    for name, p in list(unet.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(mods[owner], leaf, torch.nn.Parameter(
            params[name].to(p.device), requires_grad=p.requires_grad))
    for m in unet.modules():
        if isinstance(m, unet_lib.Conv3x3):
            m._hold_kernel_layout()
    return unet
