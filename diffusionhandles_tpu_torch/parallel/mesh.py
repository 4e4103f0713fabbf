"""Device mesh helpers.

The counterpart of the JAX package's `parallel/mesh.py`: a ('data',
'model') mesh where 'data' shards independent edits (one batch slice a
row of the mesh) and 'model' tensor-parallelizes the U-Net
(`parallel/sharding.py`). The JAX mesh is a grid of the devices one
process sees; here it is a `torch.distributed.device_mesh.DeviceMesh` over
the ranks of the process group, one GPU a rank, which every rank builds
with the same arguments.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from diffusionhandles_tpu_torch.utils.device import resolve_device


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, str] = ("data", "model"),
              model_parallel: int = 1, device=None) -> DeviceMesh:
    """A 2D (n / model_parallel, model_parallel) mesh over ranks 0..n-1 of
    the process group (n: the whole group by default), its dimensions
    named `axes`. In a process that joined no group, n = 1 makes a group
    of one here (NCCL on the GPU, gloo on the CPU). `device`: None for the
    GPU, "cpu" for the CPU."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n > world:
        raise ValueError(f"Requested {n} devices, have {world}")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    grid = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(dev.type, grid, mesh_dim_names=tuple(axes))
