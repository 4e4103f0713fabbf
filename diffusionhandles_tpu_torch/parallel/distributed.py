"""Multi-process / multi-host runtime: one process per GPU in one
`torch.distributed` process group.

The counterpart of the JAX package's `parallel/distributed.py`. There each
service process joins JAX's multi-controller runtime; here each process
joins a process group, the PyTorch form of multi-controller SPMD (one
process drives one GPU), under the same env-variable contract, set per
process by the launcher:
  DIFFHANDLES_COORDINATOR   host:port of process 0 (e.g. localhost:9911)
  DIFFHANDLES_NUM_PROCESSES total process count
  DIFFHANDLES_PROCESS_ID    this process's id [0, num_processes)

The group's backend is NCCL on the GPU; gloo only when the caller asks for
the CPU (`device="cpu"`) or names it (`backend="gloo"`: gloo stages CUDA
tensors through the host, so two ranks can share one card, which NCCL
refuses). A process asked for the GPU that finds none raises; it never
joins over gloo on its own.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from diffusionhandles_tpu_torch.utils.device import resolve_device


def distributed_env() -> Optional[dict]:
    """Read the launcher's env contract; None when not set."""
    coord = os.environ.get("DIFFHANDLES_COORDINATOR")
    if not coord:
        return None
    return dict(
        coordinator_address=coord,
        num_processes=int(os.environ.get("DIFFHANDLES_NUM_PROCESSES", "1")),
        process_id=int(os.environ.get("DIFFHANDLES_PROCESS_ID", "0")),
    )


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None,
                     device=None, backend: Optional[str] = None) -> dict:
    """Join the process group at tcp://<coordinator_address>.

    Arguments default to the env contract above (one process, id 0, where
    it is silent). `local_device_ids`: the GPU this process drives (its
    first entry; default process_id modulo the visible GPUs). `device`:
    None for the GPU, "cpu" to join on the CPU. `backend`: NCCL on the
    GPU and gloo on the CPU unless named. Returns a summary dict
    {process_id, num_processes, local_devices, global_devices}, one device
    a process."""
    env = distributed_env() or {}
    coordinator_address = coordinator_address or env.get(
        "coordinator_address")
    num_processes = num_processes or env.get("num_processes") or 1
    process_id = process_id if process_id is not None else env.get(
        "process_id", 0)
    if coordinator_address is None:
        raise ValueError("No coordinator address (arg or "
                         "DIFFHANDLES_COORDINATOR)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        ids = (list(local_device_ids) if local_device_ids is not None
               else [process_id % torch.cuda.device_count()])
        torch.cuda.set_device(ids[0])
        backend = backend or "nccl"
    elif dev.type == "cpu":
        backend = backend or "gloo"
    else:
        raise ValueError(f"init_distributed: no process group on {dev}")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dict(process_id=dist.get_rank(),
                num_processes=dist.get_world_size(), local_devices=1,
                global_devices=dist.get_world_size())


def maybe_init_from_env(device=None, backend: Optional[str] = None
                        ) -> Optional[dict]:
    """Join the process group iff the launcher set the env contract; no-op
    (returns None) otherwise. Service entry points call this first so the
    same code runs single-process and multi-host."""
    if distributed_env() is None:
        return None
    return init_distributed(device=device, backend=backend)
