"""Joining the process group for runs over several processes (PyTorch port
of `diffusion_models_moe_tpu/parallel/distributed.py`).

JAX's multi-controller runtime runs one program on every host and
`jax.distributed.initialize` wires the hosts into one device list. Here
every process runs the same program on one device and
`torch.distributed.init_process_group` joins them; `mesh.create_mesh` then
spans the group.

Usage (the same script in every process, e.g. under
`torchrun --nproc-per-node 2`):

    from diffusion_models_moe_tpu_torch.parallel.distributed import init_multihost
    init_multihost()        # no-op in a single process
    mesh = create_mesh()    # spans every process

The address, world size and rank are the arguments, or torchrun's
MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK. Each process
runs on `cuda:LOCAL_RANK` over NCCL, or on the CPU over gloo.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def local_device(device: str = "cuda") -> torch.device:
    """This process's device: `cuda:LOCAL_RANK` for "cuda" (raising where no
    card is present), else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and none is present; "
                           "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None,
                   device: str = "cuda") -> dict:
    """Joins the process group where the arguments or torchrun's variables
    ask for one; a no-op in a single process and where the group exists.

    `coordinator_address`: an init method (`tcp://host:port`, `file://path`),
    else `env://` from MASTER_ADDR and MASTER_PORT. `backend`: "nccl" on a
    card, "gloo" on the CPU, unless named (gloo also moves CUDA tensors,
    through the host). Any failure raises. Returns {"process_index",
    "process_count", "local_devices", "global_devices"}."""
    want = (coordinator_address is not None or num_processes is not None
            or "WORLD_SIZE" in os.environ)
    if want and not dist.is_initialized():
        world = int(num_processes if num_processes is not None
                    else os.environ.get("WORLD_SIZE", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("RANK", 0))
        dev = local_device(device)
        if backend is None:
            backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl" and dev.type != "cuda":
            raise ValueError("backend 'nccl' needs a CUDA device")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=coordinator_address
                                or "env://", world_size=world, rank=rank)
    initialized = dist.is_initialized()
    count = dist.get_world_size() if initialized else 1
    return {"process_index": dist.get_rank() if initialized else 0,
            "process_count": count,
            "local_devices": 1,
            "global_devices": count}


def is_coordinator() -> bool:
    """True in the process that writes files and logs (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Waits for every process of the group; a no-op without one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
