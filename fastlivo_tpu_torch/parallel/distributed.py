"""Process-group initialization and the global mesh (port of
fastlivo_tpu/parallel/distributed.py).

One process per rank, as `torchrun` starts them: it sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT. NCCL drives CUDA ranks (one rank
per GPU), gloo CPU ranks; gloo also drives ranks that share one GPU (it
takes CUDA tensors and copies them through the host itself).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from fastlivo_tpu_torch.parallel.sharded import Mesh, make_mesh


def initialize_distributed(backend: Optional[str] = None, device=None) -> bool:
    """Initialise the default process group from the torchrun environment.

    `backend` None picks NCCL when the pipeline's device is CUDA (`device`
    None means CUDA) and gloo for the CPU. With NCCL the current CUDA device
    becomes `cuda:LOCAL_RANK`. Returns True when a group is (now)
    initialised, False when the environment names no world (no
    WORLD_SIZE): a single process, no group."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend=backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
    )
    return True


def make_global_mesh() -> Mesh:
    """1-D mesh over every rank of every host (ranks numbered host-major by
    torchrun, so a host's GPUs are contiguous on the axis)."""
    return make_mesh()


def host_local_slice(n_points: int) -> slice:
    """This process's share of a point axis sharded over the whole world
    (for feeding each rank its own points)."""
    nproc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    per = n_points // nproc
    return slice(pid * per, (pid + 1) * per)
