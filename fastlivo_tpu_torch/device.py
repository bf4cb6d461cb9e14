"""Device resolution for constructors and converters."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve(device=None) -> torch.device:
    """`None` means the GPU, and raises when there is none: `cuda` on a
    single process, `cuda:LOCAL_RANK` inside an initialised process group
    (one rank per GPU, as torchrun numbers them). Anything else is passed to
    `torch.device` as given (tests pass "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fastlivo_tpu_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run on the CPU"
            )
        if dist.is_available() and dist.is_initialized():
            return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        return torch.device("cuda")
    return torch.device(device)
