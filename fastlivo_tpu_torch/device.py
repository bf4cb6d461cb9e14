"""Device resolution for constructors and converters."""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`None` means the GPU; raise when there is none. Anything else is
    passed to `torch.device` as given (tests pass "cpu")."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fastlivo_tpu_torch: no CUDA device is available; pass "
                "device='cpu' explicitly to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
