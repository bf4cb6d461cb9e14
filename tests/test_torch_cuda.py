"""The CUDA kernel on the card (marked `cuda`; skipped without a GPU).

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from fastlivo_tpu_torch.ops import image
from fastlivo_tpu_torch.ops import pallas_windows as pw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("win", [13, 30, 38])
def test_kernel_matches_plain_and_counts_launches(cuda_device, win):
    rng = np.random.default_rng(win)
    img = torch.as_tensor(rng.uniform(0, 255, (576, 704)).astype(np.float32)).to(cuda_device)
    origins = rng.integers(-60, [700, 560], size=(208, 2)).astype(np.int32)
    origins[:2] = [[-60, -60], [700, 560]]  # clipped on both sides
    o = torch.as_tensor(origins).to(cuda_device)
    before = pw.LAUNCHES["extract_windows"]
    got = image.extract_windows(img, o, win, 32)
    assert pw.LAUNCHES["extract_windows"] == before + 1
    want = image.extract_windows(img.cpu(), o.cpu(), win, 32)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_kernel_rejects_noncontiguous(cuda_device):
    img = torch.zeros((64, 80), device=cuda_device)
    starts = torch.zeros((4, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        pw.extract_windows(img.T, starts, 8)
