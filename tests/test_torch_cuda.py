"""The CUDA kernels on the card (marked `cuda`; skipped without a GPU).

This file imports neither jax nor the JAX package, so it also runs on a
GPU machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import chip_smoke
from fastlivo_tpu_torch.ops import image
from fastlivo_tpu_torch.ops import pallas_windows as pw
from fastlivo_tpu_torch.ops import patch_sample as ps


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


def _cases(device, form, n=208):
    """The form's case on the card, and the same inputs on the CPU."""
    cam, pyr = chip_smoke.patch_sample_frame(device)
    return [
        next(c for c in chip_smoke.patch_sample_cases(levels, cam, n) if c["name"] == form)
        for levels in (pyr, [img.cpu() for img in pyr])
    ]


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["select", "update_L0", "update_L1", "update_L2", "stored"])
def test_patch_sample_matches_plain_and_counts_launches(cuda_device, form):
    # The main-path forms on a rendered frame's padded pyramid, with
    # clamped, out-of-set and non-finite centers among the candidates.
    case, cpu_case = _cases(cuda_device, form)
    before = ps.LAUNCHES["patch_sample"]
    got = _as_tuple(case["kernel"]())
    assert ps.LAUNCHES["patch_sample"] == before + 1
    want = _as_tuple(case["plain"]())
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert chip_smoke.same_bits(a, b)
    # Finite centers (rows 8 on) give the CPU plain version's bits too.
    for a, b in zip(got, _as_tuple(cpu_case["kernel"]())):
        assert torch.equal(a[8:].cpu(), b[8:])


@pytest.mark.cuda
def test_patch_sample_levels_equal_per_level_launches(cuda_device):
    case, _ = _cases(cuda_device, "stored")
    pyr, px = case["levels"], case["centers"][0]
    got = ps.patch_sample_levels(pyr, px, 12, chip_smoke.PS_PAD)
    ones = torch.ones(px.shape[0], dtype=torch.int32, device=cuda_device)
    before = ps.LAUNCHES["patch_sample"]
    for lvl, img in enumerate(pyr):
        one = ps.patch_sample(img, px / (1 << lvl), ones, 12, chip_smoke.PS_PAD, (1,))
        assert chip_smoke.same_bits(got[:, lvl].reshape(px.shape[0], -1), one), lvl
    assert ps.LAUNCHES["patch_sample"] == before + len(pyr)


@pytest.mark.cuda
def test_patch_sample_rejects_bad_inputs(cuda_device):
    img = torch.zeros((80, 96), device=cuda_device)
    c = torch.full((4, 2), 40.0, device=cuda_device)
    s = torch.ones(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        ps.patch_sample(img.T, c, s, 8, 32)  # not contiguous
    with pytest.raises(ValueError):
        ps.patch_sample(img, c.cpu(), s, 8, 32)  # two devices
    with pytest.raises(ValueError):
        ps.patch_sample(img, c, s.long(), 8, 32)
