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


@pytest.mark.cuda
def test_fit_voxel_planes_card_matches_cpu(cuda_device):
    from fastlivo_tpu_torch.backend import std_loop

    rng = np.random.default_rng(4)
    ground = np.c_[rng.uniform(-20, 20, (30000, 2)), np.zeros(30000)]
    wall = np.c_[np.full(8000, 3.3), rng.uniform(-20, 20, 8000), rng.uniform(0, 6, 8000)]
    cloud = torch.as_tensor(np.concatenate([ground, wall]).astype(np.float32))
    kw = dict(voxel_size=2.0, max_voxels=1024, min_points=10, plane_thresh=0.01)
    ones = torch.ones(len(cloud), dtype=torch.bool)
    cpu = std_loop.fit_voxel_planes(cloud, ones, **kw)
    gpu = std_loop.fit_voxel_planes(cloud.to(cuda_device), ones.to(cuda_device), **kw)
    for k in ("coords", "count", "is_plane", "valid"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    pl = cpu["is_plane"]
    assert int(pl.sum()) > 100
    assert torch.allclose(gpu["center"].cpu()[pl], cpu["center"][pl], atol=1e-5)
    assert torch.allclose(gpu["normal"].cpu()[pl], cpu["normal"][pl], atol=1e-4)


@pytest.mark.cuda
def test_learned_matcher_card_matches_cpu(cuda_device):
    """The committed matcher on a street frame pair: the score map and
    dense descriptors within 1e-3, the keypoints and match set equal."""
    match = chip_smoke.matcher_card_vs_cpu(cuda_device, width=320, height=256)
    assert match["score_max_abs_err"] < 1e-3 and match["desc_max_abs_err"] < 1e-3
    assert match["keypoints_equal"] and match["matches_equal"]


@pytest.mark.cuda
def test_align_trajectory_card_matches_cpu(cuda_device):
    """GNSS initialisation runs its Gauss-Newton on the pipeline's device:
    the card's yaw and lever agree with the CPU's to f32 rounding."""
    from scipy.spatial.transform import Rotation

    from fastlivo_tpu_torch.models import gnss

    rng = np.random.default_rng(4)
    n = 40
    r_we = Rotation.from_euler("z", 0.7).as_matrix()
    lever = np.array([0.2, -0.1, 0.5])
    odo_pos = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0) * [1.0, 1.0, 0.1]
    odo_rot = np.stack([Rotation.from_euler("z", 0.05 * i).as_matrix() for i in range(n)])
    gnss_enu = (odo_pos + np.einsum("nij,j->ni", odo_rot, lever)) @ r_we + rng.normal(0, 0.02, (n, 3))
    args = (odo_pos, odo_rot, gnss_enu, np.full(3, 0.02))
    r_gpu, l_gpu = gnss.align_trajectory(*args, device=cuda_device)
    r_cpu, l_cpu = gnss.align_trajectory(*args, device="cpu")
    np.testing.assert_allclose(r_gpu, r_cpu, atol=1e-5)
    np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-4)
    np.testing.assert_allclose(l_cpu, lever, atol=0.05)
