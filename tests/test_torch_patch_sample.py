"""Port parity: the fused patch sampler's plain version (ops/patch_sample.py)
against the JAX package's strided_patch_sample and stored_patch_pyramid,
and the VIO phases on one shared padded pyramid.

The plain version repeats the JAX arithmetic in the same order; the
tolerance is f32 rounding in 0-255 intensity units (and per px for
gradients), atol 1e-3 as in tests/test_torch_image.py. The kernel itself
runs only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scene_mod
from fastlivo_tpu.maps import visual_map as JVM
from fastlivo_tpu.models import vio as JVIO
from fastlivo_tpu.ops import image as J
from fastlivo_tpu_torch.io import render as t_render
from fastlivo_tpu_torch.maps import visual_map as TVM
from fastlivo_tpu_torch.models import vio as TVIO
from fastlivo_tpu_torch.ops import image as T
from fastlivo_tpu_torch.ops import patch_sample as TPS
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole
from fastlivo_tpu_torch.state import NavState

torch.set_num_threads(1)

PAD = 32
H, W = 96, 128
ATOL = 1e-3


def _img(seed, h=H, w=W):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def _centers(seed, n, h=H, w=W):
    """Interior centers, then eight whose windows clamp: four hugging the
    borders and four well outside them (left, right, top, bottom)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(2.0, [w - 2.0, h - 2.0], size=(n, 2))
    edge = [
        [1.3, 2.7], [w - 1.2, 3.1], [2.2, h - 1.6], [w - 2.5, h - 1.1],
        [-40.25, h / 2 + 0.25], [w + 45.75, h / 2 - 0.5], [w / 2 + 0.5, -50.25], [w / 2 - 0.75, h + 41.5],
    ]
    k = min(n, len(edge))
    c[:k] = edge[:k]
    return c.astype(np.float32)


def _both(img_pad, centers, strides, patch, stride_set, gu):
    got = TPS.patch_sample(
        torch.from_numpy(img_pad), torch.from_numpy(centers), torch.from_numpy(strides), patch, PAD,
        stride_set, None if gu is None else torch.from_numpy(gu),
    )
    want = J.strided_patch_sample(
        jnp.asarray(img_pad), jnp.asarray(centers), jnp.asarray(strides), patch, PAD,
        stride_set=stride_set, grad_units=None if gu is None else jnp.asarray(gu),
    )
    if gu is None:
        return (got,), (want,)
    return got, want


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("stride", [1, 2, 4, None])
def test_matches_jax(stride, grad):
    # One stride for all candidates, or (None) a mix of the three.
    img_pad = np.pad(_img(stride or 3), PAD)
    n = 48
    centers = _centers(11, n)
    rng = np.random.default_rng(12)
    strides = np.full(n, stride, np.int32) if stride else rng.choice([1, 2, 4], n).astype(np.int32)
    gu = (strides * 2.0).astype(np.float32) if grad else None
    got, want = _both(img_pad, centers, strides, 8, (1, 2, 4), gu)
    for g, w in zip(got, want):
        assert g.shape == (n, 64)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


@pytest.mark.parametrize("grad", [False, True])
def test_stride_outside_the_set(grad):
    # A stride missing from stride_set anchors the window with its own
    # value but samples the lattice of stride_set[0] (the where chain).
    img_pad = np.pad(_img(21), PAD)
    centers = _centers(22, 24)
    strides = np.array([3, 1, 2, 4, 5] * 4 + [3, 3, 1, 2], np.int32)
    gu = np.full(24, 1.5, np.float32) if grad else None
    got, want = _both(img_pad, centers, strides, 8, (2, 4), gu)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_clamped_windows_read_from_the_clipped_origin():
    # Centers far outside the frame clamp their windows on each side; the
    # lattice is read relative to the clipped origin, so such a patch
    # equals that of the center moved to the clamp edge.
    img_pad = np.pad(_img(31), PAD)
    centers = _centers(32, 8)
    strides = np.ones(8, np.int32)
    got, want = _both(img_pad, centers, strides, 12, (1,), None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=ATOL)
    # Center 4 (u = -40.25) clamps its origin to 0: the same fraction at
    # u = -25.25 puts the unclamped origin there (floor - half + pad = 0).
    edge = np.array([[-25.25, centers[4, 1]]], np.float32)
    at_edge, _ = _both(img_pad, edge, np.ones(1, np.int32), 12, (1,), None)
    np.testing.assert_array_equal(got[0][4].numpy(), at_edge[0][0].numpy())


def test_stored_patch_pyramid_matches_jax():
    img = _img(41, 120, 160)
    px = _centers(42, 40, 120, 160)
    got = TVIO.stored_patch_pyramid(
        torch.from_numpy(img), torch.from_numpy(px), TVM.VisualMapConfig(capacity=64, max_obs=2)
    )
    want = JVIO.stored_patch_pyramid(
        jnp.asarray(img), jnp.asarray(px), JVM.VisualMapConfig(capacity=64, max_obs=2)
    )
    assert got.shape == (40, 3, 12, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_levels_equal_per_level_calls_bitwise():
    img = torch.from_numpy(_img(51, 120, 160))
    pyr = TVIO.pyramid_padded(img, 3)
    px = torch.from_numpy(_centers(52, 30, 120, 160))
    got = TPS.patch_sample_levels(pyr, px, 12, PAD)
    ones = torch.ones(30, dtype=torch.int32)
    for lvl in range(3):
        one = TPS.patch_sample(pyr[lvl], px / (1 << lvl), ones, 12, PAD, (1,))
        assert torch.equal(got[:, lvl].reshape(30, -1), one), lvl


def test_cpu_call_leaves_launch_counter_at_zero():
    saved = TPS.LAUNCHES["patch_sample"]
    TPS.LAUNCHES["patch_sample"] = 0
    try:
        img = torch.zeros((80, 80))
        c = torch.full((3, 2), 40.0)
        s = torch.ones(3, dtype=torch.int32)
        T.strided_patch_sample(img, c, s, 8, PAD, grad_units=torch.ones(3))
        TPS.patch_sample_levels([img, img[:60, :60].contiguous()], c, 12, PAD)
        assert TPS.LAUNCHES["patch_sample"] == 0
    finally:
        TPS.LAUNCHES["patch_sample"] = saved


def test_wrapper_rejects_bad_inputs():
    img = torch.zeros((80, 80))
    c = torch.full((3, 2), 40.0)
    s = torch.ones(3, dtype=torch.int32)
    bad = [
        dict(img_pad=img.double()),
        dict(centers=c.double()),
        dict(strides=s.long()),
        dict(grad_units=torch.ones(3, dtype=torch.float64)),
        dict(img_pad=torch.zeros((80, 160))[:, ::2]),  # not contiguous
        dict(centers=torch.full((2, 3), 40.0).T),  # not contiguous
        dict(img_pad=torch.zeros((20, 80))),  # window 30 taller than the image
        dict(stride_set=(1, 2, 4, 8)),
        dict(stride_set=(0,)),
        dict(patch_size=15, grad_units=torch.ones(3)),  # lattice 17 > 16
    ]
    for override in bad:
        args = dict(img_pad=img, centers=c, strides=s, patch_size=8, pad=PAD, stride_set=(1, 2, 4))
        args.update(override)
        with pytest.raises(ValueError):
            TPS.patch_sample(**args)
    with pytest.raises(ValueError):
        TPS.patch_sample_levels([img] * 4, c, 12, PAD)


CAM = TPinhole(320, 256, 200.0, 200.0, 160.0, 128.0)
VM_CFG = TVM.VisualMapConfig(capacity=1024, max_obs=4)
CFG = TVIO.VioConfig()


def _frame(pos):
    rcw = torch.from_numpy(scene_mod.ROT_CI)
    pcw = torch.from_numpy((-scene_mod.ROT_CI @ pos).astype(np.float32))
    return t_render.render_room(CAM, rcw, pcw, half=8.0, floor_z=-1.5)


def test_vio_update_shared_pyramid_equals_per_phase_bitwise():
    # vio_update builds the padded pyramid once and hands it to select,
    # photometric_update and maintain; each phase alone builds its own.
    scene = scene_mod.Scene(4096, 32, seed=5)
    cloud = torch.from_numpy(scene.room_points(4096).astype(np.float32))
    mask = torch.ones(4096, dtype=torch.bool)
    st = scene.initial_state()
    rot_ci, z3 = torch.from_numpy(scene_mod.ROT_CI), torch.zeros(3)
    vmap = TVM.make_visual_map(VM_CFG, device="cpu")
    for dp in ([0.0, 0.0, 0.0], [0.0, 0.1, 0.0]):
        pos = (st["pos"] + dp).astype(np.float32)
        s = NavState(**{k: torch.from_numpy(v) for k, v in dict(st, pos=pos).items()})
        _, vmap, _ = TVIO.vio_update(s, vmap, _frame(pos), cloud, mask, CAM, rot_ci, z3, VM_CFG, CFG)
    pos = (st["pos"] + [0.0, 0.2, 0.0]).astype(np.float32)
    img = _frame(pos)
    prior = NavState(**{
        k: torch.from_numpy(v)
        for k, v in dict(st, pos=(pos + [0.015, -0.01, 0.01]).astype(np.float32)).items()
    })

    post, vm_shared, info = TVIO.vio_update(prior, vmap, img, cloud, mask, CAM, rot_ci, z3, VM_CFG, CFG)
    sel, _ = TVIO.select(prior, vmap, img, cloud, mask, CAM, rot_ci, z3, VM_CFG, CFG)
    post2, e0, e1 = TVIO.photometric_update(prior, sel, img, CAM, rot_ci, z3, CFG)
    vm_phase, n_new, n_obs = TVIO.maintain(post2, vmap, sel, img, cloud, mask, CAM, rot_ci, z3, VM_CFG, CFG)

    assert int(info.n_selected) == int(sel.valid.sum()) > 0
    assert int(info.n_new_obs) == int(n_obs)
    assert int(info.n_new_points) == int(n_new) > 0
    assert torch.equal(info.error_before, e0) and torch.equal(info.error_after, e1)
    for a, b in zip(post, post2):
        assert torch.equal(a, b)
    for name in TVM.VisualMap._fields:
        assert torch.equal(getattr(vm_shared, name), getattr(vm_phase, name)), name
