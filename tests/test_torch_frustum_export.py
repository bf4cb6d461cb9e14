"""Port parity for frustum culling (ops/frustum.py) and the colorized cloud
export (io/export.colorize_cloud), on the CPU against the JAX package.

The frustum masks are exact on seeded random points and boxes (and on
tests/test_frustum_export.py's cases). `colorize_cloud` gives the same
visible mask and values within 1e-4 intensity units, for a mono frame
and a three-channel one, with f64 and f32 poses; the two packages take
the camera transform in a different order (a matrix product in NumPy,
elementwise products in the port), so a value may differ in its last
bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.io import export as JEXP
from fastlivo_tpu.io import render as JR
from fastlivo_tpu.ops import frustum as JFR
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu_torch.io import export as TEXP
from fastlivo_tpu_torch.ops import frustum as TFR
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole

VAL_TOL = 1e-4


def test_points_in_fov_exact():
    rng = np.random.default_rng(41)
    pts = np.concatenate([
        rng.uniform(-30, 30, (4000, 3)),
        [[5.0, 0, 0], [5.0, 0.5, 0], [5.0, 8.0, 0], [-5.0, 0, 0], [50.0, 0, 0], [0.0, 0.0, 0.0]],
    ]).astype(np.float32)
    for origin, axis, half, dist in (
        ([0, 0, 0], [1, 0, 0], 0.3, 20.0),
        ([1.5, -2.0, 0.5], [0.6, 0.8, 0.0], 0.8, 12.0),
        ([0, 0, 1], [0, 0, -1], 1.2, 40.0),
    ):
        o, a = np.asarray(origin, np.float32), np.asarray(axis, np.float32)
        got = TFR.points_in_fov(torch.from_numpy(pts), torch.from_numpy(o), torch.from_numpy(a), half, dist)
        want = JFR.points_in_fov(jnp.asarray(pts), jnp.asarray(o), jnp.asarray(a), half, dist)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < len(pts)
    first = TFR.points_in_fov(torch.from_numpy(pts[-6:-1]), torch.zeros(3), torch.tensor([1.0, 0, 0]), 0.3, 20.0)
    assert first.tolist() == [True, True, False, False, False]


def test_boxes_intersect_fov_exact():
    rng = np.random.default_rng(42)
    c = rng.uniform(-25, 25, (3000, 3))
    half = rng.uniform(0.1, 3.0, (3000, 3))
    bmin = np.concatenate([c - half, [[4.0, -1, -1], [4.0, 30, -1], [-0.5, -0.5, -0.5]]]).astype(np.float32)
    bmax = np.concatenate([c + half, [[6.0, 1, 1], [6.0, 32, 1], [0.5, 0.5, 0.5]]]).astype(np.float32)
    for origin, axis, ang, dist in (([0, 0, 0], [1, 0, 0], 0.3, 20.0), ([2, 1, 0], [0, 0.6, 0.8], 0.9, 15.0)):
        o, a = np.asarray(origin, np.float32), np.asarray(axis, np.float32)
        got = TFR.boxes_intersect_fov(torch.from_numpy(bmin), torch.from_numpy(bmax), torch.from_numpy(o),
                                      torch.from_numpy(a), ang, dist)
        want = JFR.boxes_intersect_fov(jnp.asarray(bmin), jnp.asarray(bmax), jnp.asarray(o), jnp.asarray(a),
                                       ang, dist)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < len(bmin)
    apex = TFR.boxes_intersect_fov(torch.from_numpy(bmin[-3:]), torch.from_numpy(bmax[-3:]), torch.zeros(3),
                                   torch.tensor([1.0, 0, 0]), 0.3, 20.0)
    assert apex.tolist() == [True, False, True]  # on axis, off axis, around the apex


CAM = (160, 128, 100.0, 100.0, 80.0, 64.0)


@pytest.fixture(scope="module")
def frame():
    """A rendered room frame looking along world +y, its pose and a cloud
    that spans the frustum's borders and the space behind the camera."""
    rcw = np.asarray([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    pcw = -rcw @ np.array([0.3, -0.2, 0.1])
    cam = JPinhole(*CAM)
    img = np.asarray(jax.jit(JR.render_room, static_argnames="cam")(
        cam, jnp.asarray(rcw, jnp.float32), jnp.asarray(pcw, jnp.float32)))
    rng = np.random.default_rng(43)
    pts = np.concatenate([
        rng.uniform([-12, -12, -2], [12, 12, 4], (20000, 3)),
        [[0.0, 5.0, 0.0], [0.5, 5.0, 0.2], [0.0, -5.0, 0.0]],
    ]).astype(np.float32)
    return rcw, pcw, img, pts


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("pose_dtype", [np.float64, np.float32])
def test_colorize_cloud_matches_jax(frame, channels, pose_dtype):
    rcw, pcw, img, pts = frame
    rcw, pcw = rcw.astype(pose_dtype), pcw.astype(pose_dtype)
    if channels == 3:
        img = np.stack([img, 255.0 - img, 0.5 * img], axis=-1).astype(np.float32)
    got_v, got_m = TEXP.colorize_cloud(pts, img, rcw, pcw, TPinhole(*CAM), device="cpu")
    want_v, want_m = JEXP.colorize_cloud(pts, img, rcw, pcw, JPinhole(*CAM))
    assert got_m.dtype == bool and got_v.dtype == np.float32
    assert got_v.shape == np.asarray(want_v).shape
    np.testing.assert_array_equal(got_m, want_m)
    assert 100 < got_m.sum() < len(pts)
    np.testing.assert_allclose(got_v[got_m], np.asarray(want_v)[got_m], rtol=0, atol=VAL_TOL)
    assert got_m[-3:].tolist() == [True, True, False]
    assert np.all(got_v[got_m] >= 0)
