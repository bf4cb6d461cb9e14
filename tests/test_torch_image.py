"""Port parity: image ops and the window-extraction kernel's plain version.

The port's `extract_windows` (CPU: its plain index-grid gather) must equal
the JAX package's XLA path and the Pallas TPU kernel run in interpret mode
bitwise — a window copy has no arithmetic to round. The samplers built on
it repeat the JAX arithmetic in the same order; their tolerances below
allow for f32 rounding in 0-255 intensity units.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fastlivo_tpu.io import render as j_render
from fastlivo_tpu.ops import image as J
from fastlivo_tpu.ops import pallas_windows as JPW
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu_torch.io import render as t_render
from fastlivo_tpu_torch.ops import image as T
from fastlivo_tpu_torch.ops import pallas_windows as TPW
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole

torch.set_num_threads(1)

PAD = 32
H, W = 96, 128


def _img(seed, h=H, w=W):
    return np.random.default_rng(seed).uniform(0, 255, (h, w)).astype(np.float32)


def _origins(seed, n, win):
    """Corners in unpadded coords, first four pushed off all four sides."""
    rng = np.random.default_rng(seed)
    o = rng.integers(-PAD - 20, [W + 20, H + 20], size=(n, 2))
    edge = [(-PAD - 15, 10), (W + 10, 20), (30, -PAD - 9), (40, H + 12)]
    k = min(n, 4)
    o[:k] = edge[:k]
    return o.astype(np.int32)


def _pallas_interpret(img_pad, starts, win):
    """The Pallas TPU kernel body under interpret mode, as
    tests/test_image.py runs it."""
    n = starts.shape[0]
    bh, bw = JPW._block_dims(win)
    hp, wp = img_pad.shape
    hp2 = JPW._round_up(hp - win + bh, JPW._SUB)
    wp2 = JPW._round_up(wp - win + bw, JPW._LANE)
    img_big = np.pad(img_pad, ((0, max(hp2 - hp, 0)), (0, max(wp2 - wp, 0))))
    return np.asarray(
        pl.pallas_call(
            functools.partial(JPW._window_kernel, win=win, n=n),
            out_shape=jax.ShapeDtypeStruct((n, win, win), jnp.float32),
            interpret=True,
        )(jnp.asarray(starts), jnp.asarray(img_big))
    )


@pytest.mark.parametrize("n", [1, 17, 208])
@pytest.mark.parametrize("win", [13, 30, 38])
def test_extract_windows_bitwise(win, n):
    img_pad = np.pad(_img(win * 1000 + n), PAD)
    origins = _origins(win + n, n, win)
    got = T.extract_windows(torch.from_numpy(img_pad), torch.from_numpy(origins), win, PAD).numpy()
    want_xla = np.asarray(J.extract_windows(jnp.asarray(img_pad), jnp.asarray(origins), win, PAD))
    np.testing.assert_array_equal(got, want_xla)

    hp, wp = img_pad.shape
    starts = np.stack(
        [np.clip(origins[:, 0] + PAD, 0, wp - win), np.clip(origins[:, 1] + PAD, 0, hp - win)], -1
    ).astype(np.int32)
    np.testing.assert_array_equal(got, _pallas_interpret(img_pad, starts, win))


def test_extract_windows_cpu_never_launches_kernel():
    before = TPW.LAUNCHES["extract_windows"]
    T.extract_windows(torch.zeros((40, 40)), torch.zeros((3, 2), dtype=torch.int32), 8, 4)
    assert TPW.LAUNCHES["extract_windows"] == before


def test_extract_windows_wrapper_rejects_bad_inputs():
    img = torch.zeros((40, 40))
    with pytest.raises(ValueError):
        TPW.extract_windows(img.double(), torch.zeros((3, 2), dtype=torch.int32), 8)
    with pytest.raises(ValueError):
        TPW.extract_windows(img, torch.zeros((3, 2), dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        TPW.extract_windows(img, torch.zeros((3, 2), dtype=torch.int32), 41)


def _centers(seed, n):
    """Interior centers plus four hugging the borders (window clamping)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(2.0, [W - 2.0, H - 2.0], size=(n, 2))
    c[:4] = [[1.3, 2.7], [W - 1.2, 3.1], [2.2, H - 1.6], [W - 2.5, H - 1.1]]
    return c.astype(np.float32)


@pytest.mark.parametrize("grad", [False, True])
def test_strided_patch_sample(grad):
    # Same arithmetic in the same order: differences are f32 rounding only
    # (atol 1e-3 in 0-255 intensity units, and per px for gradients).
    img_pad = np.pad(_img(3), PAD)
    n = 64
    centers = _centers(4, n)
    strides = np.random.default_rng(5).choice([1, 2, 4], n).astype(np.int32)
    gu = (strides * 2.0).astype(np.float32) if grad else None
    got = T.strided_patch_sample(
        torch.from_numpy(img_pad), torch.from_numpy(centers), torch.from_numpy(strides), 8, PAD,
        grad_units=None if gu is None else torch.from_numpy(gu),
    )
    want = J.strided_patch_sample(
        jnp.asarray(img_pad), jnp.asarray(centers), jnp.asarray(strides), 8, PAD,
        grad_units=None if gu is None else jnp.asarray(gu),
    )
    got = (got,) if not grad else got
    want = (want,) if not grad else want
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-3)


def test_strided_patch_sample_single_stride_set():
    img_pad = np.pad(_img(6), PAD)
    centers = _centers(7, 32)
    ones = np.ones(32, np.int32)
    got = T.strided_patch_sample(
        torch.from_numpy(img_pad), torch.from_numpy(centers), torch.from_numpy(ones), 12, PAD,
        stride_set=(1,),
    )
    want = J.strided_patch_sample(
        jnp.asarray(img_pad), jnp.asarray(centers), jnp.asarray(ones), 12, PAD, stride_set=(1,)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3)


def test_build_pyramid():
    # Four taps summed in the reduce_window's order, then * 0.25.
    img = _img(8, 97, 131)  # odd sizes exercise the crop
    got = T.build_pyramid(torch.from_numpy(img), 3)
    want = J.build_pyramid(jnp.asarray(img), 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_shi_tomasi_dense():
    # The 8x8 box sums run in another order than XLA's reduce_window; the
    # sums reach ~1e6 for this noise image, so allow 1e-6 of the score
    # range (f32 has ~6e-8 relative precision per add, 64 adds).
    img = _img(9)
    got = T.shi_tomasi_dense(torch.from_numpy(img)).numpy()
    want = np.asarray(J.shi_tomasi_dense(jnp.asarray(img)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_sample_patch_grid():
    # The port gathers the four taps where JAX builds a one-hot matvec:
    # same weights and taps, four-term sums rounded in another order.
    rng = np.random.default_rng(10)
    patches = rng.uniform(0, 255, (24, 12, 12)).astype(np.float32)
    coords = rng.uniform(-1.0, 12.0, (24, 64, 2)).astype(np.float32)
    got = T.sample_patch_grid(torch.from_numpy(patches), torch.from_numpy(coords)).numpy()
    want = np.asarray(J.sample_patch_grid(jnp.asarray(patches), jnp.asarray(coords)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_patch_grid_and_pad():
    np.testing.assert_array_equal(T.patch_grid(8).numpy(), np.asarray(J.patch_grid(8)))
    img = _img(11, 10, 12)
    np.testing.assert_array_equal(
        T.pad_image(torch.from_numpy(img), 3).numpy(), np.asarray(J.pad_image(jnp.asarray(img), 3))
    )


def test_render_room_matches():
    # Procedural texture of ray hits: sin/cos of f32 arguments up to ~1e2
    # differ by an ulp or so between XLA and torch; 0.05 intensity units.
    cam_j = JPinhole(160, 128, 100.0, 100.0, 80.0, 64.0)
    cam_t = TPinhole(160, 128, 100.0, 100.0, 80.0, 64.0)
    rcw = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]], np.float32)
    pcw = (-rcw @ np.array([0.7, 0.3, 0.1], np.float32)).astype(np.float32)
    got = t_render.render_room(cam_t, torch.from_numpy(rcw), torch.from_numpy(pcw), half=8.0)
    want = j_render.render_room(cam_j, jnp.asarray(rcw), jnp.asarray(pcw), half=8.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=0.05)
