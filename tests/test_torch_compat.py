"""Port parity for the JAX package's small public compat functions:
`ops/image.shi_tomasi`, `ops/image.patch_residual_grad`,
`maps/voxel_map.surfel_plane`, `io/synthetic.make_world` and
`state.flatten_nominal`.

Tolerances: bilinear samples and their central differences within 1e-4
(intensities up to 1e2, f32); Shi-Tomasi scores within 1e-4 relative (sums
of squared differences in another order); `surfel_plane` as
`test_torch_voxel_map.test_surfel_lookup` (validity exact, normals and
offsets within 1e-4 on 98% of the slots); `make_world` (NumPy in both)
and `flatten_nominal` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from fastlivo_tpu import state as JST
from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.ops import image as JI
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import state as TST
from fastlivo_tpu_torch.io import synthetic as TSYN
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.ops import image as TI

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def image_and_centers():
    rng = np.random.default_rng(3)
    img = gaussian_filter(rng.uniform(0, 255, (96, 128)), 2.0).astype(np.float32)
    # Centers inside, on the border and outside the image (zero taps).
    centers = np.concatenate([rng.uniform([0, 0], [128, 96], (200, 2)),
                              [[0.0, 0.0], [127.9, 95.9], [-3.2, 40.0], [130.5, 10.0]]]).astype(np.float32)
    return img, centers


def test_shi_tomasi(image_and_centers):
    img, centers = image_and_centers
    want = np.asarray(JI.shi_tomasi(jnp.asarray(img), jnp.asarray(centers)))
    got = TI.shi_tomasi(torch.as_tensor(img), torch.as_tensor(centers)).numpy()
    assert got.shape == want.shape == (len(centers),)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("scale", [1, 2, "per_point"])
def test_patch_residual_grad(image_and_centers, scale):
    img, centers = image_and_centers
    if scale == "per_point":
        scale = np.random.default_rng(0).choice([1.0, 2.0, 4.0], len(centers)).astype(np.float32)
    want = JI.patch_residual_grad(jnp.asarray(img), jnp.asarray(centers), 8, jnp.asarray(scale))
    got = TI.patch_residual_grad(torch.as_tensor(img), torch.as_tensor(centers), 8, torch.as_tensor(scale))
    for a, b in zip(got, want):
        assert a.shape == b.shape == (len(centers), 64)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_surfel_plane():
    cfg_j = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 11, max_points=8)
    cfg_t = TV.VoxelMapConfig(resolution=0.5, capacity=1 << 11, max_points=8)
    rng = np.random.default_rng(5)
    n = 3000
    u = rng.uniform(-3, 3, (n, 2))
    face = rng.integers(0, 3, n)
    p = np.zeros((n, 3))
    p[face == 0] = np.c_[u[face == 0], np.full((face == 0).sum(), -1.4)]
    p[face == 1] = np.c_[np.full((face == 1).sum(), 2.6), u[face == 1]]
    p[face == 2] = np.c_[u[face == 2, 0], np.full((face == 2).sum(), -2.7), u[face == 2, 1]]
    p = (p + rng.normal(scale=0.01, size=p.shape)).astype(np.float32)
    jm = jax.jit(JV.insert, static_argnames=("cfg",))(JV.make_map(cfg_j), jnp.asarray(p), jnp.ones(n, bool), cfg_j)
    d = {k: np.asarray(v) for k, v in jm._asdict().items()}
    tm = convert.voxel_map_from_numpy(d, "cpu")
    # Every slot, the occupied ones flagged (empty slots exercise `has`).
    slots = np.arange(cfg_j.capacity, dtype=np.int32)
    has = np.asarray(jm.occupied)
    assert has.sum() > 50 and not has.all()
    want = JV.surfel_plane(jm, jnp.asarray(slots), jnp.asarray(has), cfg_j)
    got = TV.surfel_plane(tm, torch.as_tensor(slots), torch.as_tensor(has), cfg_t)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() > 50
    dn = np.abs(got.normal.numpy() - np.asarray(want.normal)).max(axis=1)
    assert np.mean(dn <= 1e-4) >= 0.98 and dn.max() <= 1e-2
    dd = np.abs(got.d.numpy() - np.asarray(want.d))
    assert np.mean(dd <= 1e-4) >= 0.98 and dd.max() <= 3e-2
    np.testing.assert_allclose(got.n_pts.numpy(), np.asarray(want.n_pts), rtol=1e-5)


@pytest.mark.parametrize("n,half", [(60000, 10.0), (1001, 6.0)])
def test_make_world(n, half):
    want = JSYN.make_world(np.random.default_rng(9), n, half)
    got = TSYN.make_world(np.random.default_rng(9), n, half)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 3)
    assert np.array_equal(got, want)


def test_flatten_nominal():
    rng = np.random.default_rng(2)
    fields = {k: rng.normal(size=s).astype(np.float32) for k, s in
              (("rot", (3, 3)), ("pos", (3,)), ("vel", (3,)), ("bg", (3,)), ("ba", (3,)), ("grav", (3,)),
               ("cov", (18, 18)))}
    want = np.asarray(JST.flatten_nominal(JST.NavState(**{k: jnp.asarray(v) for k, v in fields.items()})))
    got = TST.flatten_nominal(convert.nav_state_from_numpy(fields, "cpu")).numpy()
    assert got.shape == want.shape == (24,)
    assert np.array_equal(got, want)
