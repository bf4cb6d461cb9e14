"""Port parity: the batched plane fit (`ops/plane.esti_plane`) and the
voxel-stencil kNN (`maps/voxel_map.knn`) against the JAX package.

Plane fits: normals and offsets within atol 1e-5 on well-conditioned
neighbor sets (the port solves the normal equations about the neighbors'
mean, JAX on the raw Gram; in f32 the two differ by ~1e-7 relative there),
valid bits exactly, including the zero, non-planar and partly invalid
sets. On far walls, where the raw Gram's condition number reaches 1e7, the
port's f32 fit is held to a float64 least-squares fit instead.

kNN: one map built by the JAX insert and carried over. Valid flags
exactly, neighbor points exactly where valid (same slab data, same
ordering of equal distances), d2 within 1e-6 where valid. The queries sit
on an exact binary grid, so many candidate distances tie exactly; some
queries lie in empty space (empty voxels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.ops import plane as JPL
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.ops import plane as TPL

torch.set_num_threads(1)


def plane_sets(rng, n=512, k=5):
    """Well-conditioned neighbor sets: random planes at |d| in [0.5, 1.5]
    with 1 m of spread and 2 mm noise; then zero, non-planar and partly
    invalid sets.

    Far from the origin, with little spread (a LiDAR's 5 m wall patch of
    0.3 m), the JAX package's f32 normal equations lose the normal (~1e-2)
    where the port's centred ones keep it; such sets are held to a float64
    fit in `test_esti_plane_far_walls_match_float64`, not to JAX, here.
    Nor is a set of k equal points used: its Gram is singular only up to
    rounding, so its valid bit follows the rounding."""
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    d = rng.uniform(0.5, 1.5, n) * rng.choice([-1.0, 1.0], n)
    center = -d[:, None] * normal
    t1 = np.cross(normal, rng.normal(size=(n, 3)))
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(normal, t1)
    a, b = rng.uniform(-1.0, 1.0, (2, n, k))
    pts = center[:, None] + a[..., None] * t1[:, None] + b[..., None] * t2[:, None]
    pts += rng.normal(scale=0.002, size=pts.shape)
    valid = np.ones((n, k), bool)
    # degenerate: zero padding (an exactly singular Gram)
    pts[0:8] = 0.0
    # non-planar: two points 0.5 m off the plane on either side
    pts[8:40, 2] += 0.5 * normal[8:40]
    pts[8:40, 3] -= 0.5 * normal[8:40]
    # a missing neighbor
    valid[40:60, 4] = False
    return pts.astype(np.float32), valid


def test_esti_plane_matches_jax():
    pts, valid = plane_sets(np.random.default_rng(0))
    jn, jd, jv = jax.jit(JPL.esti_plane, static_argnames="threshold")(
        jnp.asarray(pts), jnp.asarray(valid), threshold=0.1
    )
    tn, td, tv = TPL.esti_plane(torch.tensor(pts), torch.tensor(valid), 0.1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 400 < int(tv.sum()) < 480  # the bad sets are rejected, the rest accepted
    assert not tv[:8].any() and not tv[40:60].any()
    assert int(tv[8:40].sum()) <= 4  # a few bent sets still fit some other plane
    # Gram condition number below 100: f32 rounding moves the normal by
    # ~1e-7 x cond, well inside 1e-5.
    g = np.einsum("nki,nkj->nij", pts.astype(np.float64), pts.astype(np.float64))
    well = np.linalg.cond(g) < 100
    assert well.sum() > 350
    np.testing.assert_allclose(tn.numpy()[well], np.asarray(jn)[well], atol=1e-5)
    np.testing.assert_allclose(td.numpy()[well], np.asarray(jd)[well], atol=1e-5)


def far_walls(rng, n=20000, k=5):
    """LiDAR wall patches in f32: planes 2-15 m from the origin seen up to
    3 m off their foot, k points within a 0.3 m square, 1 cm of noise."""
    normal = rng.normal(size=(n, 3))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    t1 = np.cross(normal, rng.normal(size=(n, 3)))
    t1 /= np.linalg.norm(t1, axis=1, keepdims=True)
    t2 = np.cross(normal, t1)
    off = rng.uniform(-3.0, 3.0, (2, n, 1))
    center = -rng.uniform(2.0, 15.0, (n, 1)) * normal + off[0] * t1 + off[1] * t2
    a, b = rng.uniform(-0.15, 0.15, (2, n, k))
    pts = center[:, None] + a[..., None] * t1[:, None] + b[..., None] * t2[:, None]
    pts += rng.normal(scale=0.01, size=pts.shape)
    return pts.astype(np.float32)


def lstsq_planes(pts, threshold=0.1):
    """The same estimator in float64: least squares of A x = -1 on the f32
    points, normalized, gated on det(A^T A) and the largest residual."""
    p = pts.astype(np.float64)
    g = np.einsum("nki,nkj->nij", p, p)
    x = np.linalg.solve(g, -p.sum(1)[..., None])[..., 0]
    norm = np.linalg.norm(x, axis=1)
    n, d = x / norm[:, None], 1.0 / norm
    resid = np.abs(np.einsum("nki,ni->nk", p, n) + d[:, None])
    return n, d, (resid <= threshold).all(1) & (np.linalg.det(g) > 1e-12)


def test_esti_plane_far_walls_match_float64():
    pts = far_walls(np.random.default_rng(4))
    rn, rd, rv = lstsq_planes(pts)
    t = torch.tensor(pts)
    tn, td, tv = (x.numpy() for x in TPL.esti_plane(t, torch.ones(pts.shape[:2], dtype=torch.bool), 0.1))
    np.testing.assert_array_equal(tv, rv)
    assert rv.all()
    # Rounding moves the normal by ~6e-8 x lambda3 / lambda2 of the
    # neighbors' scatter, and d by the normal's error times the distance
    # (<= 18 m) plus the mean's rounding: compared where the points span a
    # plane (lambda2 >= lambda3 / 10, ~85% of the sets), not a line.
    p = pts.astype(np.float64)
    q = p - p.mean(1, keepdims=True)
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", q, q))
    spread = lam[:, 1] >= 0.1 * lam[:, 2]
    assert spread.mean() > 0.8
    np.testing.assert_allclose(tn[spread], rn[spread], rtol=0, atol=2e-6)
    np.testing.assert_allclose(td[spread], rd[spread], rtol=0, atol=8e-6)
    # The raw Gram's adjugate (the JAX package's form) misses them.
    gx, _ = TPL._solve3(t.transpose(1, 2) @ t, -t.sum(1))
    gn = (gx / torch.linalg.vector_norm(gx, dim=-1, keepdim=True)).numpy()
    assert np.median(np.abs(gn - rn).max(1)[spread]) > 1e-2


def test_solve3_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(256, 3, 3)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32)  # well conditioned
    b = rng.normal(size=(256, 3)).astype(np.float32)
    jx, jdet = JPL._solve3(jnp.asarray(a), jnp.asarray(b))
    tx, tdet = TPL._solve3(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(tdet.numpy(), np.asarray(jdet), rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.linalg.solve(a, b[..., None])[..., 0], rtol=1e-3, atol=1e-4)


JMAP = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 12, max_points=8, nearby_type=18)
TMAP = TV.VoxelMapConfig(resolution=0.5, capacity=1 << 12, max_points=8, nearby_type=18)


@pytest.fixture(scope="module")
def grid_map():
    """Points on a 0.125 m grid (exact in binary) in a 3 m block, each
    point twice (duplicate distances), inserted by the JAX package."""
    ax = np.arange(-1.5, 1.5, 0.125, dtype=np.float32)
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3) + 0.0625
    pts = np.concatenate([g, g])
    rng = np.random.default_rng(2)
    pts = pts[rng.permutation(len(pts))]
    m = JV.make_map(JMAP)
    ins = jax.jit(JV.insert, static_argnames="cfg")
    for chunk in np.array_split(pts, 8):
        m = ins(m, jnp.asarray(chunk), jnp.ones(len(chunk), bool), JMAP)
    return {k: np.asarray(v) for k, v in m._asdict().items()}


@pytest.mark.parametrize("k,max_dist2", [(5, 25.0), (8, 0.05)])
def test_knn_matches_jax(grid_map, k, max_dist2):
    rng = np.random.default_rng(3)
    on_grid = rng.integers(-14, 14, (300, 3)).astype(np.float32) * 0.125  # grid corners: 8-way ties
    off_grid = rng.uniform(-1.6, 1.6, (300, 3)).astype(np.float32)
    empty = rng.uniform(4.0, 6.0, (40, 3)).astype(np.float32)  # no map voxel near
    q = np.concatenate([on_grid, off_grid, empty])
    jm = JV.VoxelHashMap(**{kk: jnp.asarray(v) for kk, v in grid_map.items()})
    jp, jd, jv = jax.jit(JV.knn, static_argnames=("cfg", "k", "max_dist2"))(
        jm, jnp.asarray(q), JMAP, k=k, max_dist2=max_dist2
    )
    tp, td, tv = TV.knn(convert.voxel_map_from_numpy(grid_map, "cpu"), torch.tensor(q), TMAP, k, max_dist2)
    jp, jd, jv = np.asarray(jp), np.asarray(jd), np.asarray(jv)
    tp, td, tv = tp.numpy(), td.numpy(), tv.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert not tv[-40:].any()  # empty space: no neighbor
    assert tv[:600].mean() > (0.9 if max_dist2 > 1.0 else 0.1)
    np.testing.assert_array_equal(tp[tv], jp[jv])
    np.testing.assert_allclose(td[tv], jd[jv], atol=1e-6)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    # exact ties are present and resolved alike
    near = td[:300][np.isfinite(td[:300]).all(axis=1)]
    assert (np.diff(near, axis=1) == 0).any()
