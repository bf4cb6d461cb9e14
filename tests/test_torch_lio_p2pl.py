"""Port parity: the point-to-plane and VGICP LIO models (innovations,
scan source covariances, the map-insert gate and the iterated update)
against the JAX package, on one map built by the JAX insert.

The scene is six separate patches of a small room, within 1.2 m of the
origin, and the map holds them on a 0.3 m grid, so each fit's five
neighbors span ~0.5 m on one plane and the fit is well conditioned. The
f32 normal equations of a fit lose ~1e-7 x cond of accuracy, each
package in its own way, so a valid bit whose residual comes near the gate
follows the rounding (tests/test_torch_plane_knn.py): five neighbors
within 0.1 m of each other on a wall 2 m away give cond ~1e5 and
residual errors of ~0.1, and a neighbor set across a corner puts
residuals at the gate too. With the same
neighbor cache, effective counts and gates match exactly; the 6x6 sums
agree to rtol 1e-4 (f32 sums over ~2,000 rows in another order); the
posterior to 1e-4 m and rad, with the same iteration count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models import lio as JL
from fastlivo_tpu.ops import so3 as JSO3
from fastlivo_tpu.ops import voxelize as JX
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models import lio as TL

torch.set_num_threads(1)

JMAP = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 13, max_points=32, nearby_type=18)
TMAP = TV.VoxelMapConfig(resolution=0.5, capacity=1 << 13, max_points=32, nearby_type=18)
TRUE_OFFSET = np.array([0.04, -0.03, 0.02])
N_RAW, N_DS = 8192, 4096


PATCHES = ((2, -0.8), (2, 1.0), (0, -1.2), (0, 1.2), (1, -1.2), (1, 1.2))
PATCH_LO = np.array([-0.9, -0.9, -0.5])
PATCH_HI = np.array([0.9, 0.9, 0.7])


def room(rng, n=None, spacing=None):
    """Points on six separate patches of a small room: floor z = -0.8 and
    ceiling z = 1.0, walls x, y = +-1.2, each patch 1.8 m wide (1.2 m
    tall for the walls). `n` random points, or a grid of `spacing` jittered
    in the plane."""
    out = []
    for axis, val in PATCHES:
        others = [a for a in range(3) if a != axis]
        lo, hi = PATCH_LO[others], PATCH_HI[others]
        if spacing is None:
            uv = rng.uniform(lo, hi, (n // 6, 2))
        else:
            g = np.meshgrid(*(np.arange(a, b, spacing) for a, b in zip(lo, hi)), indexing="ij")
            uv = np.stack([x.ravel() for x in g], -1)
            uv = uv + rng.uniform(-0.2, 0.2, uv.shape) * spacing
        p = np.empty((len(uv), 3))
        p[:, axis] = val
        p[:, others] = uv
        out.append(p)
    w = np.concatenate(out)
    if n is not None:
        w = np.concatenate([w, w[: n - len(w)]])
    return w.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    """A map of the room on a 0.3 m grid, then a dense scan seen from a
    pose TRUE_OFFSET / 0.02 rad yaw off the identity prior, downsampled."""
    rng = np.random.default_rng(5)
    m = JV.make_map(JMAP)
    ins = jax.jit(JV.insert, static_argnames="cfg")
    down = jax.jit(JX.voxel_downsample, static_argnames=("leaf", "out_size"))
    grid = room(rng, spacing=0.3)
    m = ins(m, jnp.asarray(grid), jnp.ones(len(grid), bool), JMAP)
    yaw = np.asarray(JSO3.exp(jnp.asarray([0.0, 0.0, 0.02], jnp.float32)), np.float64)
    body = (room(rng, N_RAW) - TRUE_OFFSET) @ yaw  # p_w = R p_b + t
    ds, ds_mask = down(jnp.asarray(body, jnp.float32), jnp.ones(N_RAW, bool), 0.15, N_DS)
    state = dict(
        rot=np.eye(3, dtype=np.float32), pos=np.zeros(3, np.float32), vel=np.zeros(3, np.float32),
        bg=np.zeros(3, np.float32), ba=np.zeros(3, np.float32),
        grav=np.array([0.0, 0.0, -9.81], np.float32), cov=(np.eye(18) * 1e-3).astype(np.float32),
    )
    mapd = {k: np.asarray(v) for k, v in m._asdict().items()}
    return mapd, state, np.asarray(ds), np.asarray(ds_mask)


def jmap(mapd):
    return JV.VoxelHashMap(**{k: jnp.asarray(v) for k, v in mapd.items()})


def inputs(st, ds, mask):
    i3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (st["rot"], st["pos"], ds, mask)
    return [jnp.asarray(a) for a in args] + [jnp.asarray(i3), jnp.asarray(z3)], [
        torch.tensor(a) for a in args
    ] + [torch.tensor(i3), torch.tensor(z3)]


@pytest.fixture(scope="module")
def neighbors(case):
    """The JAX kNN cache at the prior, as both packages' search would give."""
    mapd, st, ds, mask = case
    jcfg = JL.LioConfig()
    _, p_w = JL.transform_to_world(jnp.asarray(ds), jnp.asarray(st["rot"]), jnp.asarray(st["pos"]),
                                   jnp.eye(3), jnp.zeros(3))
    nbr, _, nv = jax.jit(JV.knn, static_argnames=("cfg", "k", "max_dist2"))(
        jmap(mapd), p_w, JMAP, k=jcfg.num_match_points, max_dist2=jcfg.max_search_dist2
    )
    nv = nv & jnp.asarray(mask)[:, None]
    return np.asarray(nbr), np.asarray(nv)


def assert_sums(got, want):
    hth_t, hty_t, n_t, res_t = got
    hth_j, hty_j, n_j, res_j = (np.asarray(x) for x in want)
    assert int(n_t) == int(n_j) > 500
    scale = np.abs(hth_j).max()
    np.testing.assert_allclose(hth_t.numpy(), hth_j, rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(hty_t.numpy(), hty_j, rtol=1e-4, atol=1e-4 * np.abs(hty_j).max())
    np.testing.assert_allclose(float(res_t), float(res_j), rtol=1e-4)


def test_point_to_plane_innovation(case, neighbors):
    mapd, st, ds, mask = case
    nbr, nv = neighbors
    j_in, t_in = inputs(st, ds, mask)
    cfg_j, cfg_t = JL.LioConfig(), TL.LioConfig()
    want = JL._innovation(*j_in[:4], jnp.asarray(nbr), jnp.asarray(nv), *j_in[4:], cfg_j)
    got = TL._innovation(*t_in[:4], torch.tensor(nbr), torch.tensor(nv), *t_in[4:], cfg_t)
    assert_sums(got, want)


def test_scan_source_covariances(case):
    _, _, ds, mask = case
    want = np.asarray(jax.jit(JL.scan_source_covariances, static_argnames="cfg")(
        jnp.asarray(ds), jnp.asarray(mask), JL.LioConfig()
    ))
    got = TL.scan_source_covariances(torch.tensor(ds), torch.tensor(mask), TL.LioConfig()).numpy()
    assert got.shape == want.shape == (N_DS, 3, 3)
    # The plane-regularized form s (I - (1 - eps) n n^T): n is the smallest
    # eigenvector of each 8-neighbor covariance. Where the two smallest
    # eigenvalues nearly coincide (at room corners) the closed-form
    # eigenvector follows the rounding (ROADMAP.md section 3), so 99% of
    # the points must agree to 1e-5 of the scale s = 0.01, and every point
    # to a unit rotation of n (2 x s).
    err = np.abs(got - want).max(axis=(1, 2))
    assert np.mean(err < 1e-7) > 0.99, np.sort(err)[-20:]
    assert err.max() <= 2 * TL.LioConfig().vgicp_source_cov
    iso = TL.LioConfig().vgicp_source_cov * np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal((got == iso).all(axis=(1, 2)), (want == iso).all(axis=(1, 2)))


@pytest.mark.parametrize("mode", ["isotropic", "neighborhood"])
def test_vgicp_innovation(case, neighbors, mode):
    mapd, st, ds, mask = case
    nbr, nv = neighbors
    j_in, t_in = inputs(st, ds, mask)
    cfg_j = JL.LioConfig(measurement_model="vgicp", vgicp_source_mode=mode)
    cfg_t = TL.LioConfig(measurement_model="vgicp", vgicp_source_mode=mode)
    src = None
    if mode == "neighborhood":  # the same source covariances for both
        src = np.asarray(jax.jit(JL.scan_source_covariances, static_argnames="cfg")(
            jnp.asarray(ds), jnp.asarray(mask), cfg_j
        ))
    want = JL._innovation_vgicp(
        *j_in[:4], jnp.asarray(nbr), jnp.asarray(nv), *j_in[4:], cfg_j,
        src_cov=None if src is None else jnp.asarray(src),
    )
    got = TL._innovation_vgicp(
        *t_in[:4], torch.tensor(nbr), torch.tensor(nv), *t_in[4:], cfg_t,
        src_cov=None if src is None else torch.tensor(src),
    )
    assert_sums(got, want)


def test_map_insert_gate(case, neighbors):
    _, st, ds, mask = case
    nbr, nv = neighbors
    _, p_w = JL.transform_to_world(jnp.asarray(ds), jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3))
    p_w = np.asarray(p_w)
    want = np.asarray(JL.map_insert_gate(jnp.asarray(p_w), jnp.asarray(mask), jnp.asarray(nbr),
                                         jnp.asarray(nv), 0.3))
    got = TL.map_insert_gate(torch.tensor(p_w), torch.tensor(mask), torch.tensor(nbr),
                             torch.tensor(nv), 0.3).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < mask.sum()


@pytest.mark.parametrize("model", ["point_to_plane", "vgicp"])
def test_lio_update(case, model):
    mapd, st, ds, mask = case
    i3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    jcfg, tcfg = JL.LioConfig(measurement_model=model), TL.LioConfig(measurement_model=model)
    jpost, jinfo, (jnbr, jnv) = jax.jit(
        JL.lio_update, static_argnames=("map_cfg", "cfg", "axis_name", "map_axis")
    )(
        JNav(**{k: jnp.asarray(v) for k, v in st.items()}), jmap(mapd),
        jnp.asarray(ds), jnp.asarray(mask), jnp.asarray(i3), jnp.asarray(z3), JMAP, jcfg,
    )
    tpost, tinfo, (tnbr, tnv) = TL.lio_update(
        convert.nav_state_from_numpy(st, "cpu"), convert.voxel_map_from_numpy(mapd, "cpu"),
        torch.tensor(ds), torch.tensor(mask), torch.tensor(i3), torch.tensor(z3), TMAP, tcfg,
    )
    assert int(tinfo.iterations) == int(jinfo.iterations) >= 2
    assert bool(tinfo.converged) == bool(jinfo.converged)
    assert int(tinfo.n_effective) == int(jinfo.n_effective) > 500
    np.testing.assert_allclose(tpost.pos.numpy(), np.asarray(jpost.pos), atol=1e-4)
    np.testing.assert_allclose(tpost.rot.numpy(), np.asarray(jpost.rot), atol=1e-4)
    # The returned neighbor cache (reused by the insert gate).
    np.testing.assert_array_equal(tnv.numpy(), np.asarray(jnv))
    np.testing.assert_array_equal(tnbr.numpy()[tnv.numpy()], np.asarray(jnbr)[np.asarray(jnv)])
    # The update moves the estimate most of the way to the true pose.
    assert np.linalg.norm(tpost.pos.numpy() - TRUE_OFFSET) < 0.5 * np.linalg.norm(TRUE_OFFSET)
