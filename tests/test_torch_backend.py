"""Port parity for the STD loop back end: `fit_voxel_planes` (coords,
counts and is_plane exact; centres within 1e-5, plane normals within
1e-5), corners and descriptors (same set; the corners' plane normals and
positions within 1e-3), `StdLoopDetector.detect` (same frame id and
score, pose within 1e-3 rad / 1e-2 m), `PoseGraph.optimize` equal, the
loop backend on the tests/test_loop_manager.py recipes (sync and
background: same loops and rejected loops), and the key-cloud voxel mask
bit-equal to the JAX package's native `voxel_mask`.

Where a tolerance is looser than 1e-5 the cause is the f32 cancellation in
a plane fitted to a few points (ROADMAP.md section 3). Scenes are
tests/test_backend.py's: no voxel of them sits at the plane-threshold
boundary, where that rounding could flip `is_plane`."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import jax.numpy as jnp
from fastlivo_tpu import native
from fastlivo_tpu.backend import pose_graph as JPG
from fastlivo_tpu.backend import std_loop as JSTD
from fastlivo_tpu.backend.loop_manager import LoopBackend as JBackend
from fastlivo_tpu.utils.config import FastLivoConfig as JCfg
from fastlivo_tpu_torch.backend import pose_graph as TPG
from fastlivo_tpu_torch.backend import std_loop as TSTD
from fastlivo_tpu_torch.backend.loop_manager import LoopBackend as TBackend
from fastlivo_tpu_torch.backend.loop_manager import voxel_mask
from fastlivo_tpu_torch.utils.config import FastLivoConfig as TCfg
from tests.test_backend import make_structured_scene

torch.set_num_threads(2)


def _fits(cloud, max_voxels):
    kw = dict(voxel_size=2.0, max_voxels=max_voxels, min_points=10, plane_thresh=0.01)
    j = JSTD._fit_voxel_planes_jit(jnp.asarray(cloud), jnp.ones(len(cloud), bool), **kw)
    t = TSTD.fit_voxel_planes(torch.as_tensor(cloud), torch.ones(len(cloud), dtype=torch.bool), **kw)
    return {k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in t.items()}


@pytest.mark.parametrize("tiles,max_voxels", [(1, 2048), (4, 1024)])
def test_fit_voxel_planes(tiles, max_voxels):
    """Normals within 1e-5 on every plane voxel (the only normals the
    corners and the plane cloud read). A non-plane voxel whose points lie
    on a line has two near-equal small eigenvalues and no defined normal;
    there the packages may differ up to ROADMAP.md section 3's 1e-2."""
    base = make_structured_scene(np.random.default_rng(20000), n=20000)
    # Tiles shifted by whole voxels: more occupied voxels than the budget.
    shifts = np.array([[0, 0, 0], [40, 0, 0], [0, 40, 0], [40, 40, 0]], np.float32)[:tiles]
    cloud = np.concatenate([base + s for s in shifts])
    j, t = _fits(cloud, max_voxels)
    n_vox = len(np.unique(np.floor(cloud / 2.0), axis=0))
    assert (n_vox > max_voxels) == (tiles > 1), n_vox
    for k in ("coords", "count", "is_plane", "valid"):
        assert np.array_equal(t[k], j[k]), k
    v, pl = j["valid"], j["is_plane"]
    assert pl.sum() > 20
    np.testing.assert_allclose(t["center"][v], j["center"][v], atol=1e-5)
    np.testing.assert_allclose(t["normal"][pl], j["normal"][pl], atol=1e-5)
    dn = np.abs(t["normal"][v] - j["normal"][v]).max(axis=1)
    assert (dn < 1e-5).mean() > 0.99 and dn.max() < 1e-2
    np.testing.assert_allclose(t["min_eig"][v], j["min_eig"][v], atol=1e-5)


def test_corners_and_descriptors():
    """Corners carry their plane's normal, and a plane fitted to a few
    points is ill-conditioned in f32 (its covariance is a difference of
    moments that cancels to ~1e-6): XLA contracts those products into
    FMAs, torch does not, so such normals differ by up to ~4e-4 here. The
    eigenvector's sign is arbitrary too, and where it flips the corner's
    projection grid runs the other way and its density peak moves. So at
    least 90% of the corners agree (position within 1e-3, the same count,
    the normal up to sign within 1e-6 in the dot product), and the
    descriptors' rounded side-length keys (what the database hashes) agree
    but for 25% (measured 16.6%). On the JAX package's own voxels the port's host stages are
    bit for bit the JAX package's."""
    cloud = make_structured_scene(np.random.default_rng(3), n=40000)
    cfg_kw = dict(skip_near_num=1, corner_thre=6.0, icp_threshold=0.3)
    jcfg, tcfg = JSTD.StdConfig(**cfg_kw), TSTD.StdConfig(**cfg_kw)
    j, t = _fits(cloud, jcfg.max_planes)
    jc = JSTD.extract_corners(cloud, j, jcfg)
    tc = TSTD.extract_corners(cloud, t, tcfg)
    assert len(jc) > 10 and tc.shape == jc.shape
    nearest = np.argmin(np.linalg.norm(tc[:, None, :3] - jc[None, :, :3], axis=-1), axis=1)
    same = (np.abs(tc[:, :4] - jc[nearest, :4]).max(axis=1) < 1e-3) & (
        np.abs(np.sum(tc[:, 4:] * jc[nearest, 4:], axis=1)) > 1.0 - 1e-6
    )
    assert same.mean() >= 0.9, same.mean()
    jd, td = JSTD.build_descriptors(jc, 0, jcfg), TSTD.build_descriptors(tc, 0, tcfg)
    jk = {tuple(k) for k in np.round(jd.sides).astype(np.int64)}
    tk = {tuple(k) for k in np.round(td.sides).astype(np.int64)}
    assert len(jd.sides) > 100 and len(jk ^ tk) <= 0.25 * len(jk), len(jk ^ tk) / len(jk)
    # On the exact corners the host code is the JAX package's, bit for bit.
    jd2 = TSTD.build_descriptors(jc, 0, tcfg)
    for k in ("sides", "verts", "attached"):
        assert np.array_equal(getattr(jd2, k), getattr(jd, k)), k
    assert np.array_equal(TSTD.extract_corners(cloud, j, tcfg), jc)


def test_detect_same_loop():
    cfg_kw = dict(skip_near_num=1, corner_thre=6.0, icp_threshold=0.3)
    jdet, tdet = JSTD.StdLoopDetector(JSTD.StdConfig(**cfg_kw)), TSTD.StdLoopDetector(TSTD.StdConfig(**cfg_kw), device="cpu")
    rot_d = Rotation.from_euler("z", 0.1).as_matrix().astype(np.float32)
    t_d = np.array([1.5, -0.8, 0.1], np.float32)
    clouds = [
        make_structured_scene(np.random.default_rng(42), n=40000),
        make_structured_scene(np.random.default_rng(99), n=30000, layout_seed=31),
        make_structured_scene(np.random.default_rng(5), n=40000) @ rot_d.T + t_d,
    ]
    for k, cloud in enumerate(clouds):
        jr, tr = jdet.detect(cloud), tdet.detect(cloud)
        if k < 2:
            assert jr is None and tr is None
    assert jr is not None and tr is not None
    assert tr[0] == jr[0] == 0
    # The score (a fraction of matched planes) is the same; the pose comes
    # from a plane ICP over the fitted normals, so it inherits their f32
    # divergence (measured 2.3e-4 in rotation).
    assert abs(tr[1] - jr[1]) < 1e-9
    np.testing.assert_allclose(tr[2], jr[2], atol=1e-3)
    np.testing.assert_allclose(tr[3], jr[3], atol=1e-2)


def _square_graph(mod):
    g = mod.PoseGraph()
    rot, t = np.eye(3), np.zeros(3)
    for _ in range(4):
        for _ in range(5):
            g.maybe_add_keyframe(rot, t, trans_thresh=0.5)
            t = t + rot @ np.array([1.0, 0, 0])
        rot = rot @ Rotation.from_euler("z", np.pi / 2).as_matrix()
    for i in range(len(g.rots)):
        a = i / len(g.rots)
        g.trans[i] = g.trans[i] + np.array([0.5, 0.3, 0.0]) * a
        g.rots[i] = g.rots[i] @ Rotation.from_euler("z", 0.1 * a).as_matrix()
    g.add_loop(0, len(g.rots) - 1, np.eye(3), np.zeros(3), weight=10.0)
    g.add_loop(0, 10, Rotation.from_euler("z", np.pi).as_matrix(), np.array([5.0, 5.0, 0.0]), weight=4.0)
    g.add_loop(5, 15, np.eye(3), np.array([0.1, 0.0, 0.0]), weight=4.0)
    return g


def test_pose_graph_equal():
    jr, jt = _square_graph(JPG).optimize()
    tr, tt = _square_graph(TPG).optimize()
    assert np.array_equal(tr, jr) and np.array_equal(tt, jt)


@pytest.mark.parametrize("leaf", [0.25, 0.1])
def test_voxel_mask_bit_equal_to_native(rng, leaf):
    assert native.get_lib() is not None  # the native build, not its fallback
    pts = rng.uniform(-60, 60, (20000, 3)).astype(np.float32)
    pts[:2000] = np.round(pts[:2000] / leaf) * leaf  # on voxel boundaries
    pts[2000:4000] = pts[:2000] + np.float32(1e-6)
    assert np.array_equal(voxel_mask(pts, leaf), native.voxel_mask(pts, leaf))
    both = np.concatenate([pts, pts.astype(np.float64) + 1e-9])
    assert np.array_equal(voxel_mask(both, leaf), native.voxel_mask(both, leaf))


def _run_recipe(pkg, background):
    """tests/test_loop_manager.py::run_backend through package `pkg`."""
    cfg = (JCfg if pkg == "jax" else TCfg)()
    cfg.loop.loop_en = True
    cfg.loop.sub_frame_num = 5
    cfg.loop.skip_near_num = 1
    cfg.loop.corner_thre = 6.0
    cfg.loop.icp_threshold = 0.3
    cfg.keyframe.trans_thresh_m = 0.5
    be = JBackend(cfg, background=background) if pkg == "jax" else TBackend(cfg, background=background, device="cpu")
    rng = np.random.default_rng(3)
    place_a = make_structured_scene(rng, n=30000)
    rot_d = Rotation.from_euler("z", 0.08).as_matrix()
    t_d = np.array([1.2, -0.6, 0.05])
    for i in range(5):
        be.on_scan(np.eye(3), np.array([0.6 * i, 0.0, 0.0]), place_a[rng.permutation(len(place_a))[:15000]])
    place_b = make_structured_scene(np.random.default_rng(50), n=20000, layout_seed=77)
    for i in range(5):
        be.on_scan(np.eye(3), np.array([40.0 + 0.6 * i, 10.0, 0.0]), place_b + 0.0)
    cloud_drifted = make_structured_scene(np.random.default_rng(9), n=30000) @ rot_d.T + t_d
    for i in range(5):
        pos_odo = rot_d @ np.array([0.6 * i, 0.2, 0.0]) + t_d
        be.on_scan(rot_d, pos_odo, cloud_drifted[rng.permutation(len(cloud_drifted))[:15000]])
    be.finish()
    return be


@pytest.mark.parametrize("background", [False, True])
def test_loop_backend_same_loops(background):
    j, t = _run_recipe("jax", background), _run_recipe("torch", background)
    assert len(t.loops) == len(j.loops) >= 1
    for a, b in zip(t.loops, j.loops):
        assert (a.kf_from, a.kf_to) == (b.kf_from, b.kf_to)
        assert abs(a.score - b.score) < 1e-9
        np.testing.assert_allclose(a.rot, b.rot, atol=1e-5)
        np.testing.assert_allclose(a.trans, b.trans, atol=1e-5)
    assert t.rejected_loops == j.rejected_loops
    assert t._std_frame_kf == j._std_frame_kf
    jr, jt = j.corrected_trajectory()
    tr, tt = t.corrected_trajectory()
    np.testing.assert_allclose(tt, jt, atol=1e-4)
