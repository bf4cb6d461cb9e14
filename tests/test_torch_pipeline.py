"""Port parity for the slice as a whole: bootstrap_map, then six LIVO pairs
(lio_scan_step with the surfel model + vio_scan_step) on the periodic room
trajectory of chip_smoke.Scene, at the smoke sizes of bench.py (8192 raw
points, 4096 budget, 2^14 arena, unique cap 1024) with a 320x256 camera and
a 1024x4 visual map.

Both packages see the same numpy inputs; JAX renders each frame once and
both packages use it. Per step: position within 2 mm, attitude within
1e-3 rad, n_effective within 1%, the health-gate decision and n_selected
exactly. Final maps: integer fields exactly, moments to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scene_mod
from fastlivo_tpu.io import render as JR
from fastlivo_tpu.maps import visual_map as JVM
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models import lio as JL
from fastlivo_tpu.models import pipeline as JP
from fastlivo_tpu.models.imu import ImuWindow as JImu
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import visual_map as TVM
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models import lio as TL
from fastlivo_tpu_torch.models import pipeline as TP
from fastlivo_tpu_torch.ops import pallas_windows as TPW
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole

torch.set_num_threads(1)

N_PAIRS = 6

JCFG = JP.StepConfig(
    map_cfg=JV.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, nearby_type=18, lookup_unique_cap=1024),
    lio_cfg=JL.LioConfig(measurement_model="surfel"), ds_capacity=4096, imu_window=32,
    cam=JPinhole(320, 256, 200.0, 200.0, 160.0, 128.0),
    vm_cfg=JVM.VisualMapConfig(capacity=1024, max_obs=4),
)
TCFG = TP.StepConfig(
    map_cfg=TV.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, nearby_type=18, lookup_unique_cap=1024),
    lio_cfg=TL.LioConfig(measurement_model="surfel"), ds_capacity=4096, imu_window=32,
    cam=TPinhole(320, 256, 200.0, 200.0, 160.0, 128.0),
    vm_cfg=TVM.VisualMapConfig(capacity=1024, max_obs=4),
)


def _jscan(d):
    return JP.ScanInput(
        pts=jnp.asarray(d["pts"]), t_offs=jnp.asarray(d["t_offs"]), mask=jnp.asarray(d["mask"]),
        imu=JImu(**{k: jnp.asarray(v) for k, v in d["imu"].items()}),
        t_end=jnp.asarray(d["t_end"]), acc_scale=jnp.asarray(d["acc_scale"]),
    )


@pytest.fixture(scope="module")
def runs():
    scene = scene_mod.Scene(8192, 32, seed=0)
    boot = scene.bootstrap_scan()
    pairs = [(scene.lio_scan(k), scene.vio_window(k), scene.frame_pose(k)) for k in range(1, N_PAIRS + 1)]
    rot_ci = scene_mod.ROT_CI
    i3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    render = jax.jit(JR.render_room, static_argnames=("cam",))
    frames = [
        np.asarray(render(JCFG.cam, jnp.asarray(rcw), jnp.asarray(pcw), half=8.0, floor_z=-1.5))
        for _, _, (rcw, pcw) in pairs
    ]

    # JAX reference
    step = jax.jit(JP.lio_scan_step, static_argnames=("cfg", "axis_name"))
    vstep = jax.jit(JP.vio_scan_step, static_argnames=("cfg",))
    st = JNav(**{k: jnp.asarray(v) for k, v in scene.initial_state().items()})
    m = jax.jit(JP.bootstrap_map, static_argnames=("cfg", "axis_name"))(
        JV.make_map(JCFG.map_cfg), _jscan(boot), st, jnp.asarray(i3), jnp.asarray(z3), JCFG
    )
    vm = JVM.make_visual_map(JCFG.vm_cfg)
    jout = []
    for (ls, vw, _), img in zip(pairs, frames):
        st, m, _, (wc, wm), lsum = step(st, m, _jscan(ls), jnp.asarray(i3), jnp.asarray(z3), JCFG)
        st, vm, _, vsum = vstep(st, vm, _jscan(vw), jnp.asarray(img), wc, wm, jnp.asarray(rot_ci), jnp.asarray(z3), JCFG)
        jout.append((np.asarray(lsum), np.asarray(vsum)))
    jmaps = ({k: np.asarray(v) for k, v in m._asdict().items()}, {k: np.asarray(v) for k, v in vm._asdict().items()})

    # port, on the CPU
    dev = torch.device("cpu")
    ti3, tz3, trot = torch.tensor(i3), torch.tensor(z3), torch.tensor(rot_ci)
    ts = convert.nav_state_from_numpy(scene.initial_state(), dev)
    tm = TP.bootstrap_map(TV.make_map(TCFG.map_cfg, device=dev), scene_mod.to_scan_input(boot, dev), ts, ti3, tz3, TCFG)
    tv = TVM.make_visual_map(TCFG.vm_cfg, device=dev)
    tout = []
    launches = TPW.LAUNCHES["extract_windows"]
    for (ls, vw, _), img in zip(pairs, frames):
        ts, tm, _, (wc, wm), lsum = TP.lio_scan_step(ts, tm, scene_mod.to_scan_input(ls, dev), ti3, tz3, TCFG)
        ts, tv, _, vsum = TP.vio_scan_step(
            ts, tv, scene_mod.to_scan_input(vw, dev), torch.tensor(img), wc, wm, trot, tz3, TCFG
        )
        tout.append((lsum.numpy(), vsum.numpy()))
    assert TPW.LAUNCHES["extract_windows"] == launches  # CPU tensors never launch the kernel
    tmaps = (convert.voxel_map_to_numpy(tm), convert.visual_map_to_numpy(tv))
    return jout, tout, jmaps, tmaps


def _quat_angle(qa, qb):
    return 2.0 * np.arccos(np.clip(abs(float(np.dot(qa, qb))), 0.0, 1.0))


def test_lio_steps_match(runs):
    jout, tout, _, _ = runs
    for k, ((jl, _), (tl, _)) in enumerate(zip(jout, tout)):
        assert np.linalg.norm(tl[0:3] - jl[0:3]) <= 2e-3, k
        assert _quat_angle(tl[3:7], jl[3:7]) <= 1e-3, k
        assert abs(tl[7] - jl[7]) <= 0.01 * jl[7], k  # n_effective
        assert tl[9] == jl[9] == 1.0, k  # accepted by the health gate
        assert jl[7] > 0


def test_vio_steps_match(runs):
    jout, tout, _, _ = runs
    for k, ((_, jv), (_, tv)) in enumerate(zip(jout, tout)):
        assert np.linalg.norm(tv[0:3] - jv[0:3]) <= 2e-3, k
        assert _quat_angle(tv[3:7], jv[3:7]) <= 1e-3, k
        assert tv[7] == jv[7], k  # n_selected
    assert max(jv[7] for _, jv in jout[1:]) > 0  # the photometric update ran


def test_track_follows_trajectory(runs):
    _, tout, _, _ = runs
    for k, (tl, tv) in enumerate(tout, start=1):
        t = k * scene_mod.PAIR_DT
        assert np.linalg.norm(tl[0:3] - scene_mod.pose_at(t)) < 0.05
        assert np.linalg.norm(tv[0:3] - scene_mod.pose_at(t + scene_mod.HALF_DT)) < 0.05


def test_final_maps_match(runs):
    _, _, (jm, jv), (tm, tv) = runs
    for name in ("counts", "slab_stamps", "epoch"):
        np.testing.assert_array_equal(tm[name], jm[name], name)
    meta_t, meta_j = tm["meta"].reshape(-1, 8), jm["meta"].reshape(-1, 8)
    np.testing.assert_array_equal(meta_t[:, :4], meta_j[:, :4])  # keys + stamps
    np.testing.assert_allclose(meta_t[:, 4:], meta_j[:, 4:], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm["surf_s2"], jm["surf_s2"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm["slab"], jm["slab"], rtol=0, atol=2e-3)
    for name in ("active", "cursor", "obs_valid", "obs_cursor"):
        np.testing.assert_array_equal(tv[name], jv[name], name)
    np.testing.assert_allclose(tv["pos"], jv["pos"], rtol=0, atol=2e-3)
