"""Port parity: the photometric VIO phases (select, photometric_update,
maintain through vio_update) on rendered frames of the synthetic room
against a fixed world cloud, with a 320x256 camera.

Both packages get the same frame (rendered once) and the same visual map
(built by the JAX package on a first frame, carried over with
fastlivo_tpu_torch.convert). Candidate choice — validity, point indices,
search levels, cell winners, the depth image — must match exactly; warped
reference patches agree to 2e-3 intensity units (four-tap sums rounded in
another order) and the posterior to 1e-4 m / 1e-4 rad (up to 30
iterations of f32 6x6 solves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scene_mod
from fastlivo_tpu.io import render as JR
from fastlivo_tpu.maps import visual_map as JVM
from fastlivo_tpu.models import vio as JVIO
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import visual_map as TVM
from fastlivo_tpu_torch.models import vio as TVIO
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole

torch.set_num_threads(1)

JCAM = JPinhole(320, 256, 200.0, 200.0, 160.0, 128.0)
TCAM = TPinhole(320, 256, 200.0, 200.0, 160.0, 128.0)
JVM_CFG = JVM.VisualMapConfig(capacity=1024, max_obs=4)
TVM_CFG = TVM.VisualMapConfig(capacity=1024, max_obs=4)
JCFG = JVIO.VioConfig()
TCFG = TVIO.VioConfig()
ROT_CI = scene_mod.ROT_CI
Z3 = np.zeros(3, np.float32)

_jvio = jax.jit(JVIO.vio_update, static_argnames=("cam", "vm_cfg", "cfg"))
_jselect = jax.jit(JVIO.select, static_argnames=("cam", "vm_cfg", "cfg"))
_jupdate = jax.jit(JVIO.photometric_update, static_argnames=("cam", "cfg"))
_jrender = jax.jit(JR.render_room, static_argnames=("cam",))


def _frame(pos):
    pcw = (-ROT_CI @ pos).astype(np.float32)
    return np.asarray(_jrender(JCAM, jnp.asarray(ROT_CI), jnp.asarray(pcw), half=8.0, floor_z=-1.5))


def _jstate(d):
    return JNav(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def world():
    """A fixed world cloud, a visual map after two JAX frames, and the
    inputs of a third frame whose prior is 2 cm off."""
    scene = scene_mod.Scene(4096, 32, seed=5)
    cloud = scene.room_points(4096).astype(np.float32)
    mask = np.ones(len(cloud), bool)
    st = scene.initial_state()
    vmap = JVM.make_visual_map(JVM_CFG)
    for k, dp in enumerate(([0.0, 0.0, 0.0], [0.0, 0.1, 0.0])):
        s = dict(st, pos=(st["pos"] + dp).astype(np.float32))
        _, vmap, info = _jvio(
            _jstate(s), vmap, jnp.asarray(_frame(s["pos"])), jnp.asarray(cloud), jnp.asarray(mask),
            JCAM, jnp.asarray(ROT_CI), jnp.asarray(Z3), JVM_CFG, JCFG,
        )
    truth = (st["pos"] + [0.0, 0.2, 0.0]).astype(np.float32)
    img = _frame(truth)
    prior = dict(st, pos=(truth + [0.015, -0.01, 0.01]).astype(np.float32))
    vm_np = {k: np.asarray(v) for k, v in vmap._asdict().items()}
    return dict(cloud=cloud, mask=mask, vmap=vm_np, img=img, prior=prior, truth=truth)


def _t(a):
    return torch.tensor(np.asarray(a))


def _select_both(w):
    js, jdepth = _jselect(
        _jstate(w["prior"]), JVM.VisualMap(**{k: jnp.asarray(v) for k, v in w["vmap"].items()}),
        jnp.asarray(w["img"]), jnp.asarray(w["cloud"]), jnp.asarray(w["mask"]),
        JCAM, jnp.asarray(ROT_CI), jnp.asarray(Z3), JVM_CFG, JCFG,
    )
    ts, tdepth = TVIO.select(
        convert.nav_state_from_numpy(w["prior"], "cpu"), convert.visual_map_from_numpy(w["vmap"], "cpu"),
        _t(w["img"]), _t(w["cloud"]), _t(w["mask"]), TCAM, _t(ROT_CI), _t(Z3), TVM_CFG, TCFG,
    )
    return js, jdepth, ts, tdepth


def test_select(world):
    js, jdepth, ts, tdepth = _select_both(world)
    np.testing.assert_array_equal(tdepth.numpy(), np.asarray(jdepth))  # exact scatter-min
    assert int(ts.valid.sum()) >= 10
    for name in ("valid", "pt_idx", "search_level", "scale", "cell_score", "pt_pos"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)), name)
    np.testing.assert_allclose(ts.ref_patch.numpy(), np.asarray(js.ref_patch), rtol=0, atol=2e-3)


def test_photometric_update(world):
    js, _, ts, _ = _select_both(world)
    jpost, je0, je1 = _jupdate(
        _jstate(world["prior"]), js, jnp.asarray(world["img"]), JCAM, jnp.asarray(ROT_CI),
        jnp.asarray(Z3), JCFG,
    )
    tpost, te0, te1 = TVIO.photometric_update(
        convert.nav_state_from_numpy(world["prior"], "cpu"), ts, _t(world["img"]), TCAM,
        _t(ROT_CI), _t(Z3), TCFG,
    )
    np.testing.assert_allclose(tpost.pos.numpy(), np.asarray(jpost.pos), atol=1e-4)
    np.testing.assert_allclose(tpost.rot.numpy(), np.asarray(jpost.rot), atol=1e-4)
    np.testing.assert_allclose([float(te0), float(te1)], [float(je0), float(je1)], rtol=1e-3)
    # the photometric update moves the estimate toward the true pose
    assert np.linalg.norm(tpost.pos.numpy() - world["truth"]) < np.linalg.norm(
        world["prior"]["pos"] - world["truth"]
    )


def test_vio_update_and_maintain(world):
    jpost, jvm, jinfo = _jvio(
        _jstate(world["prior"]), JVM.VisualMap(**{k: jnp.asarray(v) for k, v in world["vmap"].items()}),
        jnp.asarray(world["img"]), jnp.asarray(world["cloud"]), jnp.asarray(world["mask"]),
        JCAM, jnp.asarray(ROT_CI), jnp.asarray(Z3), JVM_CFG, JCFG,
    )
    tpost, tvm, tinfo = TVIO.vio_update(
        convert.nav_state_from_numpy(world["prior"], "cpu"), convert.visual_map_from_numpy(world["vmap"], "cpu"),
        _t(world["img"]), _t(world["cloud"]), _t(world["mask"]), TCAM, _t(ROT_CI), _t(Z3), TVM_CFG, TCFG,
    )
    for name in ("n_selected", "n_new_points", "n_new_obs"):
        assert int(getattr(tinfo, name)) == int(getattr(jinfo, name)), name
    np.testing.assert_allclose(tpost.pos.numpy(), np.asarray(jpost.pos), atol=1e-4)
    got, want = convert.visual_map_to_numpy(tvm), {k: np.asarray(v) for k, v in jvm._asdict().items()}
    for name in ("active", "cursor", "obs_valid", "obs_cursor", "pos"):
        np.testing.assert_array_equal(got[name], want[name], name)
    # New observations sit at the posterior pose: poses to 1e-5, pixels to
    # 1e-3 px, stored patches to 5e-3 intensity units.
    for name, atol in (("obs_rcw", 1e-5), ("obs_pcw", 1e-5), ("obs_px", 1e-3), ("obs_patch", 5e-3)):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-4, atol=1e-4)


def test_visual_map_helpers():
    m = TVM.make_visual_map(TVM_CFG, device="cpu")
    j = JVM.make_visual_map(JVM_CFG)
    for name in TVM.VisualMap._fields:
        np.testing.assert_array_equal(getattr(m, name).numpy(), np.asarray(getattr(j, name)))
    rng = np.random.default_rng(0)
    rcw = np.linalg.qr(rng.normal(size=(5, 4, 3, 3)))[0].astype(np.float32)
    pcw = rng.normal(size=(5, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TVM.obs_cam_pos(_t(rcw), _t(pcw)).numpy(),
        np.asarray(JVM.obs_cam_pos(jnp.asarray(rcw), jnp.asarray(pcw))), atol=1e-6,
    )
    assert int(TVM.num_active(m)) == 0
