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

The observation a point is matched with is the one seen from the direction
closest to the current view: where a rig passes the same place again, the
f32 cosines of directions 1e-4 rad apart round to one value, so the port
compares squared chords and is held to a float64 argmax of the cosine
(`test_closest_view_obs_resolves_revisits`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as scene_mod
import vio_trip_loop
from fastlivo_tpu.io import render as JR
from fastlivo_tpu.maps import visual_map as JVM
from fastlivo_tpu.models import vio as JVIO
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.maps import visual_map as TVM
from fastlivo_tpu_torch.models import vio as TVIO
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole
from fastlivo_tpu_torch.state import NavState as TNav
from fastlivo_tpu_torch.utils import timing

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


def test_closest_view_obs_resolves_revisits():
    """Points 2-10 m out, each seen by four cameras placed where a rig
    passing again would be (directions 1e-5-1e-3 rad apart), and points
    whose best view lies just inside or outside 60 degrees: the f32 choice
    equals the float64 argmax of the cosine, the gate its cos > 0.5."""
    rng = np.random.default_rng(5)
    n, k = 512, 4
    pos = rng.uniform(-10.0, 10.0, (n, 3))
    pos *= rng.uniform(2.0, 10.0, (n, 1)) / np.linalg.norm(pos, axis=1, keepdims=True)
    cam = rng.normal(size=3) * 0.5
    d = (cam - pos) / np.linalg.norm(cam - pos, axis=1, keepdims=True)
    # Observation directions: the current one turned by 1e-5-1e-3 rad about random axes.
    axis = rng.normal(size=(n, k, 3))
    axis -= np.sum(axis * d[:, None], -1, keepdims=True) * d[:, None]
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = 10.0 ** rng.uniform(-5.0, -3.0, (n, k))
    # The last 64 points: one view at 59.9 or 60.1 degrees, the rest beyond 80.
    ang[-64:] = np.radians(rng.uniform(80.0, 120.0, (64, k)))
    ang[-64:, 0] = np.radians(np.where(np.arange(64) % 2 == 0, 59.9, 60.1))
    od = np.cos(ang)[..., None] * d[:, None] + np.sin(ang)[..., None] * axis
    obs_c = pos[:, None] + od * rng.uniform(2.0, 10.0, (n, k, 1))
    rcw = np.linalg.qr(rng.normal(size=(n, k, 3, 3)))[0]
    pcw = -np.einsum("nkij,nkj->nki", rcw, obs_c)
    m = TVM.make_visual_map(TVM.VisualMapConfig(capacity=n, max_obs=k), device="cpu")
    m = m._replace(pos=_t(pos.astype(np.float32)), obs_rcw=_t(rcw.astype(np.float32)),
                   obs_pcw=_t(pcw.astype(np.float32)), active=torch.ones(n, dtype=torch.bool),
                   obs_valid=torch.ones((n, k), dtype=torch.bool))
    best, ok = TVM.closest_view_obs(m, torch.arange(n, dtype=torch.int32), _t(cam.astype(np.float32)))

    # The float64 answer from the same f32 numbers.
    p64 = pos.astype(np.float32).astype(np.float64)
    r64, t64 = rcw.astype(np.float32).astype(np.float64), pcw.astype(np.float32).astype(np.float64)
    c64 = -np.einsum("nkji,nkj->nki", r64, t64)
    u = c64 - p64[:, None]
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = cam.astype(np.float32).astype(np.float64) - p64
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    cos = np.sum(u * v[:, None], -1)
    want = np.argmax(cos, -1)
    np.testing.assert_array_equal(best.numpy(), want)
    np.testing.assert_array_equal(ok.numpy(), cos[np.arange(n), want] > 0.5)
    assert ok[:-64].all() and ok[-64::2].all() and not ok[-63::2].any()
    # The f32 cosine (the JAX package's form) ties and misses most revisits.
    cos32 = torch.sum(_t((u).astype(np.float32)) * _t(v.astype(np.float32))[:, None], -1)
    assert (torch.argmax(cos32[:-64], -1).numpy() != want[:-64]).mean() > 0.3


def _counted(fn):
    """fn()'s result and what it added to the port's counters."""
    before = timing.counters()
    out = fn()
    return out, timing.counter_delta(timing.counters(), before)


@pytest.mark.parametrize("off,max_iterations", [((0.015, -0.01, 0.01), 10), ((0.05, 0.03, -0.04), 10),
                                                ((0.05, 0.03, -0.04), 2)])
def test_factored_trips_equal_the_loop_bitwise(world, off, max_iterations):
    """`photometric_update` over `gn_trip` gives the loop it was factored
    from (tests/vio_trip_loop.py) bit for bit on the CPU: posterior,
    covariance, both errors, the trips and flag reads; no graph is made."""
    cfg = TVIO.VioConfig(max_iterations=max_iterations)
    prior = convert.nav_state_from_numpy(dict(world["prior"], pos=(world["truth"] + off).astype(np.float32)), "cpu")
    sel, _ = TVIO.select(
        prior, convert.visual_map_from_numpy(world["vmap"], "cpu"), _t(world["img"]), _t(world["cloud"]),
        _t(world["mask"]), TCAM, _t(ROT_CI), _t(Z3), TVM_CFG, cfg,
    )
    args = (prior, sel, _t(world["img"]), TCAM, _t(ROT_CI), _t(Z3), cfg)
    n_graphs = len(TVIO._TRIP_GRAPHS)
    (want, w0, w1), want_counts = _counted(lambda: vio_trip_loop.loop_photometric_update(*args))
    (got, g0, g1), got_counts = _counted(lambda: TVIO.photometric_update(*args))
    for name in TNav._fields:
        assert scene_mod.same_bits(getattr(got, name), getattr(want, name)), name
    assert scene_mod.same_bits(g0, w0) and scene_mod.same_bits(g1, w1)
    assert got_counts == want_counts and want_counts["vio.trips"] == want_counts["sync.vio_flags"] >= 3
    assert "vio.graph_replays" not in got_counts and "vio.graph_captures" not in got_counts
    assert len(TVIO._TRIP_GRAPHS) == n_graphs


def _trip_frame(n):
    f32 = torch.float32
    return TVIO.TripFrame(
        prop=TNav.identity(f32, "cpu"), p_inv=torch.eye(18), pt_pos=torch.zeros(n, 3),
        valid=torch.ones(n, dtype=torch.bool), ref_patch=torch.zeros(n, 3, 64), scale=torch.ones(n),
        strides=torch.ones(n, dtype=torch.int32), rot_ci=torch.eye(3), t_ci=torch.zeros(3),
    )


def _padded_pyramid(h, w):
    return [torch.zeros(h + 64, w + 64), torch.zeros(h // 2 + 64, w // 2 + 64), torch.zeros(h // 4 + 64, w // 4 + 64)]


AVIA_CAM = TPinhole(640, 512, 431.8, 431.8, 320.0, 256.0)


@pytest.mark.parametrize("change", ["none", "n", "level_shape", "vio_config", "pinhole", "ref_levels", "pt_dtype"])
def test_trip_graph_key(change):
    """The key of the graph cache: equal for equal shapes and settings
    (fresh tensors), another for another N, level shape, VioConfig,
    Pinhole, stored patch level count or input dtype."""
    base = TVIO.trip_graph_key(_trip_frame(208), _padded_pyramid(512, 640), AVIA_CAM, TVIO.VioConfig())
    frame, pyr, cam, cfg = _trip_frame(208), _padded_pyramid(512, 640), AVIA_CAM, TVIO.VioConfig()
    if change == "n":
        frame = _trip_frame(207)
    elif change == "level_shape":
        pyr[2] = torch.zeros(193, 224)
    elif change == "vio_config":
        cfg = TVIO.VioConfig(max_iterations=5)
    elif change == "pinhole":
        cam = TPinhole(640, 512, 431.8, 431.8, 320.0, 256.5)
    elif change == "ref_levels":
        frame = frame._replace(ref_patch=torch.zeros(208, 1, 64))
    elif change == "pt_dtype":
        frame = frame._replace(pt_pos=torch.zeros(208, 3, dtype=torch.float64))
    key = TVIO.trip_graph_key(frame, pyr, cam, cfg)
    assert (key == base) == (change == "none")
    assert hash(key) == hash(TVIO.trip_graph_key(frame, pyr, cam, cfg))
