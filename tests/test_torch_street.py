"""Port parity for the street world: trajectories, the building layout,
`generate_street` (IMU, sweeps and ground truth bitwise) and
`generate_gnss` (bitwise), `render_street` against the JAX renderer
(within 1e-4 intensity units plus 5e-5 relative: the texture's sines of
world coordinates tens of metres out round differently in f32, measured
up to 1.9e-3, 2.2e-5 relative), and the annotated-frame path:
`vio.candidate_overlay` on the same state and frame, then the PNG bytes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from fastlivo_tpu.io import annotate as JANN
from fastlivo_tpu.io import render as JR
from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu_torch.io import annotate as TANN
from fastlivo_tpu_torch.io import render as TR
from fastlivo_tpu_torch.io import synthetic as TSYN
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole

torch.set_num_threads(2)
CAM = (160, 128, 100.0, 100.0, 80.0, 64.0)


@pytest.mark.parametrize("name", ["street_trajectory", "circuit_trajectory"])
def test_trajectories_bitwise(name):
    j, t = getattr(JSYN, name)(), getattr(TSYN, name)()
    for s in np.linspace(0.0, 40.0, 97):
        jr, jp = j.pose(s)
        tr, tp = t.pose(s)
        assert np.array_equal(jr, tr) and np.array_equal(jp, tp)
        assert np.array_equal(j.acc_world(s), t.acc_world(s)) and j.yaw_rate(s) == t.yaw_rate(s)
    assert np.array_equal(JSYN.street_boxes(), TSYN.street_boxes())
    assert np.array_equal(
        JSYN.street_surfaces(np.random.default_rng(1), 3000),
        TSYN.street_surfaces(np.random.default_rng(1), 3000),
    )


@pytest.fixture(scope="module")
def seqs():
    kw = dict(duration=3.0, pts_per_scan=1500, seed=11, max_range=12.0,
              gyro_bias=np.array([0.0, 0.0, 0.01]), imu_noise_gyr=0.03, cam_rate=10.0,
              cam_offset=0.055)
    j = JSYN.generate_street(camera=JPinhole(*CAM), trajectory=JSYN.circuit_trajectory(), **kw)
    t = TSYN.generate_street(camera=TPinhole(*CAM), trajectory=TSYN.circuit_trajectory(),
                             device="cpu", **kw)
    return j, t


def test_generate_street_and_gnss_bitwise(seqs):
    j, t = seqs
    assert len(j.imu) == len(t.imu) and len(j.scans) == len(t.scans) == 30
    for a, b in zip(j.imu, t.imu):
        assert a.stamp == b.stamp and np.array_equal(a.gyr, b.gyr) and np.array_equal(a.acc, b.acc)
    for a, b in zip(j.scans, t.scans):
        assert a.stamp == b.stamp
        assert np.array_equal(a.pts, b.pts) and np.array_equal(a.t_offs_ms, b.t_offs_ms)
    for k in ("gt_stamps", "gt_rot", "gt_pos", "world"):
        assert np.array_equal(getattr(j, k), getattr(t, k)), k
    assert [f.stamp for f in j.frames] == [f.stamp for f in t.frames]
    for jg, tg in zip(JSYN.generate_gnss(j, rate=5.0, seed=3, t_unix0=0.0, noise_m=0.05),
                      TSYN.generate_gnss(t, rate=5.0, seed=3, t_unix0=0.0, noise_m=0.05)):
        assert jg.time == tg.time
        assert np.array_equal(jg.ecef, tg.ecef) and np.array_equal(jg.std_enu, tg.std_enu)


def test_render_street(seqs):
    j, t = seqs
    for a, b in zip(j.frames, t.frames):
        assert a.img.shape == b.img.shape == (CAM[1], CAM[0])
        np.testing.assert_allclose(b.img, a.img, atol=1e-4, rtol=5e-5)
    assert (t.frames[0].img > 0).mean() > 0.5  # mostly ground and buildings
    # One view from inside the street at the full 1280x1024 geometry's
    # aspect, with the buildings in sight.
    cam = (320, 256, 323.4, 323.4, 156.7, 130.7)
    rcw = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
    pcw = -rcw @ np.array([5.0, 2.0, 0.3], np.float32)
    ji = JR.render_street(JPinhole(*cam), jnp.asarray(rcw), jnp.asarray(pcw),
                          jnp.asarray(JSYN.street_boxes()))
    ti = TR.render_street(TPinhole(*cam), torch.as_tensor(rcw), torch.as_tensor(pcw),
                          torch.as_tensor(TSYN.street_boxes()))
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4, rtol=5e-5)


def test_candidate_overlay_and_png(tmp_path):
    """The overlay on a visual map filled by three VIO updates of one room
    frame, from the same state, map and frame in both packages."""
    from fastlivo_tpu.maps import visual_map as JVM
    from fastlivo_tpu.models import vio as JVIO
    from fastlivo_tpu.state import NavState as JNav
    from fastlivo_tpu_torch import convert
    from fastlivo_tpu_torch.maps import visual_map as TVM
    from fastlivo_tpu_torch.models import vio as TVIO

    import chip_smoke

    cam = (320, 256, 200.0, 200.0, 160.0, 128.0)
    vm_kw = dict(capacity=1024, max_obs=4)
    jcfg, tcfg = JVM.VisualMapConfig(**vm_kw), TVM.VisualMapConfig(**vm_kw)
    scene = chip_smoke.Scene(n_raw=6000, imu_m=8, seed=3)
    world = torch.as_tensor(scene.room_points(6000).astype(np.float32))
    mask = torch.ones(6000, dtype=torch.bool)
    st = scene.initial_state()
    rcw, pcw = scene.frame_pose(0)
    frame = TR.render_room(TPinhole(*cam), torch.as_tensor(rcw), torch.as_tensor(pcw), half=8.0)
    rot_ci, z3 = torch.as_tensor(chip_smoke.ROT_CI), torch.zeros(3)
    tstate = convert.nav_state_from_numpy(st, "cpu")
    tvm = TVM.make_visual_map(tcfg, device="cpu")
    for _ in range(3):
        tvm = TVIO.vio_update(tstate, tvm, frame, world, mask, TPinhole(*cam), rot_ci, z3, tcfg,
                              TVIO.VioConfig())[1]
    tuv, tvalid, tin = TVIO.candidate_overlay(
        tstate, tvm, frame, world, mask, TPinhole(*cam), rot_ci, z3, tcfg, TVIO.VioConfig()
    )
    overlay = jax.jit(JVIO.candidate_overlay, static_argnames=("cam", "vm_cfg", "cfg"))
    jvm = JVM.VisualMap(**{k: jnp.asarray(v) for k, v in convert.visual_map_to_numpy(tvm).items()})
    juv, jvalid, jin = overlay(
        JNav(**{k: jnp.asarray(v) for k, v in st.items()}), jvm, jnp.asarray(frame.numpy()),
        jnp.asarray(world.numpy()), jnp.ones(6000, bool), cam=JPinhole(*cam),
        rot_ci=jnp.asarray(chip_smoke.ROT_CI), t_ci=jnp.zeros(3), vm_cfg=jcfg, cfg=JVIO.VioConfig(),
    )
    assert int(np.asarray(jvalid).sum()) > 10 and int(np.asarray(jin).sum()) > 5
    assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert np.array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tuv.numpy(), np.asarray(juv), atol=1e-3)
    img = frame.numpy()
    jp = JANN.save_annotated(str(tmp_path / "j"), 0, img, np.asarray(juv), np.asarray(jvalid),
                             np.asarray(jin))
    tp = TANN.save_annotated(str(tmp_path / "t"), 0, img, tuv.numpy(), tvalid.numpy(), tin.numpy())
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
