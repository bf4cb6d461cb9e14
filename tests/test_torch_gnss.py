"""Port parity for GNSS fusion: the earth conversions (f64, exact), the RTK
parser (same samples), `observation_block` (1e-6), `align_trajectory`
(yaw to 1e-5 rad, lever to 1e-4 m: jacrev against JAX's forward mode in
f32) and the test_gnss_pipeline.py recipe through both LivoPipelines
(trajectories within 15 mm, the same health counters, yaw recovered)."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.io.sync import MeasurementSynchronizer as JSync
from fastlivo_tpu.io.sync import WindowBuilder as JBuilder
from fastlivo_tpu.models import gnss as JG
from fastlivo_tpu.models.pipeline import LivoPipeline as JPipe
from fastlivo_tpu.ops import earth as JE
from fastlivo_tpu.utils.config import FastLivoConfig as JCfg
from fastlivo_tpu_torch.io import synthetic as TSYN
from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer as TSync
from fastlivo_tpu_torch.io.sync import WindowBuilder as TBuilder
from fastlivo_tpu_torch.models import gnss as TG
from fastlivo_tpu_torch.models.pipeline import LivoPipeline as TPipe
from fastlivo_tpu_torch.ops import earth as TE
from fastlivo_tpu_torch.utils.config import FastLivoConfig as TCfg

torch.set_num_threads(2)
T_UNIX0 = 1.7e9


def test_earth_exact(rng):
    for _ in range(10):
        blh = np.array([rng.uniform(-1.2, 1.2), rng.uniform(-np.pi, np.pi), rng.uniform(0, 2000)])
        ecef = JE.blh2ecef(blh)
        assert np.array_equal(TE.blh2ecef(blh), ecef)
        assert np.array_equal(TE.ecef2blh(ecef), JE.ecef2blh(ecef))
        assert np.array_equal(TE.cne(blh), JE.cne(blh))
        assert TE.gravity(blh) == JE.gravity(blh)
        other = ecef + rng.normal(0, 50.0, 3)
        assert np.array_equal(TE.ecef2enu(other, ecef), JE.ecef2enu(other, ecef))
    assert TE.gps2unix(2200, 100.5) == JE.gps2unix(2200, 100.5)


def test_parse_rtk_file_same_samples(tmp_path, rng):
    anchor = JE.blh2ecef(np.array([0.39, 1.99, 20.0]))
    samples = [
        TG.GnssSample(time=T_UNIX0 + 0.2 * i, ecef=anchor + rng.normal(0, 3.0, 3),
                      std_enu=rng.uniform(0.01, 0.05, 3))
        for i in range(12)
    ]
    fixed, floating = tmp_path / "fixed.txt", tmp_path / "float.txt"
    TG.write_rtk_file(str(fixed), samples)
    TG.write_rtk_file(str(floating), samples[:3], ar=1)  # not fixed: dropped
    with open(fixed, "a") as f:
        f.write("short row\n")
    j, t = JG.parse_rtk_file(str(fixed)), TG.parse_rtk_file(str(fixed))
    assert len(j) == len(t) == len(samples)
    for a, b, s in zip(j, t, samples):
        assert a.time == b.time and abs(a.time - s.time) < 1e-5
        assert np.array_equal(a.ecef, b.ecef) and np.abs(a.ecef - s.ecef).max() < 1e-4
        assert np.array_equal(a.std_enu, b.std_enu)
    assert JG.parse_rtk_file(str(floating)) == TG.parse_rtk_file(str(floating)) == []


@pytest.mark.parametrize("gate", [5.0, 0.5])
def test_observation_block(rng, gate):
    import jax.numpy as jnp

    for _ in range(5):
        rot = Rotation.from_rotvec(rng.normal(0, 0.5, 3)).as_matrix().astype(np.float32)
        pos = rng.normal(0, 2.0, 3).astype(np.float32)
        z = (pos + rng.normal(0, 0.6, 3)).astype(np.float32)
        std = rng.uniform(0.01, 0.05, 3).astype(np.float32)
        lever = rng.normal(0, 0.3, 3).astype(np.float32)
        jh, jy = JG.observation_block(*(jnp.asarray(a) for a in (rot, pos, z, std, lever)), gate)
        th, ty = TG.observation_block(*(torch.as_tensor(a) for a in (rot, pos, z, std, lever)), gate)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6 * np.abs(np.asarray(jh)).max() + 1e-9)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6, atol=1e-6 * np.abs(np.asarray(jy)).max() + 1e-9)


def test_align_trajectory(rng):
    n = 40
    r_we = Rotation.from_euler("z", 0.7).as_matrix()
    lever_true = np.array([0.2, -0.1, 0.5])
    odo_pos = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    odo_pos[:, 2] *= 0.1
    odo_rot = np.stack([Rotation.from_euler("z", 0.05 * i).as_matrix() for i in range(n)])
    gnss_enu = np.stack([r_we.T @ (odo_pos[i] + odo_rot[i] @ lever_true) for i in range(n)])
    gnss_enu += rng.normal(0, 0.02, gnss_enu.shape)
    jr, jl = JG.align_trajectory(odo_pos, odo_rot, gnss_enu, np.full(3, 0.02))
    tr, tl = TG.align_trajectory(odo_pos, odo_rot, gnss_enu, np.full(3, 0.02), device="cpu")
    yaw = lambda r: np.arctan2(r[1, 0], r[0, 0])  # noqa: E731
    assert abs(yaw(tr) - yaw(np.asarray(jr))) < 1e-5
    np.testing.assert_allclose(tl, np.asarray(jl), atol=1e-4)


def _gnss_cfg(cfg):
    cfg.lio.max_points = 8192
    cfg.map.capacity = 1 << 16
    cfg.imu.imu_int_frame = 32
    cfg.gnss.gnss_en = True
    cfg.gnss.init_window = 10
    return cfg


def _drive(seq, pipe, sync, builder):
    imu_iter = iter(seq.imu)
    pending = next(imu_iter)
    est = []
    for scan in seq.scans:
        sync.push_lidar(scan)
        while pending is not None and pending.stamp < scan.end_time + 0.05:
            sync.push_imu(pending)
            pending = next(imu_iter, None)
        group = sync.next_group()
        if group is None:
            continue
        si, t_abs = builder.build(group)
        si = si._replace(acc_scale=np.float32(1.0))
        if pipe.process_scan(si, T_UNIX0 + t_abs) is not None:
            est.append(np.asarray(pipe.trajectory[-1][1]))
    return np.stack(est)


def _prime(pipe, samples):
    for s in samples:
        pipe.gnss.push(s)
    pipe.initializer.done = True
    pipe.initializer.mean_acc = np.array([0.0, 0.0, 9.81])
    pipe.initializer.mean_gyr = np.zeros(3)


def test_gnss_pipeline_matches_jax():
    # test_gnss_pipeline.py's recipe, cut from 4 s to 3 s (run time).
    seq = JSYN.generate(duration=3.0, imu_rate=100.0, scan_rate=10.0, pts_per_scan=6000, seed=5)
    j_samples = JSYN.generate_gnss(seq, yaw_enu_to_world=0.4, rate=10.0, noise_m=0.02)
    t_samples = TSYN.generate_gnss(seq, yaw_enu_to_world=0.4, rate=10.0, noise_m=0.02)
    for a, b in zip(j_samples, t_samples):
        assert a.time == b.time and np.array_equal(a.ecef, b.ecef)

    jpipe = JPipe(_gnss_cfg(JCfg()))
    _prime(jpipe, j_samples)
    jpipe.state = jpipe.initializer.initial_state()
    tpipe = TPipe(_gnss_cfg(TCfg()), device="cpu")
    _prime(tpipe, t_samples)
    tpipe.state = tpipe.initializer.initial_state(device="cpu")

    j_est = _drive(seq, jpipe, JSync(img_enabled=False), JBuilder(8192, 32))
    t_est = _drive(seq, tpipe, TSync(img_enabled=False), TBuilder(8192, 32))
    assert tpipe.gnss.initialized and jpipe.gnss.initialized
    yaw = Rotation.from_matrix(tpipe.gnss.rot_we).as_euler("zyx")[0]
    assert abs(yaw - 0.4) < 0.05
    assert len(t_est) == len(j_est) >= 20
    assert tpipe.gnss_blocks > 5
    assert np.abs(t_est - j_est).max() < 15e-3
    assert tpipe.health == jpipe.health and tpipe.health["rejected"] == 0
