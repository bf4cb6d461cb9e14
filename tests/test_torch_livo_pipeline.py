"""Port parity for the host pipeline as a whole: the port's LivoPipeline
against the JAX package's on the tests/test_livo_e2e.py recipe, cut to 2 s
and 4,000 points per scan, with the default point-to-plane model, VIO on
and real static initialization; and the port's CLI (`run.main` with
`--device cpu`) against the JAX runner on the same written log.

Both packages see the same records (one JAX-generated sequence, frames
included). Update stamps and health counters agree exactly, both tracks
stay within the e2e test's 8 cm ATE, and positions agree within 15 mm of
JAX at every pose. That bound is measured, not f32 rounding of one sum:
each point-to-plane fit solves the f32 normal equations of five clustered
neighbors on walls up to 10 m away (condition number up to ~1e5), XLA
contracts the Gram and adjugate products into FMAs and torch does not,
so ~5% of the plane-valid bits differ at every update
(tests/test_torch_plane_knn.py) and the two estimates wander apart by up
to ~10 mm on this sequence, then back.
"""

import numpy as np
import pytest
import torch

from fastlivo_tpu.io import logio as JLOG
from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.io.sync import MeasurementSynchronizer as JSync
from fastlivo_tpu.io.sync import WindowBuilder as JBuilder
from fastlivo_tpu.models.pipeline import LivoPipeline as JPipe
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu.run import run_log as j_run_log
from fastlivo_tpu.utils.config import load_config as j_load_config
from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.io import export as TEXP
from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer as TSync
from fastlivo_tpu_torch.io.sync import WindowBuilder as TBuilder
from fastlivo_tpu_torch.models.pipeline import LivoPipeline as TPipe
from fastlivo_tpu_torch.utils.config import load_config as t_load_config
from fastlivo_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(2)

CAM = (320, 256, 200.0, 200.0, 160.0, 128.0)
POS_TOL_M = 15e-3
N_PTS = 8192


def overrides():
    rcl = tuple(JSYN.R_IC_FORWARD.T.reshape(-1).tolist())
    return {
        "lio.max_points": 4096, "map.capacity": 1 << 16, "imu.imu_int_frame": 32,
        "vio.img_enable": True, "vio.max_visual_points": 4096, "vio.max_obs_per_point": 4,
        "camera.width": CAM[0], "camera.height": CAM[1], "camera.fx": CAM[2],
        "camera.fy": CAM[3], "camera.cx": CAM[4], "camera.cy": CAM[5],
        "camera.rcl": rcl, "camera.pcl": (0.0, 0.0, 0.0),
        "extrinsics.extrinsic_r": (1, 0, 0, 0, 1, 0, 0, 0, 1),
        "extrinsics.extrinsic_t": (0.0, 0.0, 0.0),
    }


@pytest.fixture(scope="module")
def seq():
    return JSYN.generate(
        duration=2.0, imu_rate=100.0, scan_rate=10.0, pts_per_scan=4000, seed=2,
        n_boxes=0, camera=JPinhole(*CAM), cam_rate=10.0, cam_offset=0.055,
    )


def drive(seq, pipe, sync, builder):
    """test_livo_e2e.drive_livo's loop; returns (t, pos) per LIO update."""
    imu_iter = iter(seq.imu)
    pending = next(imu_iter)
    frames = iter(seq.frames)
    frame = next(frames, None)
    est = []
    for scan in seq.scans:
        sync.push_lidar(scan)
        while frame is not None and frame.stamp <= scan.end_time:
            sync.push_image(frame)
            frame = next(frames, None)
        while pending is not None and pending.stamp < scan.end_time + 0.05:
            sync.push_imu(pending)
            pending = next(imu_iter, None)
        while (group := sync.next_group()) is not None:
            scan_input, t_abs = builder.build(group)
            scan_input = scan_input._replace(acc_scale=np.float32(pipe.acc_scale))
            if group.is_lidar_end:
                if pipe.process_scan(scan_input, t_abs) is not None:
                    est.append((t_abs, np.asarray(pipe.trajectory[-1][1])))
            else:
                pipe.process_image(scan_input, group.measures[-1].img.img, t_abs)
    return est


def ate(seq, est):
    gt = np.stack([seq.gt_pos[np.argmin(np.abs(seq.gt_stamps - t))] for t, _ in est])
    return ate_rmse(np.stack([p for _, p in est]), gt)


def test_livo_pipeline_matches_jax(seq):
    jcfg = j_load_config(None, overrides())
    tcfg = t_load_config(None, overrides())
    jpipe = JPipe(jcfg)
    tpipe = TPipe(tcfg, device="cpu")
    j_est = drive(seq, jpipe, JSync(img_enabled=True), JBuilder(N_PTS, 32))
    t_est = drive(seq, tpipe, TSync(img_enabled=True), TBuilder(N_PTS, 32))

    assert tpipe.initializer.done and jpipe.initializer.done
    assert len(t_est) == len(j_est) >= 8
    assert [t for t, _ in t_est] == [t for t, _ in j_est]
    err = np.abs(np.stack([p for _, p in t_est]) - np.stack([p for _, p in j_est])).max()
    assert err < POS_TOL_M, err
    assert tpipe.health == jpipe.health
    assert tpipe.health["rejected"] == 0
    # The VIO frames ran, selected patches, and the whole trajectory
    # (LIO and VIO poses) agrees as well.
    assert len(tpipe.trajectory) == len(jpipe.trajectory)
    assert max(tpipe.n_selected) > 0
    t_all = np.stack([p for _, p, _ in tpipe.trajectory])
    j_all = np.stack([np.asarray(p) for _, p, _ in jpipe.trajectory])
    assert np.abs(t_all - j_all).max() < POS_TOL_M
    assert ate(seq, t_est) < 0.08 and ate(seq, j_est) < 0.08


def test_cli_matches_jax_runner(seq, tmp_path):
    log = str(tmp_path / "seq.flvo")
    JLOG.write_sequence(log, seq)
    j_out, t_out = tmp_path / "jax", tmp_path / "torch"
    cfg = "configs/avia_livo.yaml"
    jpipe = j_run_log(log, j_load_config(cfg, overrides()), out_dir=str(j_out), progress=False)
    args = ["--log", log, "--config", cfg, "--out", str(t_out), "--device", "cpu"]
    for k, v in overrides().items():
        args += ["--set", f"{k}={v!r}"]
    tpipe = trun.main(args)

    assert tpipe.device.type == "cpu"
    assert tpipe.health == jpipe.health and tpipe.health["rejected"] == 0
    t_st, t_pos, t_q = TEXP.read_tum(str(t_out / "tum.txt"))
    j_st, j_pos, j_q = TEXP.read_tum(str(j_out / "tum.txt"))
    np.testing.assert_array_equal(t_st, j_st)
    assert len(t_st) >= 15
    assert np.abs(t_pos - j_pos).max() < POS_TOL_M
    assert np.abs(np.abs((t_q * j_q).sum(-1)) - 1.0).max() < 1e-4  # same attitude
    t_map = TEXP.read_pcd(str(t_out / "map.pcd"))
    j_map = TEXP.read_pcd(str(j_out / "map.pcd"))
    assert t_map.shape[1] == 3 and abs(len(t_map) - len(j_map)) <= 0.01 * len(j_map)
    assert (t_out / "time_log.csv").exists()
