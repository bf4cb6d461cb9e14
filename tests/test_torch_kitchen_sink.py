"""The kitchen-sink drive through the port on the CPU, with the assertions
of tests/test_kitchen_sink.py: surfel LIO + photometric VIO on street
renders + GNSS fusion + background STD loop detection + the learned visual
gate + pose-graph correction + live-map reanchor + annotated frames +
mid-run checkpoint/resume, in one drive. Module parity tests
(tests/test_torch_gnss.py, _backend, _matcher, _reanchor, _street) hold the
numbers against JAX; this drive holds the composition, without JAX."""

import os

import numpy as np
import pytest
import torch

from fastlivo_tpu_torch.backend import visual_verify as vv
from fastlivo_tpu_torch.io import synthetic
from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer, WindowBuilder
from fastlivo_tpu_torch.maps import visual_map as vmap_mod
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models.pipeline import LivoPipeline
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.utils import checkpoint as ckpt
from fastlivo_tpu_torch.utils.config import FastLivoConfig
from fastlivo_tpu_torch.utils.metrics import ate_rmse

torch.set_num_threads(2)

CAM = Pinhole(width=320, height=256, fx=200.0, fy=200.0, cx=160.0, cy=128.0)
DUR = 26.0  # one full lap (~24.4 s warped) + revisit overlap


@pytest.fixture(scope="module")
def seq():
    return synthetic.generate_street(
        duration=DUR, pts_per_scan=1500, seed=11, max_range=12.0,
        gyro_bias=np.array([0.0, 0.0, 0.01]), imu_noise_gyr=0.03,
        camera=CAM, cam_rate=10.0, cam_offset=0.055,
        trajectory=synthetic.circuit_trajectory(), device="cpu",
    )


def make_cfg(tmp_out):
    cfg = FastLivoConfig()
    cfg.lio.max_points = 2048
    cfg.lio.measurement_model = "surfel"
    cfg.map.capacity = 1 << 16
    cfg.map.resolution = 0.8
    cfg.imu.imu_int_frame = 32
    cfg.vio.img_enable = True
    cfg.vio.max_visual_points = 4096
    cfg.vio.max_obs_per_point = 4
    cfg.camera.width, cfg.camera.height = CAM.width, CAM.height
    cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy = CAM.fx, CAM.fy, CAM.cx, CAM.cy
    cfg.camera.rcl = tuple(synthetic.R_IC_FORWARD.T.reshape(-1).tolist())
    cfg.camera.pcl = (0.0, 0.0, 0.0)
    cfg.extrinsics.extrinsic_r = (1, 0, 0, 0, 1, 0, 0, 0, 1)
    cfg.extrinsics.extrinsic_t = (0.0, 0.0, 0.0)
    cfg.gnss.gnss_en = True
    cfg.gnss.init_window = 10
    cfg.loop.loop_en = True
    cfg.loop.background = True
    cfg.loop.sub_frame_num = 5
    cfg.loop.skip_near_num = 12
    cfg.loop.corner_thre = 6.0
    cfg.loop.icp_threshold = 0.25
    cfg.loop.visual_verify_en = True
    cfg.keyframe.trans_thresh_m = 1.0
    cfg.runtime.img_save_en = True
    cfg.runtime.out_dir = tmp_out
    return cfg


def test_kitchen_sink_full_stack(seq, tmp_path):
    out_dir = str(tmp_path / "out")
    cfg = make_cfg(out_dir)
    pipe = LivoPipeline(cfg, device="cpu")
    pipe.initializer.done = True
    pipe.initializer.mean_acc = np.array([0.0, 0.0, 9.81])
    pipe.initializer.mean_gyr = np.zeros(3)
    pipe.state = pipe.initializer.initial_state(device="cpu")
    # GNSS on the drive's time base until t = 8 s (the urban-canyon outage
    # leaves the later drift for the loop closure to repair).
    for s in synthetic.generate_gnss(seq, rate=5.0, seed=3, t_unix0=0.0, noise_m=0.05):
        if s.time < 8.0:
            pipe.gnss.push(s)

    sync = MeasurementSynchronizer(img_enabled=True)
    builder = WindowBuilder(n_pts=8192, imu_window=cfg.imu.imu_int_frame)
    imu_iter = iter(seq.imu)
    pending = next(imu_iter)
    frame_iter = iter(seq.frames)
    pending_frame = next(frame_iter, None)

    ck_path = str(tmp_path / "mid.ckpt.npz")
    ck_at = int(len(seq.scans) * 0.6)
    replay, est = [], []
    n_lio = n_vio = 0
    for scan in seq.scans:
        sync.push_lidar(scan)
        while pending_frame is not None and pending_frame.stamp <= scan.end_time:
            sync.push_image(pending_frame)
            pending_frame = next(frame_iter, None)
        while pending is not None and pending.stamp < scan.end_time + 0.05:
            sync.push_imu(pending)
            pending = next(imu_iter, None)
        while (group := sync.next_group()) is not None:
            scan_input, t_abs = builder.build(group)
            scan_input = scan_input._replace(acc_scale=np.float32(pipe.acc_scale))
            if group.is_lidar_end:
                if pipe.process_scan(scan_input, t_abs) is not None:
                    n_lio += 1
                    est.append((t_abs, pipe.state.pos.numpy().copy()))
                if n_lio == ck_at:
                    ckpt.save_pipeline(ck_path, pipe)
                kind = "scan"
            else:
                img = group.measures[-1].img.img
                if pipe.process_image(scan_input, img, t_abs) is not None:
                    n_vio += 1
                kind = "img"
            if len(replay) < 12 and n_lio >= ck_at and os.path.exists(ck_path):
                replay.append((kind, scan_input, t_abs, group.measures[-1].img.img if kind == "img" else None))

    corrected = pipe.finish(out_dir)

    # --- every subsystem ran ---------------------------------------------
    assert n_lio >= 200, f"lio updates {n_lio}"
    assert n_vio >= 200, f"vio updates {n_vio}"
    assert pipe.gnss.initialized, "GNSS alignment did not initialize"
    assert int(vmap_mod.num_active(pipe.visual_map)) > 100

    est_t = np.array([t for t, _ in est])
    est_p = np.array([p for _, p in est])
    gt_p = np.stack([seq.gt_pos[np.argmin(np.abs(seq.gt_stamps - t))] for t in est_t])
    odo_ate = ate_rmse(est_p, gt_p)
    assert odo_ate < 1.5, f"odometry ATE {odo_ate:.2f} m"

    # --- a loop closed through the learned visual gate ------------------
    be = pipe.loop_backend
    assert len(be.loops) >= 1, f"no loop: rejected={be.rejected_loops}, frames={len(be._std_frame_kf)}"
    assert be._matcher is not None, "visual gate never ran"
    if vv.default_weights_paths() is not None:
        assert isinstance(be._matcher, vv.SuperPointLightGlue)

    g = be.graph
    kf_t = np.asarray(g.stamps)
    gt_kf = np.stack([seq.gt_pos[np.argmin(np.abs(seq.gt_stamps - t))] for t in kf_t])
    odo_kf_ate = ate_rmse(np.asarray(g.trans), gt_kf)
    assert corrected is not None
    corr_ate = ate_rmse(corrected[1], gt_kf)
    assert corr_ate < odo_kf_ate, (odo_kf_ate, corr_ate)

    # --- live-map reanchor under the correction -------------------------
    occ_before = int(vm.num_occupied(pipe.map))
    assert pipe.reanchor_map()
    assert int(vm.num_occupied(pipe.map)) > 0.5 * occ_before
    assert bool(torch.all(torch.isfinite(pipe.map.points)))

    # --- outputs: TUM + loop TUM + PCD + annotated frames ---------------
    for name in ("tum.txt", "loop_tum.txt", "map.pcd"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    pngs = [f for f in os.listdir(os.path.join(out_dir, "img")) if f.endswith(".png")]
    assert len(pngs) >= n_vio

    # --- checkpoint/resume continues finitely and consistently ----------
    cfg2 = make_cfg(str(tmp_path / "out2"))
    cfg2.runtime.img_save_en = False
    cfg2.loop.loop_en = False
    pipe2 = LivoPipeline(cfg2, device="cpu")
    ckpt.load_pipeline(ck_path, pipe2)
    np.testing.assert_allclose(pipe2.state.pos.numpy(), est_p[ck_at - 1], atol=1e-5)
    for kind, scan_input, t_abs, img_r in replay:
        if kind == "scan":
            pipe2.process_scan(scan_input, t_abs)
        else:
            pipe2.process_image(scan_input, img_r, t_abs)
    assert bool(torch.all(torch.isfinite(pipe2.state.pos)))
    t_last = [t for k, _, t, _ in replay if k == "scan"][-1]
    i_orig = int(np.argmin(np.abs(est_t - t_last)))
    d = float(np.linalg.norm(pipe2.state.pos.numpy() - est_p[i_orig]))
    assert d < 0.2, f"resumed trajectory diverged {d:.3f} m"
