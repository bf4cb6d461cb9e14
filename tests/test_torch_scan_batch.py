"""Scan batching in the port: `lio_scan_multi` (K chained scan-end steps)
and LivoPipeline's deferred-fetch batching (`lio.scan_batch` K > 1 and 0).

- `lio_scan_multi` with the surfel model on chip_smoke.Scene's room,
  scan-end groups only, at tests/test_torch_pipeline.py's sizes, against
  the JAX package's (per scan: position within 2 mm, attitude within
  1e-3 rad, n_effective within 2%, the health-gate decision exactly; the
  final map's counts exactly), and bit for bit against the port's own K
  sequential `lio_scan_step` calls.
- LivoPipeline with scan_batch 4 and 0 against 1, for LIO and for LIVO
  (the recipes of tests/test_scan_batch.py:67 and :97 on the port's
  generator): the same trajectory rows (scan-end and image rows, the
  same stamps in the same order) within 1e-6 m, the same counters.
- A batched run checkpointed mid-batch and resumed writes the straight
  run's tum.txt bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models import lio as JL
from fastlivo_tpu.models import pipeline as JP
from fastlivo_tpu.models.imu import ImuWindow as JImu
from fastlivo_tpu.state import NavState as JNav
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.io import logio as TLOG
from fastlivo_tpu_torch.io import synthetic as TSYN
from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer, WindowBuilder
from fastlivo_tpu_torch.maps import voxel_map as TV
from fastlivo_tpu_torch.models import lio as TL
from fastlivo_tpu_torch.models import pipeline as TP
from fastlivo_tpu_torch.models.imu import ImuWindow
from fastlivo_tpu_torch.models.pipeline import LivoPipeline
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.utils.config import load_config

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K_BATCH = 4
BATCH_TOL_M = 1e-6


def _step_cfgs():
    """test_torch_pipeline.py's surfel sizes, without the camera."""
    j = JP.StepConfig(
        map_cfg=JV.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, nearby_type=18,
                                  lookup_unique_cap=1024),
        lio_cfg=JL.LioConfig(measurement_model="surfel"), ds_capacity=4096, imu_window=32,
    )
    t = TP.StepConfig(
        map_cfg=TV.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, nearby_type=18,
                                  lookup_unique_cap=1024),
        lio_cfg=TL.LioConfig(measurement_model="surfel"), ds_capacity=4096, imu_window=32,
    )
    return j, t


def lio_only_scans(scene, k_scans):
    """chip_smoke.Scene's room and trajectory, scan-end groups only: scan k
    covers [t0, t0 + PAIR_DT] with t0 = HALF_DT + (k - 1) * PAIR_DT, its IMU
    window the same span, so K chained LIO steps follow the trajectory."""
    out = []
    for k in range(1, k_scans + 1):
        t0 = cs.HALF_DT + (k - 1) * cs.PAIR_DT
        t_offs = np.sort(scene.rng.uniform(0.0, cs.PAIR_DT, scene.n_raw))
        w = scene.room_points(scene.n_raw)
        stamps = np.linspace(0.0, cs.PAIR_DT, scene.imu_m)
        out.append(dict(
            pts=(w - cs.pose_at(t0 + t_offs)).astype(np.float32), t_offs=t_offs.astype(np.float32),
            mask=np.ones(scene.n_raw, bool),
            imu=dict(stamps=stamps.astype(np.float32), gyr=np.zeros((scene.imu_m, 3), np.float32),
                     acc=cs.specific_force(t0 + stamps).astype(np.float32), mask=np.ones(scene.imu_m, bool)),
            t_end=np.float32(cs.PAIR_DT), acc_scale=np.float32(1.0),
        ))
    return out


def _jscan(d):
    return JP.ScanInput(
        pts=jnp.asarray(d["pts"]), t_offs=jnp.asarray(d["t_offs"]), mask=jnp.asarray(d["mask"]),
        imu=JImu(**{k: jnp.asarray(v) for k, v in d["imu"].items()}),
        t_end=jnp.asarray(d["t_end"]), acc_scale=jnp.asarray(d["acc_scale"]),
    )


def _stack(scans):
    return TP.ScanInput(
        *(torch.stack(xs) for xs in zip(*[(s.pts, s.t_offs, s.mask) for s in scans])),
        imu=ImuWindow(*(torch.stack(xs) for xs in zip(*[s.imu for s in scans]))),
        t_end=torch.stack([s.t_end for s in scans]), acc_scale=torch.stack([s.acc_scale for s in scans]),
    )


def _quat_angle(qa, qb):
    return 2.0 * np.arccos(np.clip(abs(float(np.dot(qa, qb))), 0.0, 1.0))


def test_lio_scan_multi_matches_jax_and_sequential():
    scene = cs.Scene(8192, 32, seed=0)
    boot = scene.bootstrap_scan()
    scans = lio_only_scans(scene, K_BATCH)
    jcfg, tcfg = _step_cfgs()
    i3, z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

    # JAX: bootstrap, then one lio_scan_multi over the K stacked scans.
    st0 = JNav(**{k: jnp.asarray(v) for k, v in scene.initial_state().items()})
    m0 = jax.jit(JP.bootstrap_map, static_argnames=("cfg", "axis_name"))(
        JV.make_map(jcfg.map_cfg), _jscan(boot), st0, jnp.asarray(i3), jnp.asarray(z3), jcfg
    )
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[_jscan(d) for d in scans])
    j_st, j_m, j_sum, _ = jax.jit(JP.lio_scan_multi, static_argnames=("cfg", "axis_name"))(
        st0, m0, stacked, jnp.asarray(i3), jnp.asarray(z3), jcfg
    )
    j_sum = np.asarray(j_sum)

    # Port: the same inputs, multi and sequential.
    dev = torch.device("cpu")
    tscans = [cs.to_scan_input(d, dev) for d in scans]
    ti3, tz3 = torch.from_numpy(i3), torch.from_numpy(z3)

    def start():
        st = convert.nav_state_from_numpy(scene.initial_state(), dev)
        m = TP.bootstrap_map(TV.make_map(tcfg.map_cfg, device=dev), cs.to_scan_input(boot, dev), st, ti3, tz3, tcfg)
        return st, m

    st, m = start()
    t_st, t_m, t_sum, (clouds, masks) = TP.lio_scan_multi(st, m, _stack(tscans), ti3, tz3, tcfg)
    st, m = start()
    seq = []
    for sc in tscans:
        st, m, _, (p_w, msk), s = TP.lio_scan_step(st, m, sc, ti3, tz3, tcfg)
        seq.append((s, p_w, msk))

    assert t_sum.shape == (K_BATCH, 11) and clouds.shape == (K_BATCH, 4096, 3) and masks.shape == (K_BATCH, 4096)
    for k, (s, p_w, msk) in enumerate(seq):
        assert torch.equal(t_sum[k], s) and torch.equal(clouds[k], p_w) and torch.equal(masks[k], msk)
    for a, b in zip(t_st, st):
        assert torch.equal(a, b)
    for a, b in zip(t_m, m):
        assert torch.equal(a, b)

    t_sum = t_sum.numpy()
    for k in range(K_BATCH):
        assert np.linalg.norm(t_sum[k, 0:3] - j_sum[k, 0:3]) <= 2e-3, k
        assert _quat_angle(t_sum[k, 3:7], j_sum[k, 3:7]) <= 1e-3, k
        assert abs(t_sum[k, 7] - j_sum[k, 7]) <= 0.02 * j_sum[k, 7], k
        assert t_sum[k, 9] == j_sum[k, 9] == 1.0, k
        t_k = cs.HALF_DT + (k + 1) * cs.PAIR_DT
        assert np.linalg.norm(t_sum[k, 0:3] - cs.pose_at(t_k)) < 0.05, k
    np.testing.assert_array_equal(t_m.counts.numpy(), np.asarray(j_m.counts))
    np.testing.assert_allclose(t_st.pos.numpy(), np.asarray(j_st.pos), rtol=0, atol=2e-3)


def drive(seq, cfg):
    """Push a sequence's records in time order through the synchronizer and
    the pipeline (tests/test_torch_livo_pipeline.py's loop), then flush."""
    pipe = LivoPipeline(cfg, device="cpu")
    sync = MeasurementSynchronizer(img_enabled=cfg.vio.img_enable)
    builder = WindowBuilder(cfg.lio.max_points * 2, cfg.imu.imu_int_frame)
    imu_iter = iter(seq.imu)
    pending = next(imu_iter)
    frames = iter(seq.frames or [])
    frame = next(frames, None)
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
                pipe.process_scan(scan_input, t_abs)
            else:
                pipe.process_image(scan_input, group.measures[-1].img.img, t_abs)
    pipe.flush_scans()
    return pipe


def same_runs(a, b):
    ta = np.asarray([t for t, _, _ in a.trajectory])
    tb = np.asarray([t for t, _, _ in b.trajectory])
    np.testing.assert_array_equal(ta, tb)
    pa = np.stack([p for _, p, _ in a.trajectory])
    pb = np.stack([p for _, p, _ in b.trajectory])
    np.testing.assert_allclose(pa, pb, rtol=0, atol=BATCH_TOL_M)
    qa = np.stack([q for _, _, q in a.trajectory])
    qb = np.stack([q for _, _, q in b.trajectory])
    np.testing.assert_allclose(qa, qb, rtol=0, atol=1e-6)
    assert a.n_effective == b.n_effective and a.n_selected == b.n_selected
    assert a.health == b.health and a.vio_before_lio == b.vio_before_lio
    assert a._epoch_stamps == b._epoch_stamps
    return len(ta)


LIO_SETS = {"lio.max_points": 4096, "map.capacity": 1 << 14, "imu.imu_int_frame": 32, "vio.img_enable": False}


@pytest.fixture(scope="module")
def lio_seq():
    return TSYN.generate(duration=3.0, imu_rate=100.0, scan_rate=10.0, pts_per_scan=3000, seed=3, device="cpu")


def test_pipeline_scan_batch_matches_unbatched_lio(lio_seq):
    runs = {b: drive(lio_seq, load_config(None, {**LIO_SETS, "lio.scan_batch": b})) for b in (1, K_BATCH, 0)}
    assert runs[1]._batch_eligible is False and runs[K_BATCH]._batch_eligible and runs[0]._batch_eligible
    assert not runs[0]._pending and not runs[K_BATCH]._pending
    n = same_runs(runs[K_BATCH], runs[1])
    assert n == same_runs(runs[0], runs[1]) >= 15
    assert runs[1].health["rejected"] == 0
    for b in (K_BATCH, 0):
        np.testing.assert_array_equal(runs[b].map.counts.numpy(), runs[1].map.counts.numpy())


def test_rejected_scans_batch_like_unbatched(lio_seq):
    """Every update rejected by the health gate (max_jump_m 0): the
    counters and the (propagated) trajectory agree across modes."""
    sets = {**LIO_SETS, "lio.max_jump_m": 0.0}
    one = drive(lio_seq, load_config(None, {**sets, "lio.scan_batch": 1}))
    for b in (K_BATCH, 0):
        same_runs(drive(lio_seq, load_config(None, {**sets, "lio.scan_batch": b})), one)
    assert one.health["rejected"] == len(one.n_effective) >= 15


CAM = (320, 256, 200.0, 200.0, 160.0, 128.0)


def test_pipeline_scan_batch_matches_unbatched_livo():
    seq = TSYN.generate(duration=2.0, imu_rate=100.0, scan_rate=10.0, pts_per_scan=4000, seed=5, n_boxes=0,
                        camera=Pinhole(*CAM), cam_rate=10.0, cam_offset=0.055, device="cpu")
    rcl = tuple(TSYN.R_IC_FORWARD.T.reshape(-1).tolist())
    sets = {"lio.max_points": 4096, "map.capacity": 1 << 14, "imu.imu_int_frame": 32, "vio.img_enable": True,
            "vio.max_visual_points": 4096, "vio.max_obs_per_point": 4,
            "camera.width": CAM[0], "camera.height": CAM[1], "camera.fx": CAM[2], "camera.fy": CAM[3],
            "camera.cx": CAM[4], "camera.cy": CAM[5], "camera.rcl": rcl, "camera.pcl": (0.0, 0.0, 0.0),
            "extrinsics.extrinsic_t": (0.0, 0.0, 0.0)}
    runs = {b: drive(seq, load_config(None, {**sets, "lio.scan_batch": b})) for b in (1, K_BATCH, 0)}
    n = same_runs(runs[K_BATCH], runs[1])
    assert n == same_runs(runs[0], runs[1]) >= 20
    assert max(runs[1].n_selected) > 0 and len(runs[1].n_selected) > 10
    np.testing.assert_array_equal(runs[0].visual_map.pos.numpy(), runs[1].visual_map.pos.numpy())


def test_gnss_keeps_per_scan_fetches():
    """The GNSS block is linearized at each scan's prior on the host, so
    GNSS turns batching off, as in the JAX package."""
    cfg = load_config(None, {**LIO_SETS, "lio.scan_batch": K_BATCH, "gnss.gnss_en": True})
    pipe = LivoPipeline(cfg, device="cpu")
    assert pipe.scan_batch == K_BATCH and not pipe._batch_eligible


@pytest.mark.parametrize("batch", [K_BATCH, 0])
def test_batched_checkpoint_resume(tmp_path, batch):
    """Checkpointed after 9 scans (mid-batch: the runner flushes first),
    resumed in a fresh pipeline: the straight batched run's tum.txt bit for
    bit, which is also the unbatched run's."""
    cam = (160, 128, 100.0, 100.0, 80.0, 64.0)
    seq = TSYN.generate(duration=1.6, imu_rate=100.0, pts_per_scan=2500, seed=2, n_boxes=0,
                        camera=Pinhole(*cam), cam_rate=10.0, cam_offset=0.055, device="cpu")
    log = str(tmp_path / "seq.flvo")
    TLOG.write_sequence(log, seq)
    rcl = tuple(TSYN.R_IC_FORWARD.T.reshape(-1).tolist())
    sets = {"lio.max_points": 2048, "map.capacity": 1 << 14, "imu.imu_int_frame": 32,
            "vio.max_visual_points": 1024, "vio.max_obs_per_point": 4, "camera.width": cam[0],
            "camera.height": cam[1], "camera.fx": cam[2], "camera.fy": cam[3], "camera.cx": cam[4],
            "camera.cy": cam[5], "camera.rcl": rcl, "camera.pcl": (0.0, 0.0, 0.0),
            "extrinsics.extrinsic_t": (0.0, 0.0, 0.0)}
    base = ["--log", log, "--config", os.path.join(REPO, "configs", "avia_livo.yaml"), "--device", "cpu"]
    for k, v in sets.items():
        base += ["--set", f"{k}={v!r}"]
    batched = base + ["--set", f"lio.scan_batch={batch}"]
    ck = str(tmp_path / "ck.npz")
    straight = trun.main(batched + ["--out", str(tmp_path / "a")])
    trun.main(batched + ["--out", str(tmp_path / "b"), "--max-scans", "9", "--checkpoint", ck,
                         "--checkpoint-every", "9"])
    resumed = trun.main(batched + ["--out", str(tmp_path / "c"), "--resume", ck])
    trun.main(base + ["--out", str(tmp_path / "d")])

    assert straight._batch_eligible and len(straight.n_effective) >= 5 and max(straight.n_selected) > 0
    want = (tmp_path / "a" / "tum.txt").read_bytes()
    assert (tmp_path / "c" / "tum.txt").read_bytes() == want
    assert (tmp_path / "d" / "tum.txt").read_bytes() == want
    assert resumed.health == straight.health and resumed.n_effective == straight.n_effective
    np.testing.assert_array_equal(resumed.map.counts.numpy(), straight.map.counts.numpy())
