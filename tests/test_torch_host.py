"""Port parity for the host side of the pipeline: the YAML reader and the
config tree, StepConfig.from_config, the synthetic generator, the
measurement synchronizer and window builder, FLVO logs in both
directions, the TUM/PCD writers, the trajectory metrics, and checkpoint
resume through the CLI runner.

Everything here is host NumPy or small tensors, so every comparison is
exact (bitwise or `==`) except the rendered frames (two renderers of one
analytic room, within 1e-3 intensity units) and the metrics (f64, 1e-12).
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from fastlivo_tpu.io import export as JEXP
from fastlivo_tpu.io import logio as JLOG
from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.io.sync import MeasurementSynchronizer as JSync
from fastlivo_tpu.io.sync import WindowBuilder as JBuilder
from fastlivo_tpu.maps import voxel_map as JV
from fastlivo_tpu.models.pipeline import StepConfig as JStep
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu.utils import config as JC
from fastlivo_tpu.utils import metrics as JM
from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.io import export as TEXP
from fastlivo_tpu_torch.io import logio as TLOG
from fastlivo_tpu_torch.io import synthetic as TSYN
from fastlivo_tpu_torch.io.sensors import ImageFrame as TImage
from fastlivo_tpu_torch.io.sensors import ImuSample as TImu
from fastlivo_tpu_torch.io.sensors import LidarScan as TScan
from fastlivo_tpu_torch.io.sync import MeasurementSynchronizer as TSync
from fastlivo_tpu_torch.io.sync import WindowBuilder as TBuilder
from fastlivo_tpu_torch.models.pipeline import StepConfig as TStep
from fastlivo_tpu_torch.ops.camera import Pinhole as TPinhole
from fastlivo_tpu_torch.utils import config as TC
from fastlivo_tpu_torch.utils import metrics as TM

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
CAM = (64, 48, 40.0, 40.0, 32.0, 24.0)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_and_config(path):
    with open(path) as f:
        assert TC.read_yaml(path) == yaml.safe_load(f)
    assert dataclasses.asdict(TC.load_config(path)) == dataclasses.asdict(JC.load_config(path))


def test_yaml_reader_rejects_other_constructs():
    assert TC.parse_yaml("a: 1\nb: [1, 2.5,\n  3]  # c\nns:\n  x: yes\n  y: 'q'\n") == {
        "a": 1, "b": [1, 2.5, 3], "ns": {"x": True, "y": "q"}
    }
    for bad in ("a:\n  b:\n    c: 1\n", "a: {b: 1}\n", "- 1\n", "a: [[1]]\n", "a: &x 1\n"):
        with pytest.raises(ValueError):
            TC.parse_yaml(bad)


def test_config_overrides():
    ov = {"lio.measurement_model": "vgicp", "vio.img_enable": 0, "map.capacity": 1 << 12,
          "camera.rcl": [0, 0, 1, -1, 0, 0, 0, -1, 0]}
    assert dataclasses.asdict(TC.load_config(CONFIGS[0], ov)) == dataclasses.asdict(
        JC.load_config(CONFIGS[0], ov)
    )


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_step_config_from_config(path):
    t = TStep.from_config(TC.load_config(path))
    j = JStep.from_config(JC.load_config(path))
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name


@pytest.fixture(scope="module")
def seqs():
    """One sequence from each package's generator (same seed)."""
    kw = dict(duration=1.2, imu_rate=100.0, scan_rate=10.0, pts_per_scan=1500, seed=4,
              n_boxes=2, cam_rate=10.0, cam_offset=0.055)
    return (
        JSYN.generate(camera=JPinhole(*CAM), **kw),
        TSYN.generate(camera=TPinhole(*CAM), device="cpu", **kw),
    )


def test_synthetic_generate_matches_jax(seqs):
    j, t = seqs
    assert len(j.imu) == len(t.imu) and len(j.scans) == len(t.scans) and len(j.frames) == len(t.frames)
    for a, b in zip(j.imu, t.imu):
        assert a.stamp == b.stamp and np.array_equal(a.gyr, b.gyr) and np.array_equal(a.acc, b.acc)
    for a, b in zip(j.scans, t.scans):
        assert a.stamp == b.stamp
        np.testing.assert_array_equal(a.pts, b.pts)
        np.testing.assert_array_equal(a.t_offs_ms, b.t_offs_ms)
    for name in ("gt_stamps", "gt_rot", "gt_pos", "world"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for a, b in zip(j.frames, t.frames):
        assert a.stamp == b.stamp
        np.testing.assert_allclose(b.img, a.img, atol=1e-3)


def groups_and_windows(seq, sync, builder):
    """Push a sequence's records in time order; every emitted group's
    shape and its window-builder output."""
    records = sorted(
        [(s.stamp, 0, s) for s in seq.imu]
        + [(s.end_time, 1, s) for s in seq.scans]
        + [(f.stamp, 2, f) for f in seq.frames],
        key=lambda r: (r[0], r[1]),
    )
    out = []
    for _, kind, rec in records:
        (sync.push_imu, sync.push_lidar, sync.push_image)[kind](rec)
        while (g := sync.next_group()) is not None:
            scan_input, t_end = builder.build(g)
            leaves = [scan_input.pts, scan_input.t_offs, scan_input.mask, *scan_input.imu,
                      scan_input.t_end, scan_input.acc_scale]
            out.append((g.is_lidar_end, g.lidar_beg_time, g.end_time, len(g.measures[-1].imu),
                        t_end, [np.asarray(x) for x in leaves]))
    return out


def to_port_records(seq):
    """The JAX sequence's records as the port's record types."""
    return dataclasses.replace(
        seq,
        imu=[TImu(stamp=s.stamp, gyr=s.gyr, acc=s.acc) for s in seq.imu],
        scans=[TScan(stamp=s.stamp, pts=s.pts, t_offs_ms=s.t_offs_ms, intensity=s.intensity)
               for s in seq.scans],
        frames=[TImage(stamp=f.stamp, img=f.img) for f in seq.frames],
    )


def test_sync_and_window_builder_bitwise(seqs):
    j, _ = seqs
    want = groups_and_windows(j, JSync(img_enabled=True), JBuilder(2048, 32))
    got = groups_and_windows(to_port_records(j), TSync(img_enabled=True), TBuilder(2048, 32))
    assert len(got) == len(want) > 15
    assert {g[0] for g in got} == {True, False}  # scan-end and image-bounded groups
    for a, b in zip(got, want):
        assert a[:5] == b[:5]
        for x, y in zip(a[5], b[5]):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


def same_records(a_iter, b_iter):
    a, b = list(a_iter), list(b_iter)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__ and x.stamp == y.stamp
        for name in ("gyr", "acc", "pts", "t_offs_ms", "intensity", "img"):
            if hasattr(y, name):
                xv, yv = getattr(x, name), getattr(y, name)
                assert (xv is None) == (yv is None)
                if yv is not None:
                    assert np.asarray(xv).dtype == np.asarray(yv).dtype
                    np.testing.assert_array_equal(xv, yv)
    return len(a)


def test_flvo_logs_both_ways(seqs, tmp_path):
    j, _ = seqs
    jlog, tlog = str(tmp_path / "j.flvo"), str(tmp_path / "t.flvo")
    JLOG.write_sequence(jlog, j)
    TLOG.write_sequence(tlog, to_port_records(j))
    with open(jlog, "rb") as a, open(tlog, "rb") as b:
        assert a.read() == b.read()
    kw = dict(blind=0.5, max_range=20.0, point_filter_num=2)
    n = same_records(TLOG.read_log(jlog, **kw), JLOG.read_log(jlog, **kw))
    assert n == len(j.imu) + len(j.scans) + len(j.frames)
    same_records(JLOG.read_log(tlog), TLOG.read_log(tlog))


def test_tum_pcd_and_map_cloud_writers(tmp_path):
    rng = np.random.default_rng(6)
    traj = [(0.1 * i + 1e-7 * i, rng.normal(size=3).astype(np.float32),
             rng.normal(size=4).astype(np.float32)) for i in range(20)]
    TEXP.write_tum(str(tmp_path / "t.txt"), traj)
    JEXP.write_tum(str(tmp_path / "j.txt"), traj)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    for a, b in zip(TEXP.read_tum(str(tmp_path / "t.txt")), JEXP.read_tum(str(tmp_path / "j.txt"))):
        np.testing.assert_array_equal(a, b)

    cfg = JV.VoxelMapConfig(resolution=0.5, capacity=1 << 10, max_points=4)
    pts = rng.uniform(-3, 3, (900, 3)).astype(np.float32)
    m = jax.jit(JV.insert, static_argnames="cfg")(JV.make_map(cfg), pts, np.ones(900, bool), cfg)
    mapd = {k: np.asarray(v) for k, v in m._asdict().items()}
    cloud = TEXP.map_to_cloud(convert.voxel_map_from_numpy(mapd, "cpu"))
    np.testing.assert_array_equal(cloud, JEXP.map_to_cloud(m))
    for binary in (True, False):
        TEXP.write_pcd(str(tmp_path / "t.pcd"), cloud, binary=binary)
        JEXP.write_pcd(str(tmp_path / "j.pcd"), cloud, binary=binary)
        assert (tmp_path / "t.pcd").read_bytes() == (tmp_path / "j.pcd").read_bytes()
        back = TEXP.read_pcd(str(tmp_path / "t.pcd"))
        np.testing.assert_allclose(back, cloud, rtol=0, atol=0 if binary else 1e-6)  # ascii: 6 decimals


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    gt = np.cumsum(rng.normal(size=(50, 3)), 0)
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    est = 1.1 * gt @ rot.T + 0.3 + rng.normal(scale=0.01, size=gt.shape)
    for align in (False, True):
        assert abs(TM.ate_rmse(est, gt, align=align) - JM.ate_rmse(est, gt, align=align)) < 1e-12
    for a, b in zip(TM.umeyama_alignment(est, gt), JM.umeyama_alignment(est, gt)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    rots = np.stack([np.eye(3)] * 50)
    np.testing.assert_allclose(TM.rpe(est, rots, gt, rots), JM.rpe(est, rots, gt, rots), rtol=1e-12)


def test_checkpoint_resume_equals_straight_run(tmp_path):
    """A run checkpointed after 9 scans, resumed in a fresh pipeline and
    continued to the end, writes the straight-through run's tum.txt bit for
    bit (LIVO, so both map arenas and the filter state round-trip)."""
    cam = (160, 128, 100.0, 100.0, 80.0, 64.0)
    seq = TSYN.generate(duration=1.6, imu_rate=100.0, pts_per_scan=2500, seed=2, n_boxes=0,
                        camera=TPinhole(*cam), cam_rate=10.0, cam_offset=0.055, device="cpu")
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
    ck = str(tmp_path / "ck.npz")
    straight = trun.main(base + ["--out", str(tmp_path / "a")])
    trun.main(base + ["--out", str(tmp_path / "b"), "--max-scans", "9", "--checkpoint", ck,
                      "--checkpoint-every", "9"])
    resumed = trun.main(base + ["--out", str(tmp_path / "c"), "--resume", ck])

    assert len(straight.n_effective) >= 5 and max(straight.n_selected) > 0
    assert (tmp_path / "c" / "tum.txt").read_bytes() == (tmp_path / "a" / "tum.txt").read_bytes()
    assert resumed.health == straight.health and resumed.n_effective == straight.n_effective
    np.testing.assert_array_equal(resumed.map.counts.numpy(), straight.map.counts.numpy())
    np.testing.assert_array_equal(resumed.map.points.numpy(), straight.map.points.numpy())
    # A checkpoint of another schema is refused.
    with np.load(ck) as data:
        blobs = dict(data)
    blobs["header"] = np.frombuffer(b'{"schema": "other", "schema_version": 1}', np.uint8)
    np.savez(str(tmp_path / "bad.npz"), **blobs)
    with pytest.raises(ValueError, match="checkpoint"):
        trun.main(base + ["--resume", str(tmp_path / "bad.npz")])
