"""Port parity for the LOAM-style feature selection (io/features.py) and
its use by the CLI (`preprocess.feature_extract_en`).

`classify_features` and `estimate_normals` are host NumPy in both
packages: on the tests/test_features.py scenes and on seeded random
scenes their masks are equal and the normals equal bit for bit. Then the
port's CLI with `feature_extract_en` 1 (LIO only, small widths) against
the JAX runner on the same written log: the same update stamps and
health, positions within the 15 mm of tests/test_torch_livo_pipeline.py
(the f32 point-to-plane fits round differently in the two packages; see
that file). The log's scans are ray-cast ring by ring, so consecutive
points are neighbours on a surface as on a spinning LiDAR and most of
each scan survives the selection. (The synthetic generator's own scans
shuffle points against time; on them only the capped edge points, 120 per
scan, survive, too few for the two filters to stay within 15 mm.)
"""

import numpy as np
import pytest
import torch

from fastlivo_tpu.io import features as JF
from fastlivo_tpu.io import logio as JLOG
from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.io.sensors import LidarScan as JScan
from fastlivo_tpu.io.synthetic import default_trajectory
from fastlivo_tpu.run import run_log as j_run_log
from fastlivo_tpu.utils.config import load_config as j_load_config
from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.io import export as TEXP
from fastlivo_tpu_torch.io import features as TF
from fastlivo_tpu_torch.io.sensors import LidarScan as TScan
from tests.test_features import _corner_scan

torch.set_num_threads(2)

POS_TOL_M = 15e-3


def both(scan):
    """The scan as each package's record type."""
    return (TScan(stamp=scan.stamp, pts=scan.pts, t_offs_ms=scan.t_offs_ms),
            JScan(stamp=scan.stamp, pts=scan.pts, t_offs_ms=scan.t_offs_ms))


def _occlusion_scan():
    n = 100
    near = np.stack([np.full(n, 2.0), np.linspace(-1, 0, n), np.zeros(n)], axis=1)
    far = np.stack([np.full(n, 20.0), np.linspace(0.05, 10, n), np.zeros(n)], axis=1)
    pts = np.concatenate([near, far]).astype(np.float32)
    return JScan(stamp=0.0, pts=pts, t_offs_ms=np.arange(2 * n, dtype=np.float32))


def _noisy_sweep(seed):
    """A ring sweep over a room wall with noise and random jumps."""
    rng = np.random.default_rng(seed)
    a = np.linspace(0, 2 * np.pi, 3000)
    r = np.where((a > 1.0) & (a < 1.3), 2.0, 6.0) + rng.normal(0, 0.01, a.size)
    pts = np.stack([r * np.cos(a), r * np.sin(a), rng.uniform(-0.2, 0.2, a.size)], 1).astype(np.float32)
    return JScan(stamp=1.0, pts=pts, t_offs_ms=np.linspace(0, 100, a.size).astype(np.float32))


SCENES = {
    "corner": lambda: _corner_scan(),
    "corner_noisy": lambda: _corner_scan(noise=0.01, seed=3),
    "short": lambda: JScan(stamp=0.0, pts=np.zeros((5, 3), np.float32), t_offs_ms=np.zeros(5, np.float32)),
    "random": lambda: JScan(stamp=0.0, pts=np.random.default_rng(1).uniform(1, 5, (600, 3)).astype(np.float32),
                            t_offs_ms=np.arange(600, dtype=np.float32)),
    "occlusion": _occlusion_scan,
    "sweep": lambda: _noisy_sweep(4),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_classify_features_masks_equal(name):
    t_scan, j_scan = both(SCENES[name]())
    for kw in (dict(), dict(max_per_segment=3, n_segments=6), dict(window=3, plane_curvature_max=0.05)):
        tp, te = TF.classify_features(t_scan, **kw)
        jp, je = JF.classify_features(j_scan, **kw)
        assert tp.dtype == bool and tp.shape == jp.shape
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(te, je)


def test_estimate_normals_equal():
    rng = np.random.default_rng(2)
    n = 400
    floor = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), np.full(n, -1.0)], 1)
    wall = np.stack([np.full(n, 4.0), rng.uniform(-3, 3, n), rng.uniform(-1, 2, n)], 1)
    stragglers = np.array([[50.0, 50.0, 50.0], [-60.0, 10.0, 30.0]])
    pts = np.concatenate([floor, wall, stragglers])
    for k, radius in ((8, 1.0), (5, 0.5)):
        tn, tv = TF.estimate_normals(pts, k=k, max_radius=radius)
        jn, jv = JF.estimate_normals(pts, k=k, max_radius=radius)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tn, jn)
        assert tv.mean() > 0.9 and not tv[-2:].any()


def ring_sweeps(seq, rings=32, per_ring=600, buckets=64, half=10.0, floor_z=-1.5):
    """`seq` with every scan replaced by a ray-cast ring sweep of the
    generator's room (walls at +-half, floor at floor_z): ring by ring,
    elevations -25..15 deg, azimuth 0..360 deg per ring, times evenly over
    the sweep, each point cast from the pose of its time bucket."""
    traj = default_trajectory()
    n = rings * per_ring
    elev = np.repeat(np.radians(np.linspace(-25.0, 15.0, rings)), per_ring)
    azim = np.tile(np.linspace(0.0, 2 * np.pi, per_ring, endpoint=False), rings)
    d_body = np.stack([np.cos(elev) * np.cos(azim), np.cos(elev) * np.sin(azim), np.sin(elev)], 1)
    t_offs = np.arange(n) * (0.1 / n)
    bucket = np.arange(n) * buckets // n
    scans = []
    for scan in seq.scans:
        rng_hit = np.empty(n)
        for b in range(buckets):
            sel = bucket == b
            rot, pos = traj.pose(scan.stamp + (b + 0.5) * 0.1 / buckets)
            d = d_body[sel] @ rot.T
            with np.errstate(divide="ignore"):
                hits = [(np.where(d[:, a] > 0, half, -half) - pos[a]) / d[:, a] for a in (0, 1)]
                hits.append(np.where(d[:, 2] < 0, (floor_z - pos[2]) / d[:, 2], np.inf))
            hits = np.where(np.stack(hits) > 0, np.stack(hits), np.inf)
            rng_hit[sel] = hits.min(axis=0)
        pts = (rng_hit[:, None] * d_body).astype(np.float32)
        scans.append(JScan(stamp=scan.stamp, pts=pts, t_offs_ms=(t_offs * 1e3).astype(np.float32)))
    seq.scans = scans
    return seq


def test_cli_feature_selection_matches_jax(tmp_path):
    seq = JSYN.generate(duration=2.5, imu_rate=100.0, scan_rate=10.0, pts_per_scan=10, seed=2, n_boxes=0)
    seq = ring_sweeps(seq)
    kept = [int((np.add(*TF.classify_features(TScan(s.stamp, s.pts, s.t_offs_ms)))).sum()) for s in seq.scans]
    assert min(kept) > 0.25 * len(seq.scans[0].pts)
    log = str(tmp_path / "seq.flvo")
    JLOG.write_sequence(log, seq)
    sets = {"lio.max_points": 4096, "map.capacity": 1 << 16, "imu.imu_int_frame": 32, "vio.img_enable": 0,
            "preprocess.feature_extract_en": 1, "extrinsics.extrinsic_t": (0.0, 0.0, 0.0)}
    cfg = "configs/avia_livo.yaml"
    jpipe = j_run_log(log, j_load_config(cfg, sets), out_dir=str(tmp_path / "jax"), progress=False)
    args = ["--log", log, "--config", cfg, "--out", str(tmp_path / "torch"), "--device", "cpu"]
    for k, v in sets.items():
        args += ["--set", f"{k}={v!r}"]
    tpipe = trun.main(args)

    assert tpipe.cfg.preprocess.feature_extract_en
    assert len(tpipe.timer.samples["features"]) == len(seq.scans)
    assert tpipe.health == jpipe.health
    t_st, t_pos, _ = TEXP.read_tum(str(tmp_path / "torch" / "tum.txt"))
    j_st, j_pos, _ = TEXP.read_tum(str(tmp_path / "jax" / "tum.txt"))
    np.testing.assert_array_equal(t_st, j_st)
    assert len(t_st) >= 10 and np.all(np.isfinite(t_pos))
    assert np.abs(t_pos - j_pos).max() < POS_TOL_M
