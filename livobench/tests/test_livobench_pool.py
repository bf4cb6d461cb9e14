"""The pool: an exact lap, replayed lap after lap."""

import math

import numpy as np
import pytest

from livobench import harness, pool
from livobench.tests import small

TRAFFIC = ("handheld_room", "urban_drive")


@pytest.mark.parametrize("name", TRAFFIC)
def test_motion_is_periodic_from_the_lap_on(name):
    m = pool.Motion(pool.load_traffic(name)["trajectory"])
    t = m.lap0 + np.linspace(0.0, m.lap_s, 997, endpoint=False)
    a = m.kinematics(t)
    b = m.kinematics(t + 3 * m.lap_s)
    for x, y, what in zip(a, b, ("pos", "vel", "acc", "yaw", "yaw rate")):
        if what == "yaw":
            y = y - 6 * math.pi  # one turn per lap
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-8, err_msg=what)


@pytest.mark.parametrize("name", TRAFFIC)
def test_motion_derivatives_are_consistent(name):
    """Velocity and acceleration are the derivatives of the position, yaw
    rate that of the yaw, through the rest, the ramp and the lap."""
    m = pool.Motion(pool.load_traffic(name)["trajectory"])
    t = np.linspace(0.0, m.lap0 + 2 * m.lap_s, 4001)[1:-1]
    h = 1e-5
    p0, v0, a0, y0, w0 = m.kinematics(t)
    pp, vp, _, yp, _ = m.kinematics(t + h)
    pm, vm, _, ym, _ = m.kinematics(t - h)
    scale = max(1.0, m.speed)
    np.testing.assert_allclose((pp - pm) / (2 * h), v0, atol=1e-5 * scale)
    np.testing.assert_allclose((yp - ym) / (2 * h), w0, atol=1e-5 * scale)
    # Acceleration jumps where a straight meets an arc: compare away from those.
    smooth = np.all(np.abs((vp - vm) / (2 * h) - a0) < 1e-3 * scale**2, axis=1)
    assert smooth.mean() > 0.98
    # At rest before the ramp; the ramp reaches the lap speed exactly.
    rest = t < m.rest_s
    np.testing.assert_array_equal(v0[rest], 0.0)
    assert abs(np.linalg.norm(m.kinematics(np.array([m.lap0]))[1][0, :2]) - m.speed) < 1e-9


def test_lap_path_is_closed_and_continuous():
    path = pool.LapPath(160.0, 60.0, 10.0)
    s = np.linspace(0.0, path.length, 20001)
    xy, heading, _ = path.at(s)
    np.testing.assert_allclose(xy[0], xy[-1], atol=1e-9)
    assert abs(heading[-1] - heading[0] - 2 * math.pi) < 1e-9
    step = np.linalg.norm(np.diff(xy, axis=0), axis=1)
    np.testing.assert_allclose(step, path.length / 20000, rtol=1e-6)
    assert abs(path.length - (2 * 140 + 2 * 40 + 2 * math.pi * 10)) < 1e-9


@pytest.fixture(scope="module")
def room_pools():
    c = small.cell(small.ROOM)
    cfg = harness.reference_config(c.config_file["config"], small.SMALL["avia_livo"])
    tr = small.small_traffic(c)
    return [pool.build_pool(tr, cfg, seed, "cpu") for seed in (3, 3, 4)], cfg


def test_lap_k_is_lap_zero_with_shifted_stamps(room_pools):
    p = room_pools[0][0]
    n = len(p.lap)
    stream = p.stream()
    recs = [next(stream) for _ in range(len(p.lead) + 3 * n)]
    assert recs[: len(p.lead)] == p.lead
    for k in range(3):
        for a, b in zip(recs[len(p.lead) + k * n: len(p.lead) + (k + 1) * n], p.lap):
            assert a.kind == b.kind and a.data is b.data
            assert a.stamp == b.stamp + k * p.period
    stamps = [r.stamp for r in recs]
    assert stamps == sorted(stamps)  # one unbroken, ordered stream


def test_lap_holds_whole_sensor_periods(room_pools):
    p, cfg = room_pools[0][0], room_pools[1]
    tr = pool.load_traffic("handheld_room")
    kinds = [r.kind for r in p.lap]
    assert kinds.count(pool.IMU) == round(p.period * tr["imu"]["rate_hz"])
    assert kinds.count(pool.LIDAR) == round(p.period * tr["lidar"]["rate_hz"])
    assert kinds.count(pool.IMG) == round(p.period * tr["camera"]["rate_hz"])
    # Frames carry the rig's stamp: true time minus the config's delta_time.
    frames = [r.stamp for r in p.lead + p.lap if r.kind == pool.IMG]
    true = np.asarray(frames) + cfg.vio.delta_time
    np.testing.assert_allclose((true - tr["camera"]["offset_s"]) * 10.0, np.arange(len(true)), atol=1e-9)


def test_seed_draws_points_not_work(room_pools):
    (a, b, c), _ = room_pools
    assert [(r.kind, r.stamp) for r in a.lap] == [(r.kind, r.stamp) for r in c.lap]
    for ra, rb, rc in zip(a.lap, b.lap, c.lap):
        for x, y in zip(ra.data, rb.data):
            np.testing.assert_array_equal(x, y)  # the same seed, the same pool
    scans_a = [r.data[0] for r in a.lap if r.kind == pool.LIDAR]
    scans_c = [r.data[0] for r in c.lap if r.kind == pool.LIDAR]
    assert any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(scans_a, scans_c))
    # The reader's rule leaves each sweep within a few points of half.
    n = small.POINTS["avia_livo"]
    for x in scans_a + scans_c:
        assert n // 2 - n // 10 <= len(x) <= n // 2


def test_reader_rule_decimates_then_gates_range():
    import torch

    pts = torch.tensor([[0.5, 0, 0], [2, 0, 0], [3, 0, 0], [0.1, 0.1, 5], [200, 0, 0], [math.nan, 0, 0]])
    keep = pool.reader_keep(pts, 1, blind=0.8, max_range=100.0)
    assert keep.tolist() == [False, True, True, False, False, False]
    keep = pool.reader_keep(pts, 2, blind=0.8, max_range=100.0)
    assert keep.tolist() == [False, False, True, False, False, False]
    # A chunk of sweeps: the rule applies to each sweep's own indices.
    two = pool.reader_keep(torch.stack([pts, pts]), 2, blind=0.8, max_range=100.0)
    assert two.tolist() == [keep.tolist()] * 2


def test_street_scene_sweeps_are_full_and_in_range():
    tr = pool.load_traffic("urban_drive")
    m = pool.Motion(tr["trajectory"])
    scene = pool.make_scene(tr["scene"], m)
    import torch

    gen = torch.Generator().manual_seed(5)
    for t in (m.lap0, m.lap0 + 13.0, m.lap0 + 31.0):
        _, pos = m.pose(t)
        pts = scene.sample(gen, 5000, pos[0, :2], "cpu").numpy()
        assert pts.shape == (5000, 3)
        r = np.linalg.norm(pts[:, :2] - pos[0, :2], axis=1)
        assert r.max() <= tr["scene"]["building_range_m"] + 1e-9
        assert (pts[:, 2] > tr["scene"]["ground_z"] + 0.5).mean() > 0.4  # buildings seen
