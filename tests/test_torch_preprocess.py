"""Port parity for the per-LiDAR decoders (io/preprocess.py): every
LidarType against the JAX package on the same fields, exactly (points,
times, intensities and their order), including the Velodyne time-unit
autodetection and the per-ring time reconstruction of
tests/test_preprocess.py. Every input comes from a numpy seed.
"""

import dataclasses

import numpy as np
import pytest

from fastlivo_tpu.io import preprocess as JPP
from fastlivo_tpu.utils.config import LidarParams as JParams
from fastlivo_tpu_torch.io import preprocess as TPP
from fastlivo_tpu_torch.utils.config import LidarParams as TParams
from tests.test_preprocess import _interleaved_sweep

PARAMS = [
    dict(),  # the converter's defaults: point_filter_num 2, blind 0.1
    dict(blind=2.0, max_range=25.0, point_filter_num=1, scan_line=4),
    dict(blind=0.5, max_range=100.0, point_filter_num=3),
]


def both_params(kw):
    return TParams(**kw), JParams(**kw)


def same_scan(a, b):
    assert a.stamp == b.stamp
    for name in ("pts", "t_offs_ms", "intensity"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if y is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, name)
    return len(a.pts)


def _cloud(rng, n, scale=30.0):
    pts = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    pts[:5] = [[0.01, 0.02, 0.0], [np.nan, 1.0, 1.0], [1.0, np.inf, 0.0], [50.0, 50.0, 0.0], [0.0, 0.0, 9.0]]
    return pts


def avia_fields(rng, n):
    pts = _cloud(rng, n)
    return {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "offset_time": rng.integers(0, 100_000_000, n).astype(np.int64),  # unsorted, ties
        "reflectivity": rng.integers(0, 256, n).astype(np.float32),
        "tag": rng.choice([0x00, 0x10, 0x20, 0x30, 0x12], n).astype(np.uint8),
        "line": rng.integers(0, 8, n).astype(np.uint8),
    }


def velodyne_fields(rng, n, unit):
    pts = _cloud(rng, n)
    t = np.sort(rng.uniform(0.0, 0.1, n))
    t[-1] = 0.0999
    time = {"s": t, "us": t * 1e6}[unit].astype(np.float32)
    return {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "ring": rng.integers(0, 20, n).astype(np.uint16), "time": time,
    }


def ouster_fields(rng, n):
    pts = _cloud(rng, n)
    return {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "intensity": rng.uniform(0, 1000, n).astype(np.float32),
        "t": rng.integers(0, 100_000_000, n).astype(np.uint32), "ring": rng.integers(0, 64, n).astype(np.uint8),
    }


def xt32_fields(rng, n, stamp):
    pts = _cloud(rng, n)
    return {
        "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
        "intensity": rng.uniform(0, 255, n).astype(np.float32),
        "timestamp": stamp + rng.uniform(0.0, 0.1, n), "ring": rng.integers(0, 32, n).astype(np.uint16),
    }


@pytest.mark.parametrize("kw", PARAMS, ids=["defaults", "gated", "every3"])
def test_every_decoder_matches(kw):
    rng = np.random.default_rng(21)
    tp, jp = both_params(kw)
    stamp = 1_700_000_000.25
    cases = [
        (TPP.LidarType.AVIA, avia_fields(rng, 3000)),
        (TPP.LidarType.VELO16, velodyne_fields(rng, 3000, "s")),
        (TPP.LidarType.VELO16, velodyne_fields(rng, 3000, "us")),
        (TPP.LidarType.OUST64, ouster_fields(rng, 3000)),
        (TPP.LidarType.XT32, xt32_fields(rng, 3000, stamp)),
    ]
    for kind, fields in cases:
        got = TPP.decode(int(kind), stamp, fields, tp)
        want = JPP.decode(int(kind), stamp, fields, jp)
        assert same_scan(got, want) > 0, kind
        # and through the named decoder
        named = {1: TPP.decode_avia, 2: TPP.decode_velodyne, 3: TPP.decode_ouster64, 4: TPP.decode_xt32}
        same_scan(named[int(kind)](stamp, fields, tp), want)
    assert [int(k) for k in TPP.LidarType] == [int(k) for k in JPP.LidarType] == [1, 2, 3, 4]
    with pytest.raises(ValueError):
        TPP.decode(5, stamp, cases[0][1], tp)


def test_avia_without_tag_and_line():
    rng = np.random.default_rng(22)
    fields = {k: v for k, v in avia_fields(rng, 500).items() if k not in ("tag", "line", "reflectivity")}
    for kw in PARAMS:
        tp, jp = both_params(kw)
        scan = TPP.decode_avia(3.0, fields, tp)
        assert scan.intensity is None
        same_scan(scan, JPP.decode_avia(3.0, fields, jp))


def test_velodyne_time_units_match():
    """tests/test_preprocess.py:91: seconds and microseconds both decode to
    ms offsets, the same in both packages."""
    rng = np.random.default_rng(23)
    n = 64
    x, y, z = rng.uniform(1, 5, n), rng.uniform(1, 5, n), rng.uniform(-1, 1, n)
    t_s = np.sort(rng.uniform(0.0, 0.1, n))
    t_s[0] = 0.001
    tp, jp = both_params(dict(blind=0.1, max_range=100.0, point_filter_num=1))
    for time in (t_s, t_s * 1e6):
        fields = {"x": x, "y": y, "z": z, "time": time}
        scan = TPP.decode_velodyne(0.0, fields, tp)
        same_scan(scan, JPP.decode_velodyne(0.0, fields, jp))
        np.testing.assert_allclose(scan.t_offs_ms, np.sort(t_s * 1e3), rtol=1e-5)


@pytest.mark.parametrize("time", ["zeros", "absent"])
def test_velodyne_ring_fallback_matches(time):
    """tests/test_preprocess.py:107: an all-zero (or absent) time field
    falls back to per-ring azimuth times; each ring's first point is
    dropped. Also the no-ring, no-time global sweep."""
    rng = np.random.default_rng(24)
    x, y, z, ring = _interleaved_sweep(rng, n_rings=3, n_per_ring=80, revs=1.4)
    fields = {"x": x, "y": y, "z": z, "ring": ring}
    if time == "zeros":
        fields["time"] = np.zeros(len(x))
    for kw in PARAMS:
        tp, jp = both_params(dict(kw, scan_line=16))
        got = TPP.decode_velodyne(2.0, fields, tp)
        assert same_scan(got, JPP.decode_velodyne(2.0, fields, jp)) > 0
    t_t, keep_t = TPP._velodyne_ring_times(x, y, ring)
    t_j, keep_j = JPP._velodyne_ring_times(x, y, ring)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(t_t, t_j)
    no_ring = {k: v for k, v in fields.items() if k != "ring"}
    tp, jp = both_params(dict(point_filter_num=1))
    same_scan(TPP.decode_velodyne(2.0, no_ring, tp), JPP.decode_velodyne(2.0, no_ring, jp))


def test_lidar_params_defaults_match():
    assert dataclasses.asdict(TParams()) == dataclasses.asdict(JParams())
