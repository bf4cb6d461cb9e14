"""Port parity for the recorded-data path's front: the rosbag V2.0 reader,
the ROS1 message parsers, the bag -> FLVO converter and the vendored LZ4
frame codec, against the JAX package on the same bytes.

Everything here is host code over bytes, so every comparison is exact:
records and payloads equal, parsed fields equal in value and dtype, and
converted logs equal byte for byte. The golden fixtures in tests/fixtures
were written by an independent generator; the synthetic bags come from
tests/test_rosbag.py's writer (every input from a numpy seed).
"""

import io
import os

import numpy as np
import pytest

from fastlivo_tpu.io import lz4f as JLZ
from fastlivo_tpu.io import rosbag as JRB
from fastlivo_tpu_torch.io import lz4f as TLZ
from fastlivo_tpu_torch.io import rosbag as TRB
from tests.test_rosbag import (
    _make_messages,
    _ros_header_msg,
    _U32,
    ser_custommsg,
    ser_image,
    ser_imu,
    ser_pointcloud2,
    write_bag,
)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN = {
    # bag -> (lidar topic, imu topic, lidar type)
    "velodyne_bz2.bag": ("/velodyne_points", "/imu/data", 2),
    "livox_timebase.bag": ("/livox/lidar", "/imu/data", 1),
    "bigendian_cloud.bag": ("/ouster/points", "/imu/data", 2),
}


def same_parse(a, b):
    """Two parser outputs (nested tuples / dicts of arrays) are equal in
    value, dtype and shape."""
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_parse(x, y)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same_parse(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_bags_read_record_for_record(name):
    path = os.path.join(FIX, name)
    got, want = list(TRB.read_bag(path)), list(JRB.read_bag(path))
    assert len(got) == len(want) > 0
    assert got == want
    for topic, msg_type, _, raw in got:
        if msg_type.endswith("CustomMsg"):
            same_parse(TRB.parse_livox_custommsg(raw), JRB.parse_livox_custommsg(raw))
        elif msg_type.endswith("PointCloud2"):
            same_parse(TRB.parse_pointcloud2(raw), JRB.parse_pointcloud2(raw))
        else:
            same_parse(TRB.parse_imu(raw), JRB.parse_imu(raw))
    # A topic filter keeps the bag order of what it lets through.
    topic = got[-1][0]
    assert list(TRB.read_bag(path, {topic})) == [m for m in want if m[0] == topic]


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_bags_convert_to_identical_logs(tmp_path, name):
    lidar, imu, kind = GOLDEN[name]
    path = os.path.join(FIX, name)
    t_out, j_out = tmp_path / "t.flvo", tmp_path / "j.flvo"
    t_counts = TRB.bag_to_flvo(path, str(t_out), lidar, imu, lidar_type=kind)
    j_counts = JRB.bag_to_flvo(path, str(j_out), lidar, imu, lidar_type=kind)
    assert t_counts == j_counts and t_counts["scans"] > 0
    assert t_out.read_bytes() == j_out.read_bytes()


@pytest.mark.parametrize("compression", [b"none", b"bz2", b"lz4"])
@pytest.mark.parametrize("use_custommsg,lidar_topic,lidar_type", [
    (True, "/livox/lidar", 1),
    (False, "/velodyne_points", 2),
])
def test_bag_to_flvo_identical_logs(tmp_path, compression, use_custommsg, lidar_topic, lidar_type):
    """tests/test_rosbag.py's converter cases, every chunk compression: the
    port's log equals the JAX package's byte for byte, and the CLI entry
    point writes the same file."""
    msgs, _ = _make_messages(np.random.default_rng(3), use_custommsg)
    bag = str(tmp_path / "t.bag")
    write_bag(bag, msgs, compression)
    assert list(TRB.read_bag(bag)) == list(JRB.read_bag(bag))
    kw = dict(lidar_topic=lidar_topic, imu_topic="/imu", img_topic="/camera/image", lidar_type=lidar_type)
    t_counts = TRB.bag_to_flvo(bag, str(tmp_path / "t.flvo"), **kw)
    j_counts = JRB.bag_to_flvo(bag, str(tmp_path / "j.flvo"), **kw)
    assert t_counts == j_counts == {"imu": 40, "scans": 2, "images": 1}
    want = (tmp_path / "j.flvo").read_bytes()
    assert (tmp_path / "t.flvo").read_bytes() == want
    TRB.main([bag, str(tmp_path / "cli.flvo"), "--lidar-topic", lidar_topic, "--imu-topic", "/imu",
              "--img-topic", "/camera/image", "--lidar-type", str(lidar_type)])
    assert (tmp_path / "cli.flvo").read_bytes() == want


def _custommsg(rng, n, t):
    return ser_custommsg(
        t, rng.uniform(-30, 30, (n, 3)).astype(np.float32),
        offs_ns=np.sort(rng.integers(0, 100_000_000, n)).astype(np.uint32),
        refl=rng.integers(0, 256, n).astype(np.uint8),
        tag=rng.choice([0x00, 0x10, 0x20, 0x30], n).astype(np.uint8),
        line=rng.integers(0, 8, n).astype(np.uint8),
    )


def _pointcloud2(rng, n, t):
    return ser_pointcloud2(
        t, rng.uniform(-30, 30, (n, 3)).astype(np.float32),
        intensity=rng.uniform(0, 255, n).astype(np.float32),
        ring=rng.integers(0, 32, n).astype(np.uint16),
        times=np.sort(rng.uniform(0, 0.1, n)).astype(np.float32),
    )


@pytest.mark.parametrize("use_custommsg", [True, False], ids=["custommsg", "pointcloud2"])
def test_cloud_parsers_match(use_custommsg):
    rng = np.random.default_rng(11)
    for n, t in ((0, 5.0), (1, 6.25), (777, 1_700_000_123.5)):
        if use_custommsg:
            raw = _custommsg(rng, n, t)
            same_parse(TRB.parse_livox_custommsg(raw), JRB.parse_livox_custommsg(raw))
        else:
            raw = _pointcloud2(rng, n, t)
            same_parse(TRB.parse_pointcloud2(raw), JRB.parse_pointcloud2(raw))


def test_custommsg_zero_stamp_takes_timebase():
    """A zero header stamp falls back to the timebase (ns)."""
    rng = np.random.default_rng(12)
    raw = bytearray(_custommsg(rng, 50, 0.0))
    tb = 1_700_000_000_123_456_789
    off = len(_ros_header_msg(0.0))
    raw[off : off + 8] = tb.to_bytes(8, "little")
    got, want = TRB.parse_livox_custommsg(bytes(raw)), JRB.parse_livox_custommsg(bytes(raw))
    same_parse(got, want)
    assert got[0] == tb * 1e-9


def _encoded_image(enc: bytes, img: np.ndarray, step_pad: int = 0) -> bytes:
    h, w = img.shape[:2]
    row = img.reshape(h, -1)
    step = row.shape[1] + step_pad
    data = np.zeros((h, step), np.uint8)
    data[:, : row.shape[1]] = row
    out = _ros_header_msg(3.25)
    out += _U32.pack(h) + _U32.pack(w) + _U32.pack(len(enc)) + enc
    out += b"\x00" + _U32.pack(step) + _U32.pack(data.size) + data.tobytes()
    return out


def test_imu_and_image_parsers_match():
    rng = np.random.default_rng(13)
    for t in (0.0, 12.5, 1_700_000_000.123):
        raw = ser_imu(t, rng.normal(size=3), rng.normal(size=3) + [0, 0, 9.81])
        same_parse(TRB.parse_imu(raw), JRB.parse_imu(raw))
    gray = rng.integers(0, 256, (17, 23)).astype(np.uint8)
    color = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
    cases = [ser_image(2.0, gray), _encoded_image(b"8UC1", gray, 5)]
    cases += [_encoded_image(enc, color, pad) for enc in (b"bgr8", b"rgb8", b"8UC3") for pad in (0, 3)]
    for raw in cases:
        same_parse(TRB.parse_image(raw), JRB.parse_image(raw))
    bad = _encoded_image(b"mono16", gray)
    for mod in (TRB, JRB):
        with pytest.raises(ValueError, match="encoding"):
            mod.parse_image(bad)


def test_compressed_image_parser_matches():
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(14)
    buf = io.BytesIO()
    pil.fromarray(rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)).save(buf, format="PNG")
    payload = buf.getvalue()
    fmt = b"png"
    raw = _ros_header_msg(4.5) + _U32.pack(len(fmt)) + fmt + _U32.pack(len(payload)) + payload
    same_parse(TRB.parse_compressed_image(raw), JRB.parse_compressed_image(raw))


LZ4_CASES = {
    "empty": lambda rng: b"",
    "one": lambda rng: b"a",
    "overlap": lambda rng: b"abcabcabcabcabcabcabcabcabcabcabc",
    "random": lambda rng: bytes(rng.integers(0, 256, 20000, dtype=np.uint8)),
    "zeros": lambda rng: np.zeros(70000, np.uint8).tobytes(),
    "text": lambda rng: b"lidar-imu-visual-odometry " * 2000,
    "floats": lambda rng: np.arange(30000, dtype=np.float32).tobytes(),
    "cloud": lambda rng: np.round(rng.normal(size=(3000, 5)), 2).astype("<f4").tobytes(),
}


@pytest.mark.parametrize("case", sorted(LZ4_CASES))
def test_lz4_frames_identical(case):
    data = LZ4_CASES[case](np.random.default_rng(15))
    for checksum in (True, False):
        frame = TLZ.compress(data, content_checksum=checksum)
        assert frame == JLZ.compress(data, content_checksum=checksum)
        assert TLZ.decompress(frame) == JLZ.decompress(frame) == data
    assert TLZ.xxh32(data) == JLZ.xxh32(data)
    assert TLZ.xxh32(data, seed=0x9E3779B1) == JLZ.xxh32(data, seed=0x9E3779B1)


def test_lz4_rejects_corruption():
    frame = bytearray(TLZ.compress(b"lidar-imu-visual-odometry " * 500))
    frame[20] ^= 0xFF
    for mod in (TLZ, JLZ):
        with pytest.raises(ValueError):
            mod.decompress(bytes(frame))
    with pytest.raises(ValueError, match="magic"):
        TLZ.decompress(b"\x00" * 16)
