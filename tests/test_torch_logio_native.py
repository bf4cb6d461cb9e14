"""The port's native log codec (fastlivo_tpu_torch/native): built by the
port from its own copy of livo_host.cc into fastlivo_tpu_torch/_build/.
The native decoder, the port's NumPy decoder and the JAX package's decoder
give equal records (bit for bit, record for record); read_log records
which decoder ran; a malformed log raises in both decoders; and the
native voxel mask equals its NumPy version and the JAX package's native
one. Every input comes from a numpy seed.
"""

import pathlib

import numpy as np
import pytest

from fastlivo_tpu import native as jnative
from fastlivo_tpu.io import logio as JLOG
from fastlivo_tpu.io import synthetic as JSYN
from fastlivo_tpu.ops.camera import Pinhole as JPinhole
from fastlivo_tpu_torch import native
from fastlivo_tpu_torch.io import logio as TLOG
from tests.test_torch_host import same_records, to_port_records

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ could not build fastlivo_tpu_torch/native/src/livo_host.cc"
    return lib


@pytest.fixture(scope="module")
def seq_log(tmp_path_factory):
    """A 1 s log with frames; one scan carries non-finite, blind and
    far-range points."""
    seq = JSYN.generate(duration=1.0, imu_rate=100.0, scan_rate=10.0, pts_per_scan=2000, seed=4,
                        camera=JPinhole(64, 48, 40.0, 40.0, 32.0, 24.0), cam_rate=10.0)
    seq.scans[3].pts[:7] = [[np.nan, 0, 0], [0, np.inf, 0], [0.1, 0.1, 0], [200, 0, 0], [0, 0, 5],
                            [0.5, 0.0, 1.0], [-0.5, 0.0, 1.0]]
    path = str(tmp_path_factory.mktemp("logs") / "seq.flvo")
    TLOG.write_sequence(path, to_port_records(seq))
    return path, len(seq.imu) + len(seq.scans) + len(seq.frames)


@pytest.fixture(scope="module")
def log_path(seq_log):
    return seq_log[0]


def test_library_is_the_ports_own(lib):
    path = pathlib.Path(lib._name).resolve()
    assert path == native.library_path().resolve()
    assert path.parent == (REPO / "fastlivo_tpu_torch" / "_build").resolve()
    assert native.SRC.resolve() == (REPO / "fastlivo_tpu_torch" / "native" / "src" / "livo_host.cc").resolve()
    assert "fastlivo_tpu/native" not in str(path)
    assert native.get_lib() is lib  # built once, then cached


@pytest.mark.parametrize("gates", [(0.0, 1e9, 1), (0.5, 80.0, 2), (1.0, 12.0, 3)])
def test_three_decoders_give_equal_records(lib, seq_log, gates):
    log_path, n_records = seq_log
    with open(log_path, "rb") as f:
        buf = f.read()
    nat = list(TLOG._read_native(memoryview(buf), lib, *gates))
    n = same_records(nat, TLOG._read_python(memoryview(buf), *gates))
    same_records(nat, JLOG._read_python(memoryview(buf), *gates))
    jlib = jnative.get_lib()
    if jlib is not None:
        same_records(nat, JLOG._read_native(buf, jlib, *gates))
    assert n == n_records


def test_read_log_uses_native_and_records_it(lib, log_path):
    before = dict(TLOG.DECODER_RUNS)
    kw = dict(blind=0.5, max_range=80.0, point_filter_num=2)
    same_records(TLOG.read_log(log_path, **kw), JLOG.read_log(log_path, **kw))
    assert TLOG.DECODER_RUNS["native"] == before["native"] + 1
    assert TLOG.DECODER_RUNS["numpy"] == before["numpy"]


def test_read_log_falls_back_to_numpy(monkeypatch, log_path):
    monkeypatch.setattr(native, "get_lib", lambda: None)
    before = dict(TLOG.DECODER_RUNS)
    same_records(TLOG.read_log(log_path), JLOG.read_log(log_path))
    assert TLOG.DECODER_RUNS["numpy"] == before["numpy"] + 1
    assert TLOG.DECODER_RUNS["native"] == before["native"]


def test_malformed_logs_raise(lib, log_path, tmp_path):
    good = pathlib.Path(log_path).read_bytes()
    bad = {
        "magic": b"NOPE" + b"\x00" * 100,
        "version": b"FLVO" + (2).to_bytes(4, "little") + good[8:],
        "truncated": good[: len(good) - 7],
        "type": good + b"\x07" + b"\x00" * 16,
        "empty": b"",
    }
    for name, data in bad.items():
        p = tmp_path / f"{name}.flvo"
        p.write_bytes(data)
        with pytest.raises(ValueError):
            list(TLOG._read_native(memoryview(data), lib, 0.0, 1e9, 1))
        with pytest.raises(ValueError):
            list(TLOG.read_log(str(p)))
        if name != "truncated":  # the NumPy decoder only checks what it reads
            with pytest.raises((ValueError, IndexError)):
                list(TLOG._read_python(memoryview(data), 0.0, 1e9, 1))


def test_voxel_mask_native_equals_numpy(lib):
    rng = np.random.default_rng(31)
    pts = np.concatenate([
        rng.uniform(-5, 5, (5000, 3)),
        rng.uniform(-1e6, 1e6, (500, 3)),  # keys wrap to 21 bits per axis
        np.repeat(rng.uniform(-2, 2, (50, 3)), 4, axis=0),  # duplicates
    ]).astype(np.float32)
    for leaf in (0.3, 0.5, 1.0):
        m = native.voxel_mask(pts, leaf)
        assert m.dtype == bool and m.shape == (len(pts),)
        np.testing.assert_array_equal(m, native.voxel_mask_numpy(pts, leaf))
        if jnative.get_lib() is not None:
            np.testing.assert_array_equal(m, jnative.voxel_mask(pts, leaf))
        key = np.floor(pts[:5000] * np.float32(1.0 / leaf)).astype(np.int64)
        assert m[:5000].sum() <= len(np.unique(key, axis=0))
