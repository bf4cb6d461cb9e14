"""FLVO measurement logs: the serialized, replayable sensor stream (port of
fastlivo_tpu/io/logio.py). Writing is Python; reading uses the native C++
indexer and decoder (`fastlivo_tpu_torch.native`) when its library builds
and the NumPy decoder otherwise, with the same records either way.
`DECODER_RUNS` counts the streams each decoder served.

Format: b"FLVO", u32 version, then records in time order, each a type byte
and a little-endian f64 stamp:
  0 IMU:    f64 gyr[3], f64 acc[3]
  1 LiDAR:  u32 n, then n x f32 (x, y, z, t_offs_ms, intensity)
  2 image:  u32 h, u32 w, then h*w u8 grayscale
"""

from __future__ import annotations

import ctypes
import mmap
import struct
from typing import Iterator, List, Union

import numpy as np

from fastlivo_tpu_torch import native
from fastlivo_tpu_torch.io.sensors import ImageFrame, ImuSample, LidarScan

MAGIC = b"FLVO"
VERSION = 1

# read_log streams served by each decoder
DECODER_RUNS = {"native": 0, "numpy": 0}


class LogWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(MAGIC + struct.pack("<I", VERSION))

    def write_imu(self, s: ImuSample):
        self._f.write(b"\x00" + struct.pack("<d", s.stamp))
        self._f.write(np.asarray(s.gyr, "<f8").tobytes())
        self._f.write(np.asarray(s.acc, "<f8").tobytes())

    def write_lidar(self, s: LidarScan):
        n = len(s.pts)
        self._f.write(b"\x01" + struct.pack("<dI", s.stamp, n))
        rec = np.zeros((n, 5), "<f4")
        rec[:, :3] = s.pts
        rec[:, 3] = s.t_offs_ms
        if s.intensity is not None:
            rec[:, 4] = s.intensity
        self._f.write(rec.tobytes())

    def write_image(self, s: ImageFrame):
        img = np.asarray(s.img)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        h, w = img.shape[:2]
        self._f.write(b"\x02" + struct.pack("<dII", s.stamp, h, w))
        self._f.write(np.ascontiguousarray(img[..., 0] if img.ndim == 3 else img).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_log(
    path: str,
    blind: float = 0.0,
    max_range: float = 1e9,
    point_filter_num: int = 1,
) -> Iterator[Union[ImuSample, LidarScan, ImageFrame]]:
    """Stream records in file order, LiDAR filtered and decimated at decode
    time (every `point_filter_num`-th point, range in (blind, max_range),
    finite). The log is memory-mapped and decoded from zero-copy views, by
    the native decoder when its library builds."""
    with open(path, "rb") as f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file or unmappable fs
            mm = f.read()
        try:
            buf = memoryview(mm)
            lib = native.get_lib()
            if lib is not None:
                DECODER_RUNS["native"] += 1
                yield from _read_native(buf, lib, blind, max_range, point_filter_num)
            else:
                DECODER_RUNS["numpy"] += 1
                yield from _read_python(buf, blind, max_range, point_filter_num)
        finally:
            try:
                buf.release()
                if isinstance(mm, mmap.mmap):
                    mm.close()
            except BufferError:
                # A propagating exception's traceback can keep decoder
                # views alive; the mapping is then released at GC instead.
                pass


def _read_native(buf, lib, blind, max_range, filter_num):
    # Zero-copy pointer into the mmapped (or bytes) buffer for the C ABI.
    view = np.frombuffer(buf, np.uint8)
    ptr = view.ctypes.data_as(ctypes.POINTER(ctypes.c_char))
    n = lib.flvo_index(ptr, len(view), None, 0)
    if n < 0:
        raise ValueError("malformed FLVO log")
    idx = (native.RecordIndex * n)()
    lib.flvo_index(ptr, len(view), idx, n)
    for r in idx:
        if r.type == 0:
            gyr = np.zeros(3)
            acc = np.zeros(3)
            lib.flvo_decode_imu(
                ptr, r.offset,
                gyr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                acc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            )
            yield ImuSample(stamp=r.stamp, gyr=gyr, acc=acc)
        elif r.type == 1:
            cap = int(r.count)
            xyz = np.zeros((cap, 3), np.float32)
            t_ms = np.zeros(cap, np.float32)
            inten = np.zeros(cap, np.float32)
            kept = lib.flvo_decode_lidar(
                ptr, r.offset, blind, max_range, filter_num,
                xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                t_ms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                inten.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            yield LidarScan(
                stamp=r.stamp,
                pts=xyz[:kept].copy(),
                t_offs_ms=t_ms[:kept].copy(),
                intensity=inten[:kept].copy(),
            ).sort_by_time()
        else:
            h = r.count >> 16
            w = r.count & 0xFFFF
            img = np.zeros(h * w, np.uint8)
            lib.flvo_decode_image(ptr, r.offset, img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            yield ImageFrame(stamp=r.stamp, img=img.reshape(h, w).astype(np.float32))


def _read_python(buf, blind, max_range, filter_num):
    if len(buf) < 8 or buf[:4] != MAGIC or struct.unpack("<I", buf[4:8])[0] != VERSION:
        raise ValueError("malformed FLVO log")
    off = 8
    n_total = len(buf)
    while off < n_total:
        rtype = buf[off]
        off += 1
        stamp = struct.unpack_from("<d", buf, off)[0]
        if rtype == 0:
            vals = np.frombuffer(buf, "<f8", 6, off + 8)
            yield ImuSample(stamp=stamp, gyr=vals[:3].copy(), acc=vals[3:].copy())
            off += 8 + 48
        elif rtype == 1:
            n = struct.unpack_from("<I", buf, off + 8)[0]
            rec = np.frombuffer(buf, "<f4", n * 5, off + 12).reshape(n, 5)
            keep = np.ones(n, bool)
            if filter_num > 1:
                keep[:] = False
                keep[::filter_num] = True
            r2 = rec[:, 0] ** 2 + rec[:, 1] ** 2
            keep &= (r2 > blind**2) & (r2 < max_range**2) & np.isfinite(rec[:, :3]).all(1)
            yield LidarScan(
                stamp=stamp,
                pts=rec[keep, :3].copy(),
                t_offs_ms=rec[keep, 3].copy(),
                intensity=rec[keep, 4].copy(),
            ).sort_by_time()
            off += 12 + n * 20
        elif rtype == 2:
            h, w = struct.unpack_from("<II", buf, off + 8)
            img = np.frombuffer(buf, np.uint8, h * w, off + 16).reshape(h, w)
            yield ImageFrame(stamp=stamp, img=img.astype(np.float32))
            off += 16 + h * w
        else:
            raise ValueError(f"unknown record type {rtype}")


def write_sequence(path: str, seq) -> None:
    """Serialize a SyntheticSequence (or any object with .imu/.scans/.frames)
    into one time-ordered FLVO log."""
    events: List = [("imu", s.stamp, s) for s in seq.imu]
    events += [("lidar", s.stamp, s) for s in seq.scans]
    if getattr(seq, "frames", None):
        events += [("img", s.stamp, s) for s in seq.frames]
    events.sort(key=lambda e: e[1])
    with LogWriter(path) as w:
        for kind, _, s in events:
            if kind == "imu":
                w.write_imu(s)
            elif kind == "lidar":
                w.write_lidar(s)
            else:
                w.write_image(s)
