"""Pure-python rosbag1 reader + rosbag -> FLVO converter (port of
fastlivo_tpu/io/rosbag.py, writing through the port's own logio).

The reference is driven by `rosbag play` feeding its ROS callbacks
(reference: src/laser_mapping.cpp:809-943; README.md:131-154 lists the
public dataset bags). This framework is bag-free at runtime — this module
converts a recorded `.bag` (rosbag V2.0 container) into an FLVO
measurement log once, offline, with no ROS installation:

    python -m fastlivo_tpu_torch.io.rosbag in.bag out.flvo \
        --lidar-topic /livox/lidar --imu-topic /livox/imu \
        --img-topic /camera/image --lidar-type 1

Supported message types (hand-written deserializers for the fixed ROS1
serialization format — little-endian, 4-byte length-prefixed strings and
arrays):

- sensor_msgs/Imu
- sensor_msgs/PointCloud2          (Velodyne / Ouster / XT32 clouds)
- sensor_msgs/Image                (mono8 / bgr8 / rgb8)
- sensor_msgs/CompressedImage      (decoded via PIL; ImportError without it)
- livox_ros_driver/CustomMsg       (Avia; reference avia_handler input,
                                    preprocess.cpp:249-352)

Chunk compressions: none and bz2 (stdlib); lz4 through the lz4 package
when it exists, else the vendored pure-Python codec (`io.lz4f`).
"""

from __future__ import annotations

import bz2
import io as _io
import struct
import sys
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

OP_MSG = 0x02
OP_BAGHDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNKINFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    """A bag record header: sequence of len-prefixed `name=value` fields."""
    fields = {}
    off = 0
    n = len(buf)
    while off < n:
        (ln,) = _U32.unpack_from(buf, off)
        off += 4
        item = buf[off : off + ln]
        off += ln
        k, _, v = item.partition(b"=")
        fields[k] = v
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    raw = f.read(4)
    if len(raw) < 4:
        return None
    (hlen,) = _U32.unpack(raw)
    header = _parse_header(f.read(hlen))
    (dlen,) = _U32.unpack(f.read(4))
    data = f.read(dlen)
    return header, data


@dataclass
class Connection:
    topic: str
    msg_type: str


def _iter_bag_records(path: str) -> Iterator[Tuple[int, Dict[bytes, bytes], bytes]]:
    """Yield (op, header, data) for every record, descending into chunks."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"not a rosbag V2.0 file: {magic!r}")
        while True:
            rec = _read_record(f)
            if rec is None:
                return
            header, data = rec
            op = header[b"op"][0]
            if op == OP_CHUNK:
                comp = header.get(b"compression", b"none")
                if comp == b"bz2":
                    data = bz2.decompress(data)
                elif comp == b"lz4":
                    try:
                        import lz4.frame  # type: ignore

                        data = lz4.frame.decompress(data)
                    except ImportError:
                        # vendored pure-python frame decoder (no external
                        # lz4 package in this environment)
                        from fastlivo_tpu_torch.io import lz4f

                        data = lz4f.decompress(data)
                sub = _io.BytesIO(data)
                while True:
                    srec = _read_record(sub)
                    if srec is None:
                        break
                    sh, sd = srec
                    yield sh[b"op"][0], sh, sd
            elif op in (OP_MSG, OP_CONNECTION):
                # unchunked (uncommon but legal)
                yield op, header, data


def read_bag(
    path: str, topics: Optional[set] = None
) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield (topic, msg_type, bag_time_s, raw_message_bytes) in bag order."""
    conns: Dict[int, Connection] = {}
    for op, header, data in _iter_bag_records(path):
        if op == OP_CONNECTION:
            cid = _U32.unpack(header[b"conn"])[0]
            ch = _parse_header(data)
            conns[cid] = Connection(
                topic=header[b"topic"].decode(),
                msg_type=ch.get(b"type", b"?").decode(),
            )
        elif op == OP_MSG:
            cid = _U32.unpack(header[b"conn"])[0]
            (t_ns,) = _U64.unpack(header[b"time"])
            secs, nsecs = t_ns & 0xFFFFFFFF, t_ns >> 32
            t = secs + nsecs * 1e-9
            c = conns.get(cid)
            if c is None:
                continue
            if topics is not None and c.topic not in topics:
                continue
            yield c.topic, c.msg_type, t, data


# --------------------------------------------------------------------------
# ROS1 message deserializers (little-endian wire format)
# --------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = _U32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def u64(self):
        (v,) = _U64.unpack_from(self.buf, self.off)
        self.off += 8
        return v

    def f64(self):
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self):
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s.decode(errors="replace")

    def skip(self, n):
        self.off += n

    def bytes_(self, n):
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b

    def stamp(self):
        secs = self.u32()
        nsecs = self.u32()
        return secs + nsecs * 1e-9


def _header(c: _Cursor) -> float:
    c.u32()  # seq
    t = c.stamp()
    c.string()  # frame_id
    return t


def parse_imu(raw: bytes):
    """sensor_msgs/Imu -> (stamp, gyr (3,), acc (3,))."""
    c = _Cursor(raw)
    t = _header(c)
    c.skip(4 * 8 + 9 * 8)  # orientation quat + covariance
    gyr = np.frombuffer(c.bytes_(24), "<f8").astype(np.float64)
    c.skip(9 * 8)
    acc = np.frombuffer(c.bytes_(24), "<f8").astype(np.float64)
    c.skip(9 * 8)
    return t, gyr, acc


_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def parse_pointcloud2(raw: bytes):
    """sensor_msgs/PointCloud2 -> (stamp, fields dict of column arrays)."""
    c = _Cursor(raw)
    t = _header(c)
    height = c.u32()
    width = c.u32()
    n_fields = c.u32()
    fields = []
    for _ in range(n_fields):
        name = c.string()
        offset = c.u32()
        datatype = c.u8()
        count = c.u32()
        fields.append((name, offset, datatype, count))
    is_bigendian = c.u8()
    point_step = c.u32()
    c.u32()  # row_step
    n_data = c.u32()
    data = np.frombuffer(c.bytes_(n_data), np.uint8)
    # is_dense: 1 byte trailing; ignore
    n_pts = height * width
    data = data[: n_pts * point_step].reshape(n_pts, point_step)
    order = ">" if is_bigendian else "<"
    out = {}
    for name, offset, datatype, count in fields:
        base = np.dtype(_PF_DTYPES[datatype]).newbyteorder(order)
        w = base.itemsize
        col = (
            data[:, offset : offset + w * count]
            .copy()
            .view(base)
        )
        out[name] = col[:, 0] if count == 1 else col
    return t, out


def parse_livox_custommsg(raw: bytes):
    """livox_ros_driver/CustomMsg -> (stamp, avia fields dict).

    Layout: Header, timebase u64, point_num u32, lidar_id u8, rsvd u8[3],
    points[] of CustomPoint{offset_time u32, x f32, y f32, z f32,
    reflectivity u8, tag u8, line u8}.
    """
    c = _Cursor(raw)
    t = _header(c)
    timebase = c.u64()  # ns; offset_time is relative to THIS, and some
    # livox drivers leave header.stamp unset — fall back to the timebase
    # then (the reference always trusts header.stamp, laser_mapping.cpp
    # livox_pcl_cbk; with its datasets the two coincide).
    if t == 0.0 and timebase:
        t = timebase * 1e-9
    n = c.u32()
    c.skip(4)  # lidar_id + rsvd[3]
    c.u32()  # points array length (== n)
    rec = np.dtype(
        [
            ("offset_time", "<u4"),
            ("x", "<f4"),
            ("y", "<f4"),
            ("z", "<f4"),
            ("reflectivity", "u1"),
            ("tag", "u1"),
            ("line", "u1"),
        ]
    )
    arr = np.frombuffer(c.bytes_(rec.itemsize * n), rec)
    return t, {
        "x": arr["x"].astype(np.float32),
        "y": arr["y"].astype(np.float32),
        "z": arr["z"].astype(np.float32),
        "offset_time": arr["offset_time"].astype(np.int64),
        "reflectivity": arr["reflectivity"].astype(np.float32),
        "tag": arr["tag"].copy(),
        "line": arr["line"].copy(),
    }


def parse_image(raw: bytes):
    """sensor_msgs/Image -> (stamp, HxW float32 grayscale in [0,255])."""
    c = _Cursor(raw)
    t = _header(c)
    h = c.u32()
    w = c.u32()
    enc = c.string()
    c.u8()  # is_bigendian
    step = c.u32()
    n = c.u32()
    data = np.frombuffer(c.bytes_(n), np.uint8)
    if enc in ("mono8", "8UC1"):
        img = data.reshape(h, step)[:, :w].astype(np.float32)
    elif enc in ("bgr8", "rgb8", "8UC3"):
        rgb = data.reshape(h, step)[:, : w * 3].reshape(h, w, 3).astype(np.float32)
        if enc == "bgr8":
            rgb = rgb[..., ::-1]
        img = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    else:
        raise ValueError(f"unsupported image encoding {enc!r}")
    return t, img


def parse_compressed_image(raw: bytes):
    """sensor_msgs/CompressedImage (jpeg/png via PIL)."""
    c = _Cursor(raw)
    t = _header(c)
    c.string()  # format
    n = c.u32()
    payload = c.bytes_(n)
    from PIL import Image as PILImage  # noqa: PLC0415

    img = np.asarray(PILImage.open(_io.BytesIO(payload)).convert("L"), np.float32)
    return t, img


# --------------------------------------------------------------------------
# Converter
# --------------------------------------------------------------------------


def bag_to_flvo(
    bag_path: str,
    out_path: str,
    lidar_topic: str,
    imu_topic: str,
    img_topic: Optional[str] = None,
    lidar_type: int = 1,
    params=None,
    progress: bool = False,
) -> dict:
    """Convert a rosbag into an FLVO measurement log.

    lidar_type follows the reference's LID_TYPE enum (preprocess.h:14):
    1=AVIA (livox CustomMsg), 2=Velodyne, 3=Ouster64, 4=XT32 (PointCloud2).
    Returns counters {imu, scans, images}.
    """
    from fastlivo_tpu_torch.io import preprocess
    from fastlivo_tpu_torch.io.logio import LogWriter
    from fastlivo_tpu_torch.io.sensors import ImageFrame, ImuSample
    from fastlivo_tpu_torch.utils.config import LidarParams

    params = params or LidarParams()
    topics = {lidar_topic, imu_topic} | ({img_topic} if img_topic else set())
    counts = {"imu": 0, "scans": 0, "images": 0}
    with LogWriter(out_path) as w:
        for topic, msg_type, t_bag, raw in read_bag(bag_path, topics):
            if topic == imu_topic:
                t, gyr, acc = parse_imu(raw)
                w.write_imu(ImuSample(stamp=t or t_bag, gyr=gyr, acc=acc))
                counts["imu"] += 1
            elif topic == lidar_topic:
                if msg_type.endswith("CustomMsg"):
                    t, fields = parse_livox_custommsg(raw)
                else:
                    t, fields = parse_pointcloud2(raw)
                scan = preprocess.decode(lidar_type, t or t_bag, fields, params)
                if len(scan.pts):
                    w.write_lidar(scan)
                    counts["scans"] += 1
            elif img_topic and topic == img_topic:
                if "Compressed" in msg_type:
                    t, img = parse_compressed_image(raw)
                else:
                    t, img = parse_image(raw)
                w.write_image(ImageFrame(stamp=t or t_bag, img=img))
                counts["images"] += 1
            if progress and sum(counts.values()) % 2000 == 0:
                print(f"  {counts}", file=sys.stderr)
    return counts


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("bag")
    p.add_argument("out")
    p.add_argument("--lidar-topic", required=True)
    p.add_argument("--imu-topic", required=True)
    p.add_argument("--img-topic", default=None)
    p.add_argument("--lidar-type", type=int, default=1)
    args = p.parse_args(argv)
    counts = bag_to_flvo(
        args.bag, args.out, args.lidar_topic, args.imu_topic,
        args.img_topic, args.lidar_type, progress=True,
    )
    print(counts)


if __name__ == "__main__":
    main()
