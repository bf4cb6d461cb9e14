"""Measurement synchronization and fixed-shape window assembly (port of
fastlivo_tpu/io/sync.py).

`MeasurementSynchronizer` interleaves LiDAR sweeps, camera frames and IMU
samples into measurement groups: an image-bounded group (VIO update at the
image time, the sweep consumed up to it) when the next image falls inside
the current sweep, else a scan-end group (LIO update). `WindowBuilder`
turns groups into padded `ScanInput`s whose leaves stay NumPy; the
pipeline moves each group to its device once.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from fastlivo_tpu_torch.io.sensors import ImageFrame, ImuSample, LidarScan
from fastlivo_tpu_torch.models.imu import ImuWindow
from fastlivo_tpu_torch.models.pipeline import ScanInput
from fastlivo_tpu_torch.utils import timing


@dataclass
class MeasureGroup:
    """IMU span + optional image for one sub-measurement."""

    imu: List[ImuSample]
    img: Optional[ImageFrame] = None
    img_offset_time: float = 0.0  # s after lidar_beg_time


@dataclass
class LidarMeasureGroup:
    """One emitted measurement."""

    lidar: LidarScan
    lidar_beg_time: float
    is_lidar_end: bool
    measures: List[MeasureGroup] = field(default_factory=list)
    end_time: float = 0.0  # update timestamp (scan end or image time)


class MeasurementSynchronizer:
    """Buffers sensors and emits measurement groups."""

    def __init__(
        self,
        img_enabled: bool = False,
        img_delta_time: float = 0.0,
        imu_acc_scale: float = 1.0,
        imu_axis_remap=None,
    ):
        """img_delta_time: camera-IMU time offset added to image stamps.
        imu_acc_scale / imu_axis_remap: sensor-quirk calibration applied to
        every IMU sample."""
        self.img_enabled = img_enabled
        self.img_delta_time = img_delta_time
        self.imu_acc_scale = imu_acc_scale
        self.imu_axis_remap = (
            None if imu_axis_remap is None else np.asarray(imu_axis_remap, np.float64).reshape(3, 3)
        )
        self.lidar_buffer: deque = deque()
        self.imu_buffer: deque = deque()
        self.img_buffer: deque = deque()
        self.last_timestamp_imu = -np.inf
        self._current: Optional[LidarScan] = None
        self._current_beg = 0.0

    @timing.traced("io.push")
    def push_lidar(self, scan: LidarScan):
        if len(scan.pts) > 1:
            self.lidar_buffer.append(scan)

    @timing.traced("io.push")
    def push_imu(self, sample: ImuSample):
        # A timestamp loopback (log restart) drops the buffered samples.
        if sample.stamp < self.last_timestamp_imu:
            self.imu_buffer.clear()
        self.last_timestamp_imu = sample.stamp
        if self.imu_acc_scale != 1.0 or self.imu_axis_remap is not None:
            gyr, acc = sample.gyr, sample.acc * self.imu_acc_scale
            if self.imu_axis_remap is not None:
                gyr = self.imu_axis_remap @ gyr
                acc = self.imu_axis_remap @ acc
            sample = ImuSample(stamp=sample.stamp, gyr=gyr, acc=acc)
        self.imu_buffer.append(sample)

    @timing.traced("io.push")
    def push_image(self, frame: ImageFrame):
        if self.img_enabled:
            if self.img_delta_time:
                frame = ImageFrame(stamp=frame.stamp + self.img_delta_time, img=frame.img)
            self.img_buffer.append(frame)

    def _pop_imu_until(self, t: float) -> List[ImuSample]:
        out = []
        while self.imu_buffer and self.imu_buffer[0].stamp <= t:
            out.append(self.imu_buffer.popleft())
        return out

    @timing.traced("io.next_group")
    def next_group(self) -> Optional[LidarMeasureGroup]:
        """Emit the next measurement group, or None if more data is needed."""
        if self._current is None:
            if not self.lidar_buffer:
                return None
            self._current = self.lidar_buffer.popleft().sort_by_time()
            self._current_beg = self._current.stamp

        scan = self._current
        lidar_end_time = scan.end_time
        img_ready = (
            self.img_enabled and self.img_buffer and self.img_buffer[0].stamp <= lidar_end_time
        )

        if not img_ready:
            # Scan-end (LIO) group; needs IMU coverage past the scan end.
            if self.last_timestamp_imu < lidar_end_time + 0.02:
                return None
            imu = self._pop_imu_until(lidar_end_time)
            group = LidarMeasureGroup(
                lidar=scan,
                lidar_beg_time=self._current_beg,
                is_lidar_end=True,
                measures=[MeasureGroup(imu=imu)],
                end_time=lidar_end_time,
            )
            self._current = None
            return group

        frame = self.img_buffer[0]
        if self.last_timestamp_imu < frame.stamp:
            return None
        self.img_buffer.popleft()
        imu = self._pop_imu_until(frame.stamp)
        return LidarMeasureGroup(
            lidar=scan,
            lidar_beg_time=self._current_beg,
            is_lidar_end=False,
            measures=[
                MeasureGroup(imu=imu, img=frame, img_offset_time=frame.stamp - self._current_beg)
            ],
            end_time=frame.stamp,
        )


class WindowBuilder:
    """Converts groups to fixed-shape inputs, carrying the propagation
    cursor across groups: the last IMU sample (prepended to each window),
    the last end time (propagation start) and the partial-scan point
    cursor of image-bounded groups."""

    def __init__(self, n_pts: int, imu_window: int):
        self.n_pts = n_pts
        self.imu_window = imu_window
        self.last_imu: Optional[ImuSample] = None
        self.last_end_time: Optional[float] = None
        self._scan_cursor = 0

    @timing.traced("io.build")
    def build(self, group: LidarMeasureGroup):
        """Returns (ScanInput with NumPy leaves, t_abs_end). Points included:
        for scan-end groups the rest of the sweep, for image-bounded groups
        the points up to the image time (the cursor advances). Counts the
        group's points (`io.build.points`) and those the budget's stride
        leaves out (`io.build.points_dropped`)."""
        meas = group.measures[-1]
        if self.last_end_time is None:
            self.last_end_time = group.lidar_beg_time
        t0 = self.last_end_time
        t_end = group.end_time

        # IMU window: carried sample + group samples, relative to t0.
        samples = ([self.last_imu] if self.last_imu is not None else []) + meas.imu
        samples = [s for s in samples if s is not None]
        m = self.imu_window
        stamps = np.zeros(m, np.float32)
        gyr = np.zeros((m, 3), np.float32)
        acc = np.tile(np.float32([0, 0, 9.81]), (m, 1))
        mask = np.zeros(m, bool)
        k = min(len(samples), m)
        for i, s in enumerate(samples[-m:][:k]):
            stamps[i] = max(s.stamp - t0, 0.0)
            gyr[i] = s.gyr
            acc[i] = s.acc
            mask[i] = True
        if k:
            stamps[k:] = stamps[k - 1]
            gyr[k:] = 0.0
            acc[k:] = 0.0
        stamps = np.maximum.accumulate(stamps)

        # Points: slice the sweep by the cursor / end time.
        scan = group.lidar
        t_abs = scan.stamp + scan.t_offs_ms.astype(np.float64) / 1e3
        if group.is_lidar_end:
            sel = slice(self._scan_cursor, len(scan.pts))
            self._scan_cursor = 0
        else:
            upto = int(np.searchsorted(t_abs, t_end, side="right"))
            sel = slice(self._scan_cursor, upto)
            self._scan_cursor = upto

        pts = scan.pts[sel]
        t_rel = (t_abs[sel] - t0).astype(np.float32)

        n = self.n_pts
        timing.count("io.build.points", len(pts))
        timing.count("io.build.points_dropped", max(len(pts) - n, 0))
        if len(pts) > n:
            # Budget overflow: a uniform stride keeps temporal coverage.
            idx = np.linspace(0, len(pts) - 1, n).astype(np.int64)
            pts, t_rel = pts[idx], t_rel[idx]
        out_pts = np.zeros((n, 3), np.float32)
        out_t = np.zeros(n, np.float32)
        out_mask = np.zeros(n, bool)
        out_pts[: len(pts)] = pts
        out_t[: len(pts)] = np.maximum(t_rel, 0.0)
        out_mask[: len(pts)] = True

        if meas.imu:
            self.last_imu = meas.imu[-1]
        self.last_end_time = t_end

        scan_input = ScanInput(
            pts=out_pts,
            t_offs=out_t,
            mask=out_mask,
            imu=ImuWindow(stamps=stamps, gyr=gyr, acc=acc, mask=mask),
            t_end=np.float32(max(t_end - t0, 0.0)),
            acc_scale=np.float32(1.0),  # the caller sets it after initialization
        )
        return scan_input, t_end
