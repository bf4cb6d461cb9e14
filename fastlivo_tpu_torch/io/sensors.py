"""Host-side sensor record types (NumPy; a copy of fastlivo_tpu/io/sensors.py).

Sensors arrive as plain timestamped records — replayed from measurement
logs or generated synthetically — and flow through
`io.sync.MeasurementSynchronizer`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class LidarScan:
    """One decoded sweep. Point times are *milliseconds* relative to
    `stamp`."""

    stamp: float  # scan begin time (s, absolute)
    pts: np.ndarray  # (N, 3) float32, sensor frame
    t_offs_ms: np.ndarray  # (N,) float32, ms since `stamp`
    intensity: Optional[np.ndarray] = None  # (N,) float32

    @property
    def end_time(self) -> float:
        return self.stamp + float(self.t_offs_ms[-1]) / 1e3 if len(self.t_offs_ms) else self.stamp

    def sort_by_time(self) -> "LidarScan":
        order = np.argsort(self.t_offs_ms, kind="stable")
        return LidarScan(
            stamp=self.stamp,
            pts=self.pts[order],
            t_offs_ms=self.t_offs_ms[order],
            intensity=None if self.intensity is None else self.intensity[order],
        )


@dataclass
class ImuSample:
    stamp: float  # s, absolute
    gyr: np.ndarray  # (3,) rad/s
    acc: np.ndarray  # (3,) m/s^2


@dataclass
class ImageFrame:
    stamp: float  # s, absolute (already delta_time-shifted by the decoder)
    img: np.ndarray  # (H, W) float32 grayscale or (H, W, 3) uint8
