"""Measurement groups from a record stream, their IMU windows and point
slices, and the static initialization.

A sweep is held until the IMU has passed its end by 20 ms; a camera frame
(its stamp plus the configuration's `delta_time`) that falls before the
held sweep's end makes an image-bounded group first, ended at the frame's
time, then the sweep makes a scan-end group. A group's IMU window is the
last sample of the group before (when there is one) and the samples up to
the group's end not yet taken. Its points are those of the sweep up to the
frame's time for an image-bounded group, and the rest of the sweep for a
scan-end group; a slice over the point budget is thinned to the budget by
a uniform stride over its points. Times are relative to the previous
group's end (the first group: its sweep's start).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

GRAVITY = 9.81


@dataclass
class Group:
    lidar_end: bool
    t_abs: float  # the group's end time
    t_end: float  # relative to t0
    imu_t: np.ndarray  # (k,) relative, nondecreasing, >= 0
    gyr: np.ndarray  # (k, 3)
    acc: np.ndarray  # (k, 3), as the synchronizer scales it
    pts: np.ndarray  # (n, 3) float32, LiDAR frame
    pt_t: np.ndarray  # (n,) relative
    img: Optional[np.ndarray] = None


def groups(records, p) -> Iterator[Group]:
    """The groups of a record stream (`livobench.pool.Record`s: kind "imu",
    "lidar" or "img"), in order, for the configuration `p` (params.read)."""
    n_budget = 2 * p.lio.max_points
    m = p.imu.imu_int_frame
    remap = np.asarray(p.imu.axis_remap, np.float64).reshape(3, 3)
    sweeps: List = []
    frames: List = []
    imu: List = []  # (stamp, gyr, acc) not yet taken
    last_imu_t = -np.inf
    carry = None  # the last sample of the previous group
    t_prev = None
    cursor = 0
    held = None  # (stamp, pts, t_abs) of the sweep being split

    for r in records:
        if r.kind == "imu":
            last_imu_t = r.stamp
            gyr = remap @ np.asarray(r.data[0], np.float64)
            acc = remap @ (np.asarray(r.data[1], np.float64) * p.imu.acc_scale_factor)
            imu.append((r.stamp, gyr, acc))
        elif r.kind == "lidar":
            if len(r.data[0]) > 1:
                order = np.argsort(r.data[1], kind="stable")
                sweeps.append((r.stamp, r.data[0][order], r.data[1][order]))
        elif p.vio.img_enable:
            frames.append((r.stamp + p.vio.delta_time, r.data[0]))
        while True:
            if held is None:
                if not sweeps:
                    break
                stamp, pts, t_ms = sweeps.pop(0)
                held = (stamp, pts, stamp + t_ms.astype(np.float64) / 1e3, stamp + float(t_ms[-1]) / 1e3)
            stamp, pts, t_abs, end = held
            frame = frames[0] if frames and frames[0][0] <= end else None
            t_grp = end if frame is None else frame[0]
            if last_imu_t < (t_grp + 0.02 if frame is None else t_grp):
                break
            if frame is not None:
                frames.pop(0)
            taken = [s for s in imu if s[0] <= t_grp]
            imu = imu[len(taken):]
            if t_prev is None:
                t_prev = stamp
            window = ([carry] if carry is not None else []) + taken
            window = window[-m:]
            if frame is None:
                sel = slice(cursor, len(pts))
                cursor = 0
            else:
                upto = int(np.searchsorted(t_abs, t_grp, side="right"))
                sel = slice(cursor, upto)
                cursor = upto
            g_pts, g_t = pts[sel], t_abs[sel] - t_prev
            if len(g_pts) > n_budget:
                idx = np.linspace(0, len(g_pts) - 1, n_budget).astype(np.int64)
                g_pts, g_t = g_pts[idx], g_t[idx]
            imu_t = np.maximum.accumulate(np.maximum([s[0] - t_prev for s in window], 0.0)) \
                if window else np.zeros(0)
            yield Group(
                lidar_end=frame is None,
                t_abs=t_grp,
                t_end=max(t_grp - t_prev, 0.0),
                imu_t=np.asarray(imu_t, np.float64),
                gyr=np.array([s[1] for s in window]).reshape(-1, 3),
                acc=np.array([s[2] for s in window]).reshape(-1, 3),
                pts=g_pts,
                pt_t=np.maximum(g_t, 0.0),
                img=None if frame is None else frame[1],
            )
            if taken:
                carry = taken[-1]
            t_prev = t_grp
            if frame is None:
                held = None


class StaticInit:
    """Zero-velocity initialization: from the first window whose
    accelerometer norms spread (standard deviation) less than the
    threshold, every window's samples are gathered until there are
    `count`; then gravity is minus their mean specific force scaled to
    9.81 m/s^2, the gyro bias their mean rate, the accelerometer scale
    9.81 over the mean's norm, and the pose the identity."""

    def __init__(self, count: int, thresh: float):
        self.count, self.thresh = count, thresh
        self.gyr, self.acc = [], []
        self.done = False

    def push(self, g: Group) -> bool:
        if not self.done and len(g.acc):
            if self.acc or np.std(np.linalg.norm(g.acc, axis=-1)) < self.thresh:
                self.gyr.append(g.gyr)
                self.acc.append(g.acc)
            if sum(len(a) for a in self.acc) >= self.count:
                self.mean_acc = np.concatenate(self.acc).mean(0)
                self.mean_gyr = np.concatenate(self.gyr).mean(0)
                self.done = True
        return self.done

    @property
    def acc_scale(self) -> float:
        return GRAVITY / float(np.linalg.norm(self.mean_acc))

    @property
    def gravity(self) -> np.ndarray:
        return -self.mean_acc / np.linalg.norm(self.mean_acc) * GRAVITY
