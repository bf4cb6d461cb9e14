"""Synthetic LIVO sequences (port of the room generator of
fastlivo_tpu/io/synthetic.py; the street generators and `generate_gnss`
are later slices).

An analytic trajectory (position and yaw) is sampled to produce IMU at
`imu_rate` with exact body rates and specific force, LiDAR sweeps at
`scan_rate` with true motion distortion (every point is seen from the
sensor pose at its own time), camera frames of the textured room rendered
by `io.render.render_room`, and ground-truth poses. The NumPy draws are the
JAX package's, so one seed gives the same IMU and sweeps in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.io.render import render_room
from fastlivo_tpu_torch.io.sensors import ImageFrame, ImuSample, LidarScan
from fastlivo_tpu_torch.state import GRAVITY_MS2


@dataclass
class Trajectory:
    """Analytic trajectory: pos(t) and yaw(t), derivatives by central
    differences (h = 1e-4 keeps f64 accuracy)."""

    pos_fn: Callable[[float], np.ndarray]
    yaw_fn: Callable[[float], float]

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        c, s = np.cos(self.yaw_fn(t)), np.sin(self.yaw_fn(t))
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return rot, self.pos_fn(t)

    def vel(self, t: float, h: float = 1e-4) -> np.ndarray:
        return (self.pos_fn(t + h) - self.pos_fn(t - h)) / (2 * h)

    def acc_world(self, t: float, h: float = 1e-4) -> np.ndarray:
        return (self.pos_fn(t + h) - 2 * self.pos_fn(t) + self.pos_fn(t - h)) / h**2

    def yaw_rate(self, t: float, h: float = 1e-4) -> float:
        return (self.yaw_fn(t + h) - self.yaw_fn(t - h)) / (2 * h)


def default_trajectory(
    speed: float = 1.0, yaw_rate: float = 0.3, rest_time: float = 0.5
) -> Trajectory:
    """Gentle arc with a mild vertical oscillation. The rig holds still for
    `rest_time` (clean samples for the static initialization), then time
    is warped through tau(s) = s^2 / (s + 0.5) so motion ramps from rest."""

    def warp(t):
        s = max(t - rest_time, 0.0)
        return s * s / (s + 0.5)

    def pos(t):
        tau = warp(t)
        return np.array(
            [
                2.0 * np.sin(0.5 * speed * tau),
                2.0 * (1 - np.cos(0.5 * speed * tau)),
                0.1 * np.sin(1.3 * tau),
            ]
        )

    return Trajectory(pos_fn=pos, yaw_fn=lambda t: yaw_rate * warp(t))


def _default_boxes(rng: np.random.Generator, half: float) -> List[Tuple[np.ndarray, np.ndarray]]:
    boxes = []
    for _ in range(6):
        c = rng.uniform(-half * 0.6, half * 0.6, 3)
        c[2] = rng.uniform(0.0, 2.0)
        sz = rng.uniform(0.4, 1.5, 3)
        boxes.append((c, sz))
    return boxes


def _sample_surfaces(rng, n, half, boxes, floor_z=-1.5):
    per = n // (5 + len(boxes))
    pts = []
    u = rng.uniform(-half, half, (per, 2))
    pts.append(np.stack([u[:, 0], u[:, 1], np.full(per, floor_z)], 1))
    for axis, val in ((0, -half), (0, half), (1, -half), (1, half)):
        u = rng.uniform(-half, half, (per, 2))
        w = np.zeros((per, 3))
        w[:, axis] = val
        w[:, 1 - axis] = u[:, 0]
        w[:, 2] = u[:, 1] * 0.4 + 2.0
        pts.append(w)
    for c, sz in boxes:
        u = rng.uniform(-1, 1, (per, 3))
        face = rng.integers(0, 3, per)
        snap = np.sign(u[np.arange(per), face])
        u[np.arange(per), face] = snap
        pts.append(c + u * sz)
    out = np.concatenate(pts).astype(np.float32)
    if len(out) < n:  # integer-division remainder: top up from the floor
        extra = rng.uniform(-half, half, (n - len(out), 2))
        out = np.concatenate(
            [out, np.stack([extra[:, 0], extra[:, 1], np.full(n - len(out), floor_z)], 1).astype(np.float32)]
        )
    return out[:n]


@dataclass
class SyntheticSequence:
    imu: List[ImuSample]
    scans: List[LidarScan]
    gt_stamps: np.ndarray  # (K,) scan-end times
    gt_rot: np.ndarray  # (K, 3, 3)
    gt_pos: np.ndarray  # (K, 3)
    world: np.ndarray  # reference world points
    frames: List[ImageFrame] = None  # rendered camera frames (LIVO mode)


# Camera mounted forward: x_cam = right (-y_imu), y_cam = down (-z_imu),
# z_cam = forward (+x_imu). R_ic columns are camera axes in IMU coords.
R_IC_FORWARD = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def generate(
    duration: float = 10.0,
    imu_rate: float = 200.0,
    scan_rate: float = 10.0,
    pts_per_scan: int = 20000,
    seed: int = 0,
    time_buckets: int = 32,
    imu_noise_gyr: float = 0.0,
    imu_noise_acc: float = 0.0,
    gyro_bias: np.ndarray | None = None,
    accel_bias: np.ndarray | None = None,
    trajectory: Trajectory | None = None,
    world_half: float = 10.0,
    n_boxes: int = 6,
    camera=None,  # ops.camera.Pinhole -> also render frames
    cam_rate: float = 10.0,
    cam_offset: float = 0.05,  # interleave frames mid-sweep
    rot_ic: np.ndarray | None = None,
    device=None,
) -> SyntheticSequence:
    """Generate a full synthetic LIVO sequence. Frames (when `camera` is
    given) are rendered on `device`: None means the GPU."""
    rng = np.random.default_rng(seed)
    traj = trajectory or default_trajectory()
    boxes = _default_boxes(rng, world_half)[:n_boxes]
    bg = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    ba = np.zeros(3) if accel_bias is None else np.asarray(accel_bias)
    grav = np.array([0.0, 0.0, -GRAVITY_MS2])

    # IMU: gyro = body rate, acc = R^T (a_w - g) + bias + noise.
    imu = []
    for t in np.arange(0.0, duration + 1e-9, 1.0 / imu_rate):
        rot, _ = traj.pose(t)
        w_body = np.array([0.0, 0.0, traj.yaw_rate(t)])
        a_body = rot.T @ (traj.acc_world(t) - grav)
        imu.append(
            ImuSample(
                stamp=float(t),
                gyr=(w_body + bg + rng.normal(0, imu_noise_gyr, 3)).astype(np.float64),
                acc=(a_body + ba + rng.normal(0, imu_noise_acc, 3)).astype(np.float64),
            )
        )

    # LiDAR sweeps with true per-point motion distortion. Sample times are
    # shuffled against surfaces, as a real scanner interleaves directions,
    # so a partial sweep still constrains every direction.
    scans = []
    gt_stamps, gt_rot, gt_pos = [], [], []
    scan_period = 1.0 / scan_rate
    for k in range(int(duration * scan_rate)):
        t_beg = k * scan_period
        offs = np.sort(rng.uniform(0.0, scan_period, pts_per_scan))
        world_pts = _sample_surfaces(rng, pts_per_scan, world_half, boxes)
        world_pts = world_pts[rng.permutation(len(world_pts))]
        body = np.empty_like(world_pts)
        nb = time_buckets
        buckets = np.minimum((offs / scan_period * nb).astype(int), nb - 1)
        for b in range(nb):
            sel = buckets == b
            if not sel.any():
                continue
            tb = t_beg + (b + 0.5) / nb * scan_period
            rot, pos = traj.pose(tb)
            body[sel] = (world_pts[sel] - pos) @ rot  # R^T (p - t)
        scans.append(
            LidarScan(
                stamp=float(t_beg),
                pts=body.astype(np.float32),
                t_offs_ms=(offs * 1e3).astype(np.float32),
            )
        )
        t_end = t_beg + float(offs[-1])
        rot_e, pos_e = traj.pose(t_end)
        gt_stamps.append(t_end)
        gt_rot.append(rot_e)
        gt_pos.append(pos_e)

    # Camera frames of the analytic room (boxes are not rendered; their
    # candidates are culled by the depth gate).
    frames = None
    if camera is not None:
        dev = _device.resolve(device)
        rot_ci = (R_IC_FORWARD if rot_ic is None else rot_ic).T
        frames = []
        t = cam_offset
        while t < duration:
            rot_wi, pos = traj.pose(t)
            rcw = rot_ci @ rot_wi.T
            pcw = -rcw @ pos
            img = render_room(
                camera,
                torch.tensor(rcw, dtype=torch.float32, device=dev),
                torch.tensor(pcw, dtype=torch.float32, device=dev),
                half=world_half,
            )
            frames.append(ImageFrame(stamp=float(t), img=img.cpu().numpy()))
            t += 1.0 / cam_rate

    return SyntheticSequence(
        imu=imu,
        scans=scans,
        gt_stamps=np.asarray(gt_stamps),
        gt_rot=np.asarray(gt_rot),
        gt_pos=np.asarray(gt_pos),
        world=_sample_surfaces(rng, 60000, world_half, boxes),
        frames=frames,
    )
