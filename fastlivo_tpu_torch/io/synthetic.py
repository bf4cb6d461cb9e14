"""Synthetic LIVO sequences (port of fastlivo_tpu/io/synthetic.py: the
room generator, the street generators and `generate_gnss`).

An analytic trajectory (position and yaw) is sampled to produce IMU at
`imu_rate` with exact body rates and specific force, LiDAR sweeps at
`scan_rate` with true motion distortion (every point is seen from the
sensor pose at its own time), camera frames rendered by `io.render`
(`render_room`, or `render_street` for the street world), and
ground-truth poses. The NumPy draws are the
JAX package's, so one seed gives the same IMU and sweeps in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.io.render import render_room, render_street
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


def make_world(rng: np.random.Generator, n: int = 60000, half: float = 10.0) -> np.ndarray:
    """Reference points on the room's surfaces and six random boxes (the
    scans ray-sample the analytic surfaces; this is for map bootstrap and
    debugging)."""
    return _sample_surfaces(rng, n, half, _default_boxes(rng, half))


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


def street_trajectory(
    out_dist: float = 30.0, speed: float = 2.0, rest_time: float = 0.5
) -> Trajectory:
    """Out-and-back along a street: drive +x for out_dist, U-turn, return.
    Ends near the start — the loop-closure scenario (UrbanNav-style)."""
    t_out = out_dist / speed
    t_turn = 3.0

    def warp(t):
        s = max(t - rest_time, 0.0)
        return s * s / (s + 0.5)

    def pos(t):
        s = warp(t)
        if s < t_out:
            return np.array([speed * s, 0.0, 0.0])
        if s < t_out + t_turn:
            a = (s - t_out) / t_turn * np.pi  # half-circle of radius r
            r = 2.0
            return np.array(
                [out_dist + r * np.sin(a), r * (1 - np.cos(a)), 0.0]
            )
        return np.array(
            [out_dist - speed * (s - t_out - t_turn), 2.0 * 2, 0.0]
        )

    def yaw(t):
        s = warp(t)
        if s < t_out:
            return 0.0
        if s < t_out + t_turn:
            return (s - t_out) / t_turn * np.pi
        return np.pi

    return Trajectory(pos_fn=pos, yaw_fn=yaw)


def circuit_trajectory(
    straight: float = 14.0, radius: float = 3.0, speed: float = 2.0,
    rest_time: float = 0.5,
) -> Trajectory:
    """Closed stadium circuit in the street world: straight +x at y=0,
    half-circle up, straight -x at y=2*radius, half-circle back to the
    start — returning to the origin with the SAME heading, so a revisit's
    key cloud AND camera view both overlap the first pass (the loop case
    where the visual verification gate can confirm, unlike an
    out-and-back U-turn whose return views face the opposite way)."""
    per = 2 * straight + 2 * np.pi * radius

    def warp(t):
        s = max(t - rest_time, 0.0)
        return s * s / (s + 0.5)

    def at(arc):
        a = arc % per
        if a < straight:
            return np.array([a, 0.0, 0.0]), 0.0
        a -= straight
        if a < np.pi * radius:
            th = a / radius
            return (
                np.array(
                    [straight + radius * np.sin(th),
                     radius * (1 - np.cos(th)), 0.0]
                ),
                th,
            )
        a -= np.pi * radius
        if a < straight:
            return np.array([straight - a, 2 * radius, 0.0]), np.pi
        a -= straight
        th = a / radius
        return (
            np.array(
                [-radius * np.sin(th), radius * (1 + np.cos(th)), 0.0]
            ),
            np.pi + th,
        )

    def pos(t):
        return at(speed * warp(t))[0]

    def yaw(t):
        # Unwrapped yaw: monotone with arc length (one full turn per lap).
        arc = speed * warp(t)
        laps = int(arc // per)
        return at(arc)[1] + 2 * np.pi * laps

    return Trajectory(pos_fn=pos, yaw_fn=yaw)


def street_boxes(x_extent=40.0, layout_seed=123, n_b=8):
    """The street's building layout as (cx, cy, w, d, h) rows (same draw
    sequence street_surfaces always used, so existing scenes are
    unchanged). AABB of row k: [cx - w/2, cx + w/2] x [cy - d/2, cy + d/2]
    x [-1.5, h - 1.5]."""
    rng2 = np.random.default_rng(layout_seed)
    rows = []
    for _ in range(n_b):
        cx = rng2.uniform(0, x_extent)
        cy = rng2.choice([-7.0, 11.0]) + rng2.uniform(-1, 1)
        w, d, h = rng2.uniform(3, 6, 3)
        rows.append((cx, cy, w, d, h))
    return np.asarray(rows, np.float64)


def street_surfaces(rng, n, x_extent=40.0, layout_seed=123):
    """Ground + buildings with dense corner edges lining a street."""
    pts = [
        np.stack(
            [
                rng.uniform(-10, x_extent + 10, n // 3),
                rng.uniform(-12, 16, n // 3),
                np.full(n // 3, -1.5),
            ],
            1,
        )
    ]
    boxes = street_boxes(x_extent, layout_seed)
    n_b = len(boxes)
    for cx, cy, w, d, h in boxes:
        per = n // (3 * n_b)
        for axis, val in ((0, -w / 2), (0, w / 2), (1, -d / 2), (1, d / 2)):
            u = rng.uniform(0, 1, (per, 2))
            face = np.zeros((per, 3))
            face[:, axis] = val
            face[:, 1 - axis] = (u[:, 0] - 0.5) * (d if axis == 0 else w)
            face[:, 2] = u[:, 1] * h - 1.5
            face[:, 0] += cx
            face[:, 1] += cy
            pts.append(face)
        for ex, ey in ((-w / 2, -d / 2), (-w / 2, d / 2), (w / 2, -d / 2), (w / 2, d / 2)):
            z = rng.uniform(-1.5, h - 1.5, per // 3)
            edge = np.stack(
                [np.full_like(z, cx + ex), np.full_like(z, cy + ey), z], 1
            )
            edge[:, :2] += rng.normal(0, 0.02, (len(z), 2))
            pts.append(edge)
    out = np.concatenate(pts).astype(np.float32)
    return out


def generate_street(
    duration: float = 36.0,
    imu_rate: float = 200.0,
    scan_rate: float = 10.0,
    pts_per_scan: int = 10000,
    seed: int = 0,
    max_range: float = 30.0,
    gyro_bias: np.ndarray | None = None,
    imu_noise_gyr: float = 0.0,
    camera=None,  # ops.camera.Pinhole -> also render frames (render_street)
    cam_rate: float = 10.0,
    cam_offset: float = 0.055,
    rot_ic: np.ndarray | None = None,
    trajectory: Trajectory | None = None,
    device=None,
) -> SyntheticSequence:
    """Street sequence for loop-closure testing (out-and-back by default):
    scans are range-limited samples of a large structured world. Frames
    (when `camera` is given) are rendered on `device`: None means the GPU."""
    rng = np.random.default_rng(seed)
    traj = trajectory or street_trajectory()
    grav = np.array([0.0, 0.0, -GRAVITY_MS2])

    bg = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    imu = []
    for t in np.arange(0.0, duration + 1e-9, 1.0 / imu_rate):
        rot, _ = traj.pose(t)
        w_body = np.array([0.0, 0.0, traj.yaw_rate(t)]) + bg
        if imu_noise_gyr:
            w_body = w_body + rng.normal(0, imu_noise_gyr, 3)
        a_body = rot.T @ (traj.acc_world(t) - grav)
        imu.append(ImuSample(stamp=float(t), gyr=w_body, acc=a_body))

    scans = []
    gt_stamps, gt_rot, gt_pos = [], [], []
    period = 1.0 / scan_rate
    for k in range(int(duration * scan_rate)):
        t_beg = k * period
        offs = np.sort(rng.uniform(0.0, period, pts_per_scan))
        # oversample the world, keep points within range of the mid-sweep pose
        world = street_surfaces(rng, pts_per_scan * 4, layout_seed=123)
        _, p_mid = traj.pose(t_beg + period / 2)
        near = np.linalg.norm(world[:, :2] - p_mid[:2], axis=1) < max_range
        world = world[near]
        if len(world) < pts_per_scan:
            reps = -(-pts_per_scan // max(len(world), 1)) + 1
            world = np.tile(world, (reps, 1))[:pts_per_scan]
        world = world[rng.permutation(len(world))[:pts_per_scan]]
        body = np.empty_like(world)
        buckets = np.minimum((offs / period * 16).astype(int), 15)
        for b in range(16):
            sel = buckets == b
            if not sel.any():
                continue
            rot, pos = traj.pose(t_beg + (b + 0.5) / 16 * period)
            body[sel] = (world[sel] - pos) @ rot
        scans.append(
            LidarScan(
                stamp=float(t_beg),
                pts=body.astype(np.float32),
                t_offs_ms=(offs * 1e3).astype(np.float32),
            )
        )
        t_end = t_beg + float(offs[-1])
        r_e, p_e = traj.pose(t_end)
        gt_stamps.append(t_end)
        gt_rot.append(r_e)
        gt_pos.append(p_e)

    frames = None
    if camera is not None:
        dev = _device.resolve(device)
        r_ic = R_IC_FORWARD if rot_ic is None else rot_ic
        rot_ci = r_ic.T
        boxes_t = torch.as_tensor(street_boxes(), device=dev)
        frames = []
        t = cam_offset
        while t < duration:
            rot_wi, pos = traj.pose(t)
            rcw = rot_ci @ rot_wi.T
            pcw = -rcw @ pos
            img = render_street(
                camera,
                torch.tensor(rcw, dtype=torch.float32, device=dev),
                torch.tensor(pcw, dtype=torch.float32, device=dev),
                boxes_t,
            )
            frames.append(ImageFrame(stamp=float(t), img=img.cpu().numpy()))
            t += 1.0 / cam_rate

    return SyntheticSequence(
        imu=imu,
        scans=scans,
        gt_stamps=np.asarray(gt_stamps),
        gt_rot=np.asarray(gt_rot),
        gt_pos=np.asarray(gt_pos),
        world=street_surfaces(rng, 60000),
        frames=frames,
    )


def generate_gnss(
    seq: SyntheticSequence,
    anchor_blh=(0.389, 1.993, 20.0),  # rad, rad, m
    yaw_enu_to_world: float = 0.4,
    rate: float = 5.0,
    noise_m: float = 0.02,
    lever: np.ndarray | None = None,
    seed: int = 0,
    t_unix0: float = 1.7e9,
):
    """Derive a GNSS ECEF stream from a sequence's ground truth (the
    MARS-LVIG-style input the reference consumes from RTK files).

    Returns a list of models.gnss.GnssSample whose ENU track is the world
    trajectory rotated by -yaw (so the fusion must recover the yaw and
    lever)."""
    from scipy.spatial.transform import Rotation

    from fastlivo_tpu_torch.models.gnss import GnssSample
    from fastlivo_tpu_torch.ops import earth

    rng = np.random.default_rng(seed)
    anchor = earth.blh2ecef(np.asarray(anchor_blh))
    c_ne = earth.cne(earth.ecef2blh(anchor))
    r_we = Rotation.from_euler("z", yaw_enu_to_world).as_matrix()
    lv = np.zeros(3) if lever is None else np.asarray(lever)

    out = []
    for k in range(len(seq.gt_stamps)):
        t = seq.gt_stamps[k]
        if rate < 1000 and (k % max(int(round(10.0 / rate)), 1)) != 0:
            continue
        antenna_w = seq.gt_pos[k] + seq.gt_rot[k] @ lv
        enu = r_we.T @ antenna_w + rng.normal(0, noise_m, 3)
        out.append(
            GnssSample(
                time=t_unix0 + float(t),
                ecef=anchor + c_ne.T @ enu,
                std_enu=np.full(3, max(noise_m, 0.01)),
            )
        )
    return out
