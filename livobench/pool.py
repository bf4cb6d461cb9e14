"""The benchmark's sensor pools: one exact lap of a periodic trajectory
through a synthetic scene, and the rest lead-in before it.

A traffic file (`livobench/traffic/<mix>.json`) gives the scene, the lap
(a rounded-rectangle path driven at constant speed, heading along it, with
an optional vertical bob), the rest and ramp before the lap, and the
sensors (LiDAR sweep rate, points per sweep, time buckets, range noise;
IMU rate and noise; camera rate and offset). The rig (LiDAR-IMU and
camera extrinsics, intrinsics, the camera time offset `delta_time`) and
the reader's point rule come from the configuration, so the shipped
configuration runs as it is.

The lap period is a whole number of sweep, IMU and frame periods, and the
motion is exactly periodic from the lap's start on, so lap k is lap 0 with
its stamps shifted by k periods: `Pool.stream` replays lap 0 for ever, and
any window, at any speed, sees an unbroken stream. With the traffic key
`trajectory.lap_draws` (default 1) the pool holds that many draws of the
lap, each from the seed and its ordinal, and lap k replays draw k mod
`lap_draws`: the same stamps, motion and frames, other points and noise,
so that a revisit does not see the very sweep it saw before.

This is the benchmark's own copy of the port's generator
(`fastlivo_tpu_torch/io/synthetic.py`: sweeps with true per-point motion
distortion in time buckets, IMU from the analytic motion, frames rendered
from the room) and of the log reader's point rule, vectorised and run on
the device of the caller's choice.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np
import torch

from livobench import render
from livobench.reference.camera import Pinhole

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
GRAVITY = 9.81  # m/s^2, the port's GRAVITY_MS2

# Record kinds, in the order records of one stamp are written to a log.
IMU, LIDAR, IMG = "imu", "lidar", "img"
_KIND_ORDER = {IMU: 0, LIDAR: 1, IMG: 2}
SWEEP_CHUNK = 16  # sweeps drawn together on the device


def load_traffic(name: str) -> dict:
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Motion: a closed path at constant speed after a rest and a smooth ramp.
# ---------------------------------------------------------------------------


class LapPath:
    """A rounded rectangle (a circle when the straights have no length),
    driven counter-clockwise from the middle of its bottom straight,
    heading +x. `at(s)` gives position, heading (unwrapped, 2 pi per lap)
    and curvature at arc length s."""

    def __init__(self, width: float, height: float, corner: float, center=(0.0, 0.0)):
        if not (0 < corner and 2 * corner <= min(width, height)):
            raise ValueError("corner radius must be positive and fit the rectangle")
        sx, sy = width - 2 * corner, height - 2 * corner
        cx, cy = center
        # (length, start xy, start heading, curvature) per segment, from
        # the middle of the bottom straight.
        segs = []
        x, y, h = cx, cy - height / 2, 0.0
        for i, straight in enumerate((sx / 2, sy, sx, sy, sx / 2)):
            if straight > 0:
                segs.append((straight, x, y, h, 0.0))
                x, y = x + straight * math.cos(h), y + straight * math.sin(h)
            if i < 4:
                segs.append((0.5 * math.pi * corner, x, y, h, 1.0 / corner))
                x = x + corner * (math.sin(h + 0.5 * math.pi) - math.sin(h))
                y = y - corner * (math.cos(h + 0.5 * math.pi) - math.cos(h))
                h += 0.5 * math.pi
        self.segs = np.asarray(segs, np.float64)
        self.starts = np.concatenate([[0.0], np.cumsum(self.segs[:, 0])[:-1]])
        self.length = float(self.segs[:, 0].sum())

    def at(self, s: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s = np.asarray(s, np.float64)
        laps = np.floor(s / self.length)
        a = s - laps * self.length
        i = np.clip(np.searchsorted(self.starts, a, side="right") - 1, 0, len(self.segs) - 1)
        _, x0, y0, h0, k = self.segs[i].T
        d = a - self.starts[i]
        straight = k == 0
        kk = np.where(straight, 1.0, k)
        heading = h0 + np.where(straight, 0.0, d * k)
        x = np.where(straight, x0 + d * np.cos(h0), x0 + (np.sin(heading) - np.sin(h0)) / kk)
        y = np.where(straight, y0 + d * np.sin(h0), y0 - (np.cos(heading) - np.cos(h0)) / kk)
        return np.stack([x, y], -1), heading + 2 * math.pi * laps, k


def _smootherstep(x):
    """(S(x), S'(x), S''(x)) of the quintic smoothstep on [0, 1]."""
    x = np.clip(x, 0.0, 1.0)
    return (
        x**3 * (10 - 15 * x + 6 * x * x),
        30 * x * x * (1 - x) ** 2,
        60 * x * (1 - x) * (1 - 2 * x),
    )


class Motion:
    """Rest for `rest_s`, a quintic speed ramp over `ramp_s`, then constant
    speed round the path: one lap every `lap_s` from `lap0 = rest_s +
    ramp_s` on. The body is level; its yaw follows the path's heading."""

    def __init__(self, traj: dict):
        p = traj["path"]
        self.path = LapPath(p["width"], p["height"], p["corner"], tuple(p.get("center", (0.0, 0.0))))
        self.lap_s = float(traj["lap_s"])
        self.speed = self.path.length / self.lap_s
        self.rest_s = float(traj["rest_s"])
        self.ramp_s = float(traj["ramp_s"])
        self.lap0 = self.rest_s + self.ramp_s
        self.z0 = float(traj.get("z", 0.0))
        bob = traj.get("bob", {})
        self.bob_amp = float(bob.get("amplitude", 0.0))
        self.bob_k = 2 * math.pi * int(bob.get("cycles", 0)) / self.path.length

    def warp(self, t):
        """Path time tau(t) and its first two derivatives: 0 at rest, the
        integral of the ramp's speed profile, then t - lap0 + ramp_s / 2.
        tau(lap0 + k lap_s) = ramp_s / 2 + k lap_s."""
        t = np.asarray(t, np.float64)
        x = (t - self.rest_s) / self.ramp_s
        xc = np.clip(x, 0.0, 1.0)
        integral = xc**4 * (2.5 - 3 * xc + xc * xc)  # the integral of S over [0, x]
        s, ds, _ = _smootherstep(x)
        tau = np.where(x >= 1, t - self.lap0 + 0.5 * self.ramp_s, self.ramp_s * integral)
        dtau = np.where(x >= 1, 1.0, s)
        ddtau = np.where((x > 0) & (x < 1), ds / self.ramp_s, 0.0)
        return tau, dtau, ddtau

    def kinematics(self, t):
        """pos, vel, acc (n, 3) in the world; yaw, yaw rate (n,)."""
        tau, dtau, ddtau = self.warp(t)
        v = self.speed
        s, ds, dds = v * tau, v * dtau, v * ddtau
        xy, heading, kappa = self.path.at(s)
        tan = np.stack([np.cos(heading), np.sin(heading)], -1)
        nrm = np.stack([-np.sin(heading), np.cos(heading)], -1)
        vel_xy = tan * ds[:, None]
        acc_xy = tan * dds[:, None] + nrm * (kappa * ds * ds)[:, None]
        w = self.bob_k
        z = self.z0 + self.bob_amp * np.sin(w * s)
        vz = self.bob_amp * w * np.cos(w * s) * ds
        az = -self.bob_amp * w * w * np.sin(w * s) * ds * ds + self.bob_amp * w * np.cos(w * s) * dds
        pos = np.concatenate([xy, z[:, None]], -1)
        vel = np.concatenate([vel_xy, vz[:, None]], -1)
        acc = np.concatenate([acc_xy, az[:, None]], -1)
        return pos, vel, acc, heading, kappa * ds

    def pose(self, t):
        """(rot_wi (n, 3, 3), pos (n, 3)) at times t."""
        pos, _, _, yaw, _ = self.kinematics(np.atleast_1d(t))
        c, s = np.cos(yaw), np.sin(yaw)
        rot = np.zeros((len(yaw), 3, 3))
        rot[:, 0, 0], rot[:, 0, 1], rot[:, 1, 0], rot[:, 1, 1], rot[:, 2, 2] = c, -s, s, c, 1.0
        return rot, pos


# ---------------------------------------------------------------------------
# Scenes: world points for one sweep, drawn on the device.
# ---------------------------------------------------------------------------


class RoomScene:
    """The generator's indoor room: floor, four walls and boxes, the same
    number of points on each surface (`io/synthetic._sample_surfaces`).
    A box is (cx, cy, cz, hx, hy, hz), its half-extents last."""

    def __init__(self, spec: dict):
        self.half = float(spec["half"])
        self.floor_z = float(spec["floor_z"])
        self.boxes = np.asarray(spec.get("boxes", []), np.float64).reshape(-1, 6)

    def sample(self, gen, n: int, center_xy, device) -> torch.Tensor:
        half, dev = self.half, device
        per = n // (5 + len(self.boxes))

        def uni(shape, lo, hi):
            return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev, dtype=torch.float64)

        parts = []
        u = uni((per, 2), -half, half)
        parts.append(torch.stack([u[:, 0], u[:, 1], torch.full_like(u[:, 0], self.floor_z)], 1))
        for axis, val in ((0, -half), (0, half), (1, -half), (1, half)):
            u = uni((per, 2), -half, half)
            w = torch.zeros((per, 3), dtype=torch.float64, device=dev)
            w[:, axis] = val
            w[:, 1 - axis] = u[:, 0]
            w[:, 2] = u[:, 1] * 0.4 + 2.0
            parts.append(w)
        rows = torch.arange(per, device=dev)
        for box in self.boxes:
            c = torch.as_tensor(box[:3], device=dev)
            sz = torch.as_tensor(box[3:], device=dev)
            u = uni((per, 3), -1.0, 1.0)
            face = torch.randint(0, 3, (per,), generator=gen, device=dev)
            u[rows, face] = torch.sign(u[rows, face])
            parts.append(c + u * sz)
        out = torch.cat(parts)
        if len(out) < n:  # the integer-division remainder: top up from the floor
            u = uni((n - len(out), 2), -half, half)
            out = torch.cat([out, torch.stack([u[:, 0], u[:, 1], torch.full_like(u[:, 0], self.floor_z)], 1)])
        return out


class StreetScene:
    """A city block's street circuit: a flat ground and box buildings on
    both sides of the lap's path, laid out from `layout_seed`. A sweep
    draws `ground_share` of its points on the ground around the sensor
    (log-uniform in range, as a spinning LiDAR's rings thin out) and the
    rest on the building faces within `building_range_m`."""

    def __init__(self, spec: dict, path: LapPath):
        self.ground_z = float(spec["ground_z"])
        self.ground_range = tuple(spec["ground_range_m"])
        self.building_range = float(spec["building_range_m"])
        self.ground_share = float(spec["ground_share"])
        rng = np.random.default_rng(int(spec["layout_seed"]))
        boxes = []  # (x0, y0, x1, y1, height)
        for length, x0, y0, h0, k in path.segs:
            if k != 0:
                continue
            tx, ty = math.cos(h0), math.sin(h0)
            for side in (1.0, -1.0):  # left of the heading (inside the block), right
                a = float(spec["end_margin_m"])
                while True:
                    front = rng.uniform(*spec["frontage_m"])
                    if a + front > length - spec["end_margin_m"]:
                        break
                    back = rng.uniform(*spec["setback_m"])
                    depth = rng.uniform(*spec["depth_m"])
                    height = rng.uniform(*spec["height_m"])
                    nx, ny = -ty * side, tx * side
                    pts = [
                        (x0 + tx * aa + nx * bb, y0 + ty * aa + ny * bb)
                        for aa in (a, a + front) for bb in (back, back + depth)
                    ]
                    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
                    boxes.append((min(xs), min(ys), max(xs), max(ys), height))
                    a += front + rng.uniform(*spec["gap_m"])
        self.boxes = np.asarray(boxes, np.float64)
        faces = []  # (x0, y0, x1, y1, height): vertical faces from the ground
        for x0, y0, x1, y1, h in self.boxes:
            faces += [(x0, y0, x1, y0, h), (x1, y0, x1, y1, h), (x1, y1, x0, y1, h), (x0, y1, x0, y0, h)]
        self.faces = np.asarray(faces, np.float64)

    def _near_faces(self, center_xy):
        a, b = self.faces[:, 0:2], self.faces[:, 2:4]
        ab = b - a
        t = np.clip(((center_xy - a) * ab).sum(1) / np.maximum((ab * ab).sum(1), 1e-12), 0, 1)
        d = np.linalg.norm(a + t[:, None] * ab - center_xy, axis=1)
        return self.faces[d <= self.building_range]

    def sample(self, gen, n: int, center_xy, device) -> torch.Tensor:
        dev = device
        n_g = int(round(self.ground_share * n))
        r0, r1 = self.ground_range
        u = torch.rand((n_g, 2), generator=gen, device=dev, dtype=torch.float64)
        r = r0 * (r1 / r0) ** u[:, 0]
        th = 2 * math.pi * u[:, 1]
        c = torch.as_tensor(np.asarray(center_xy, np.float64), device=dev)
        ground = torch.stack(
            [c[0] + r * torch.cos(th), c[1] + r * torch.sin(th), torch.full_like(r, self.ground_z)], 1
        )
        n_b = n - n_g
        faces = self._near_faces(np.asarray(center_xy, np.float64))
        if len(faces) == 0:
            raise ValueError(f"no building within {self.building_range} m of {center_xy}")
        f = torch.as_tensor(faces, device=dev)
        width = torch.linalg.vector_norm(f[:, 2:4] - f[:, 0:2], dim=1)
        area = width * f[:, 4]
        m = 4 * n_b
        idx = torch.multinomial(area / area.sum(), m, replacement=True, generator=gen)
        u = torch.rand((m, 2), generator=gen, device=dev, dtype=torch.float64)
        fi = f[idx]
        xy = fi[:, 0:2] + u[:, 0:1] * (fi[:, 2:4] - fi[:, 0:2])
        z = self.ground_z + u[:, 1] * fi[:, 4]
        keep = torch.linalg.vector_norm(xy - c, dim=1) <= self.building_range
        pts = torch.cat([xy, z[:, None]], 1)[keep]
        if len(pts) < n_b:  # a sparse neighbourhood: repeat what was drawn
            pts = pts.repeat(-(-n_b // max(len(pts), 1)), 1)
        return torch.cat([ground, pts[:n_b]])


def make_scene(spec: dict, motion: Motion):
    if spec["kind"] == "room":
        return RoomScene(spec)
    if spec["kind"] == "street":
        return StreetScene(spec, motion.path)
    raise ValueError(f"unknown scene kind {spec['kind']!r}")


# ---------------------------------------------------------------------------
# The reader's point rule.
# ---------------------------------------------------------------------------


def reader_keep(pts: torch.Tensor, point_filter_num: int, blind: float, max_range: float) -> torch.Tensor:
    """What the port's log reader keeps of decoded sweeps (..., N, 3) f32:
    every `point_filter_num`-th point of each sweep, with horizontal range
    in (blind, max_range), finite (`io/logio._read_python`)."""
    n = pts.shape[-2]
    keep = torch.zeros(n, dtype=torch.bool, device=pts.device)
    keep[:: max(point_filter_num, 1)] = True
    r2 = pts[..., 0] ** 2 + pts[..., 1] ** 2
    return keep & (r2 > blind**2) & (r2 < max_range**2) & torch.isfinite(pts).all(-1)


# ---------------------------------------------------------------------------
# The pool.
# ---------------------------------------------------------------------------


@dataclass
class Record:
    kind: str  # IMU, LIDAR or IMG
    stamp: float  # as a log holds it (a frame's stamp before delta_time)
    data: tuple  # IMU (gyr, acc); LIDAR (pts (N, 3) f32, t_offs_ms (N,) f32); IMG (img,)


@dataclass
class Pool:
    lead: List[Record]  # stamps before lap0
    draws: List[List[Record]]  # each draw of lap 0: stamps in [lap0, lap0 + period)
    lap0: float
    period: float
    motion: Motion
    setup_laps: int  # whole laps replayed in set-up, after the lead-in

    @property
    def lap(self) -> List[Record]:
        """The first draw of lap 0."""
        return self.draws[0]

    def lap_records(self, k: int) -> Iterator[Record]:
        """Lap k: the records of draw k mod the draws, their stamps shifted
        by k periods."""
        shift = k * self.period
        for r in self.draws[k % len(self.draws)]:
            yield Record(r.kind, r.stamp + shift, r.data)

    def stream(self, first_lap: int = 0, with_lead: bool = True) -> Iterator[Record]:
        """The lead-in, then laps first_lap, first_lap + 1, ... for ever."""
        if with_lead:
            yield from self.lead
        k = first_lap
        while True:
            yield from self.lap_records(k)
            k += 1


def _whole(x: float, period: float, what: str) -> int:
    n = round(x / period)
    if abs(n * period - x) > 1e-9 * max(1.0, abs(x)):
        raise ValueError(f"{what} ({x} s) is not a whole number of {period} s periods")
    return n


def _rig(cfg):
    """(R_il, t_il, R_cl, P_cl) of the configuration, float64."""
    r_il = np.asarray(cfg.extrinsics.extrinsic_r, np.float64).reshape(3, 3)
    t_il = np.asarray(cfg.extrinsics.extrinsic_t, np.float64)
    r_cl = np.asarray(cfg.camera.rcl, np.float64).reshape(3, 3)
    p_cl = np.asarray(cfg.camera.pcl, np.float64)
    return r_il, t_il, r_cl, p_cl


def _draw_seed(seed: int, draw: int) -> int:
    """The torch generator's seed of lap draw `draw` (> 0) of `seed`."""
    return int(np.random.SeedSequence([int(seed), int(draw)]).generate_state(1, np.uint64)[0])


def build_pool(traffic: dict, cfg, seed: int, device) -> Pool:
    """The lead-in and lap 0 of `traffic` for the rig and reader rule of
    `cfg` (the reference's `params.read`), drawn from `seed`; heavy draws
    on `device`. Every seed gives the same sizes, times and motion; the
    seed draws the points, the noise and nothing else. Draw d > 0 of lap 0
    (`trajectory.lap_draws`) draws its points and noise from (seed, d)."""
    dev = torch.device(device)
    motion = Motion(traffic["trajectory"])
    scene = make_scene(traffic["scene"], motion)
    lid, imu_s = traffic["lidar"], traffic["imu"]
    cam_s = traffic.get("camera") if cfg.vio.img_enable else None
    sweep = 1.0 / lid["rate_hz"]
    imu_dt = 1.0 / imu_s["rate_hz"]
    periods = [(sweep, "sweep"), (imu_dt, "IMU")] + ([(1.0 / cam_s["rate_hz"], "frame")] if cam_s else [])
    for per, what in periods:
        _whole(motion.lap_s, per, f"the lap ({what})")
        _whole(motion.lap0, per, f"the lap's start ({what})")
    end = motion.lap0 + motion.lap_s
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    rng = np.random.default_rng(int(seed))
    r_il, t_il, r_cl, p_cl = _rig(cfg)
    records: List[Record] = []
    n_draws = int(traffic["trajectory"].get("lap_draws", 1))
    if n_draws < 1:
        raise ValueError(f"trajectory.lap_draws is {n_draws}: at least one draw of the lap")

    def imu_records(t, rng):
        """Exact body rate and specific force at times t, plus white noise."""
        _, _, acc_w, yaw, yaw_rate = motion.kinematics(t)
        c, s = np.cos(yaw), np.sin(yaw)
        f_w = acc_w - np.array([0.0, 0.0, -GRAVITY])
        f_b = np.stack([c * f_w[:, 0] + s * f_w[:, 1], -s * f_w[:, 0] + c * f_w[:, 1], f_w[:, 2]], -1)
        gyr = np.stack([np.zeros_like(yaw_rate), np.zeros_like(yaw_rate), yaw_rate], -1)
        gyr = gyr + rng.normal(0.0, imu_s["gyr_noise"], gyr.shape)
        acc = f_b + rng.normal(0.0, imu_s["acc_noise"], f_b.shape)
        # The lead-in's rest is exactly at rest (a clean static initialization).
        still = t < motion.rest_s
        gyr[still] = 0.0
        acc[still] = [0.0, 0.0, GRAVITY]
        return [Record(IMU, float(ti), (g, a)) for ti, g, a in zip(t, gyr, acc)]

    t_imu = np.arange(_whole(end, imu_dt, "the pool")) * imu_dt
    records += imu_records(t_imu, rng)

    # LiDAR sweeps, drawn on the device a chunk of sweeps at a time.
    n_sweeps = _whole(end, sweep, "the pool")
    nb, n_pts = int(lid["time_buckets"]), int(lid["points_per_sweep"])
    noise = float(lid.get("range_noise_m", 0.0))
    rot_il_t = torch.as_tensor(r_il, device=dev)
    t_il_t = torch.as_tensor(t_il, device=dev)
    # Each point is seen from the pose at its time bucket's middle.
    rot_b, pos_b = motion.pose(((np.arange(n_sweeps)[:, None] + (np.arange(nb) + 0.5) / nb) * sweep).ravel())
    rot_b = torch.as_tensor(rot_b, device=dev).reshape(n_sweeps, nb, 3, 3)
    pos_b = torch.as_tensor(pos_b, device=dev).reshape(n_sweeps, nb, 3)
    _, mids = motion.pose((np.arange(n_sweeps) + 0.5) * sweep)

    def sweep_records(first: int, gen):
        """Sweeps first, first + 1, ... of the pool, drawn from `gen`."""
        out = []
        for c0 in range(first, n_sweeps, SWEEP_CHUNK):
            ks = np.arange(c0, min(c0 + SWEEP_CHUNK, n_sweeps))
            world = torch.stack([
                scene.sample(gen, n_pts, mids[k, :2], dev)[torch.randperm(n_pts, generator=gen, device=dev)]
                for k in ks
            ])
            offs, _ = torch.sort(
                torch.rand((len(ks), n_pts), generator=gen, device=dev, dtype=torch.float64) * sweep, dim=1
            )
            buckets = torch.clamp((offs / sweep * nb).long(), max=nb - 1)
            rows = torch.as_tensor(ks, device=dev)[:, None]
            p_imu = torch.einsum("knji,knj->kni", rot_b[rows, buckets], world - pos_b[rows, buckets])
            p_l = (p_imu - t_il_t) @ rot_il_t  # R_il^T (p_imu - t_il)
            if noise:
                ray = p_l / torch.linalg.vector_norm(p_l, dim=-1, keepdim=True).clamp(min=1e-9)
                p_l = p_l + ray * noise * torch.randn(
                    (len(ks), n_pts, 1), generator=gen, device=dev, dtype=torch.float64
                )
            pts = p_l.float()
            keep = reader_keep(pts, cfg.preprocess.point_filter_num, cfg.preprocess.blind,
                               cfg.preprocess.max_range)
            counts = keep.sum(1).tolist()
            kept = torch.split(pts[keep].cpu(), counts)
            kept_ms = torch.split((offs * 1e3).float()[keep].cpu(), counts)
            for k, x, t_ms in zip(ks, kept, kept_ms):
                out.append(Record(LIDAR, float(k * sweep), (x.numpy(), t_ms.numpy())))
        return out

    records += sweep_records(0, gen)

    # Camera frames of the room at their true times; stamped as the rig
    # stamps them (the synchronizer adds delta_time back).
    if cam_s:
        cam = Pinhole.from_params(cfg.camera)
        scene_spec = traffic["scene"]
        dt = cfg.vio.delta_time
        rate = cam_s["rate_hz"]
        n_fr = int(math.ceil((end + dt - cam_s["offset_s"]) * rate))
        t_true = cam_s["offset_s"] + np.arange(n_fr) / rate
        t_true = t_true[t_true - dt < end - 1e-9]
        rot_wi, pos = motion.pose(t_true)
        rl = r_cl @ r_il.T
        for ti, rw, p in zip(t_true, rot_wi, pos):
            rcw = rl @ rw.T
            pcw = -rcw @ p - rl @ t_il + p_cl
            img = render.render_room(
                cam,
                torch.tensor(rcw, dtype=torch.float32, device=dev),
                torch.tensor(pcw, dtype=torch.float32, device=dev),
                half=float(scene_spec["half"]),
                floor_z=float(scene_spec["floor_z"]),
            )
            img = torch.clamp(torch.round(img), 0, 255).cpu().numpy().astype(np.float32)
            records.append(Record(IMG, float(ti - dt), (img,)))

    def in_lap(r):
        return motion.lap0 - 1e-9 <= r.stamp < end - 1e-9

    records.sort(key=lambda r: (r.stamp, _KIND_ORDER[r.kind]))
    lead = [r for r in records if r.stamp < motion.lap0 - 1e-9]
    lap = [r for r in records if in_lap(r)]
    # Lap 0 lies where the motion is periodic (a frame's true time is its
    # stamp plus delta_time), so lap k is lap 0 shifted.
    dt = cfg.vio.delta_time if cam_s else 0.0
    if any((r.stamp + (dt if r.kind == IMG else 0.0)) < motion.lap0 - 1e-9 for r in lap):
        raise ValueError("a frame of lap 0 was taken before the lap's start")
    draws = [lap]
    frames = [r for r in lap if r.kind == IMG]
    first_sweep = _whole(motion.lap0, sweep, "the lap's start")
    for d in range(1, n_draws):
        gen.manual_seed(_draw_seed(seed, d))
        again = (imu_records(t_imu[t_imu >= motion.lap0 - 1e-9], np.random.default_rng([int(seed), d]))
                 + sweep_records(first_sweep, gen) + frames)
        again.sort(key=lambda r: (r.stamp, _KIND_ORDER[r.kind]))
        draws.append([r for r in again if in_lap(r)])
    return Pool(lead=lead, draws=draws, lap0=motion.lap0, period=motion.lap_s, motion=motion,
                setup_laps=int(traffic["trajectory"]["setup_laps"]))
