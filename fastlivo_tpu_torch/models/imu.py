"""IMU forward propagation and point undistortion (port of
fastlivo_tpu/models/imu.py).

The JAX `lax.scan` over the window becomes a Python loop over the M-1
intervals. Everything that does not depend on the loop carry (the interval
exponentials, the transition blocks once the rotation chain is known) is
computed batched around it, so the loop itself is a few small kernels per
sample: the rotation chain, the covariance recursion and the
position/velocity recursion, each in the JAX order of operations.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch.ops import so3
from fastlivo_tpu_torch.state import DIM_STATE, GRAVITY_MS2, NavState


class ImuWindow(NamedTuple):
    """Fixed-size IMU measurement window for one propagation step; index 0
    holds the carried-over last sample of the previous window."""

    stamps: torch.Tensor  # (M,) f32, relative seconds, nondecreasing
    gyr: torch.Tensor  # (M, 3) rad/s
    acc: torch.Tensor  # (M, 3) m/s^2 (raw, scaled by acc_scale)
    mask: torch.Tensor  # (M,) bool


class ImuPoses(NamedTuple):
    """Pose trajectory at IMU sample times (entry 0 = window start)."""

    stamps: torch.Tensor  # (M,)
    rot: torch.Tensor  # (M, 3, 3)
    pos: torch.Tensor  # (M, 3)
    vel: torch.Tensor  # (M, 3)
    acc_w: torch.Tensor  # (M, 3)
    gyr_b: torch.Tensor  # (M, 3)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor without a host read of i."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def propagate(
    state: NavState,
    window: ImuWindow,
    t_end: torch.Tensor,
    acc_scale: torch.Tensor,
    cov_gyr: float = 0.01,
    cov_acc: float = 0.01,
    cov_bias_gyr: float = 1e-4,
    cov_bias_acc: float = 1e-4,
) -> Tuple[NavState, ImuPoses]:
    """Propagate nominal state + covariance through the IMU window to t_end
    (same transition F_x and process noise as the JAX package)."""
    dtype = state.pos.dtype
    dev = state.pos.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    gyr_avg = 0.5 * (window.gyr[:-1] + window.gyr[1:]) - state.bg
    acc_avg = 0.5 * (window.acc[:-1] + window.acc[1:]) * acc_scale - state.ba
    dts = (window.stamps[1:] - window.stamps[:-1]) * window.mask[1:].to(dtype)
    dts = torch.clamp(dts, min=0.0)
    k = dts.shape[0]

    wdt = gyr_avg * dts[:, None]
    exp_w = so3.exp(wdt)  # (K, 3, 3)
    exp_nw = so3.exp(-gyr_avg * dts[:, None])

    # Rotation chain: rots[i] is the carry rotation entering interval i.
    rots = [state.rot]
    for i in range(k):
        rots.append(rots[-1] @ exp_w[i])
    rot_all = torch.stack(rots)  # (K+1, 3, 3)
    rot_in = rot_all[:-1]

    dt3 = dts[:, None, None]
    dt2 = dts * dts
    fx = torch.eye(DIM_STATE, dtype=dtype, device=dev).repeat(k, 1, 1)
    fx[:, 0:3, 0:3] = exp_nw
    fx[:, 0:3, 9:12] = -eye3 * dt3
    fx[:, 3:6, 6:9] = eye3 * dt3
    fx[:, 6:9, 0:3] = -(rot_in @ so3.hat(acc_avg)) * dt3
    fx[:, 6:9, 12:15] = -rot_in * dt3
    fx[:, 6:9, 15:18] = eye3 * dt3
    dt23 = dt2[:, None, None]
    qw = torch.zeros((k, DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
    qw[:, 0:3, 0:3] = eye3 * (cov_gyr * dt23)
    qw[:, 6:9, 6:9] = rot_in @ (eye3 * cov_acc) @ rot_in.transpose(1, 2) * dt23
    qw[:, 9:12, 9:12] = eye3 * (cov_bias_gyr * dt23)
    qw[:, 12:15, 12:15] = eye3 * (cov_bias_acc * dt23)
    fx_t = fx.transpose(1, 2)

    acc_w_all = (rot_all[1:] @ acc_avg[:, :, None])[:, :, 0] + state.grav
    half_acc = 0.5 * acc_w_all
    acc_dt = acc_w_all * dts[:, None]
    acc_dt2 = half_acc * dt2[:, None]

    cov, pos, vel = state.cov, state.pos, state.vel
    poss, vels = [], []
    for i in range(k):
        cov = fx[i] @ cov @ fx_t[i] + qw[i]
        pos = pos + vel * dts[i] + acc_dt2[i]
        vel = vel + acc_dt[i]
        poss.append(pos)
        vels.append(vel)

    acc_w0 = state.rot @ acc_avg[0] + state.grav
    poses = ImuPoses(
        stamps=window.stamps,
        rot=rot_all,
        pos=torch.stack([state.pos] + poss),
        vel=torch.stack([state.vel] + vels),
        acc_w=torch.cat([acc_w0[None], acc_w_all], dim=0),
        gyr_b=torch.cat([gyr_avg, gyr_avg[-1:]], dim=0),
    )

    # Extrapolate from the last valid sample to t_end.
    n_valid = torch.sum(window.mask.to(torch.int64))
    last = torch.clamp(n_valid - 1, min=0)
    lm1 = torch.clamp(last - 1, min=0)
    dt_e = t_end - _take(window.stamps, last)
    rot_l = _take(poses.rot, last)
    pos_l = _take(poses.pos, last)
    vel_l = _take(poses.vel, last)
    acc_l = _take(poses.acc_w, lm1 + 1)
    gyr_l = _take(gyr_avg, lm1)

    new_state = NavState(
        rot=rot_l @ so3.exp(gyr_l * dt_e),
        pos=pos_l + vel_l * dt_e + 0.5 * acc_l * dt_e * dt_e,
        vel=vel_l + acc_l * dt_e,
        bg=state.bg,
        ba=state.ba,
        grav=state.grav,
        cov=cov,
    )
    return new_state, poses


def undistort(
    points: torch.Tensor,
    t_offs: torch.Tensor,
    mask: torch.Tensor,
    poses: ImuPoses,
    state_end: NavState,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
) -> torch.Tensor:
    """Motion-compensate LiDAR points to the window-end LiDAR frame: each
    point finds its bracketing IMU pose by `searchsorted` and applies the
    constant-acceleration interpolation."""
    m = poses.stamps.shape[0]
    idx = torch.clamp(
        torch.searchsorted(poses.stamps, t_offs, right=True) - 1, 0, m - 1
    )
    dt = (t_offs - poses.stamps[idx])[:, None]

    rot_i = poses.rot[idx] @ so3.exp(poses.gyr_b[idx] * dt)
    pos_i = poses.pos[idx] + poses.vel[idx] * dt + 0.5 * poses.acc_w[idx] * dt * dt

    p_imu = points @ rot_il.T + t_il
    p_w = (rot_i @ p_imu[:, :, None])[:, :, 0] + pos_i
    p_end_imu = (p_w - state_end.pos) @ state_end.rot
    p_end = (p_end_imu - t_il) @ rot_il
    return torch.where(mask[:, None], p_end, points)


class StaticInitializer:
    """Host-side static (zero-velocity) IMU initialization in NumPy:
    accumulate samples while stationary, then gravity from the mean accel
    direction, gyro bias from the mean rate, and the accel-norm scale
    G / |mean_acc|."""

    def __init__(self, init_count: int = 50, zero_velocity_thresh: float = 0.05):
        self.init_count = init_count
        self.zero_velocity_thresh = zero_velocity_thresh
        self._acc = []
        self._gyr = []
        self.done = False
        self.mean_acc = np.array([0.0, 0.0, GRAVITY_MS2])
        self.mean_gyr = np.zeros(3)

    def is_static(self, acc_batch: np.ndarray) -> bool:
        """Zero-velocity detection: low spread of the accel norm."""
        norms = np.linalg.norm(acc_batch, axis=-1)
        return bool(np.std(norms) < self.zero_velocity_thresh)

    def push(self, gyr: np.ndarray, acc: np.ndarray) -> bool:
        """Feed one window of samples; returns True once initialized."""
        if self.done:
            return True
        if len(self._acc) > 0 or self.is_static(acc):
            self._acc.append(np.asarray(acc))
            self._gyr.append(np.asarray(gyr))
        total = sum(a.shape[0] for a in self._acc)
        if total >= self.init_count:
            self.mean_acc = np.concatenate(self._acc).mean(axis=0)
            self.mean_gyr = np.concatenate(self._gyr).mean(axis=0)
            self.done = True
        return self.done

    @property
    def acc_scale(self) -> float:
        return float(GRAVITY_MS2 / np.linalg.norm(self.mean_acc))

    def initial_state(self, dtype=torch.float32, device=None) -> NavState:
        """The identity state with the estimated gravity and gyro bias, on
        `device` (None means the GPU)."""
        st = NavState.identity(dtype, device)
        grav = -self.mean_acc / np.linalg.norm(self.mean_acc) * GRAVITY_MS2
        return st._replace(
            grav=torch.tensor(grav, dtype=dtype, device=st.pos.device),
            bg=torch.tensor(self.mean_gyr, dtype=dtype, device=st.pos.device),
        )
