"""IMU forward propagation and point undistortion (port of
fastlivo_tpu/models/imu.py).

`propagate` computes the JAX `lax.scan` over the window in one CUDA kernel
for CUDA tensors (`fastlivo_tpu_torch/csrc/imu_propagate.cu`, see the note
there for its design and bound) and with `propagate_plain` for CPU tensors;
there is no fallback between the two. In `propagate_plain` the scan is a
Python loop over the M-1 intervals. Everything that does not depend on the
loop carry (the interval exponentials, the transition blocks once the
rotation chain is known) is computed batched around it, so the loop itself
is a few small kernels per sample: the rotation chain, the covariance
recursion and the position/velocity recursion, each in the JAX order of
operations. It is pure torch on any device, so on the card it is the
kernel's reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch.ops import cuda_build, so3
from fastlivo_tpu_torch.state import DIM_STATE, GRAVITY_MS2, NavState
from fastlivo_tpu_torch.utils import timing


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


def propagate_plain(
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


# (state dtype, window dtype) -> the C entry point's `kind`.
_KINDS = {
    (torch.float32, torch.float32): 0,
    (torch.float64, torch.float64): 1,
    (torch.float64, torch.float32): 2,
}
# Longest window the kernel takes: its shared memory, (13 (M-1) + 12 M +
# 1296) elements of the state's dtype and 4 (M-1) bytes, within the 227 KB
# a Hopper block may use (219,156 bytes in float64 at M = 1024).
MAX_WINDOW = 1024
_STATE_OUT = 15 + DIM_STATE * DIM_STATE  # rot, pos, vel, cov ahead of the pose table

_FN = None


def _kernel_fn():
    """The C entry point `imu_propagate` (csrc/imu_propagate.cu), built and
    loaded at first use, with its argument types set."""
    global _FN
    if _FN is None:
        fn = cuda_build.load("imu_propagate").imu_propagate
        fn.argtypes = (
            [ctypes.c_int]  # kind
            + [ctypes.c_void_p] * 13  # rot, pos, vel, bg, ba, grav, cov, stamps, gyr, acc, mask, t_end, acc_scale
            + [ctypes.c_int]  # m
            + [ctypes.c_double] * 4  # cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc
            + [ctypes.c_void_p] * 2  # out, stream
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(state: NavState, window: ImuWindow, t_end: torch.Tensor, acc_scale: torch.Tensor) -> int:
    """The kernel's `kind` for these inputs; raises ValueError on what the
    kernel does not take: a dtype pair outside `_KINDS`, a shape other than
    NavState's and ImuWindow's, a window outside [2, MAX_WINDOW], a tensor
    on another device than state.pos, or one not contiguous."""
    dtype, wdtype = state.pos.dtype, window.stamps.dtype
    kind = _KINDS.get((dtype, wdtype))
    if kind is None:
        raise ValueError(f"imu_propagate: state {dtype} with window {wdtype} is not supported")
    m = window.stamps.shape[0] if window.stamps.dim() == 1 else 0
    if not 2 <= m <= MAX_WINDOW:
        raise ValueError(f"imu_propagate: window stamps must be (M,), 2 <= M <= {MAX_WINDOW}, "
                         f"got {tuple(window.stamps.shape)}")
    v3 = (3,)
    expect = (
        ("rot", state.rot, (3, 3), dtype), ("pos", state.pos, v3, dtype), ("vel", state.vel, v3, dtype),
        ("bg", state.bg, v3, dtype), ("ba", state.ba, v3, dtype), ("grav", state.grav, v3, dtype),
        ("cov", state.cov, (DIM_STATE, DIM_STATE), dtype), ("stamps", window.stamps, (m,), wdtype),
        ("gyr", window.gyr, (m, 3), wdtype), ("acc", window.acc, (m, 3), wdtype),
        ("mask", window.mask, (m,), torch.bool), ("t_end", t_end, (), wdtype),
        ("acc_scale", acc_scale, (), wdtype),
    )
    dev = state.pos.device
    for name, t, shape, want in expect:
        if t.shape != shape or t.dtype != want:
            raise ValueError(f"imu_propagate: {name} must be {shape} {want}, got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"imu_propagate: {name} is on {t.device}, state.pos on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"imu_propagate: {name} must be contiguous")
    return kind


def _launch(state, window, t_end, acc_scale, cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc):
    """One kernel launch on the current stream for CUDA inputs: the new
    state and the pose table as views of one output buffer (the state's
    bg, ba, grav and the window's stamps are the inputs themselves, as in
    propagate_plain)."""
    kind = _check(state, window, t_end, acc_scale)
    dev = state.pos.get_device()
    if dev != torch.cuda.current_device():
        raise ValueError(f"imu_propagate: inputs on cuda:{dev}, current device cuda:{torch.cuda.current_device()}")
    m = window.stamps.shape[0]
    out = torch.empty(_STATE_OUT + 21 * m, dtype=state.pos.dtype, device=state.pos.device)
    err = _kernel_fn()(
        kind, state.rot.data_ptr(), state.pos.data_ptr(), state.vel.data_ptr(), state.bg.data_ptr(),
        state.ba.data_ptr(), state.grav.data_ptr(), state.cov.data_ptr(), window.stamps.data_ptr(),
        window.gyr.data_ptr(), window.acc.data_ptr(), window.mask.data_ptr(), t_end.data_ptr(),
        acc_scale.data_ptr(), m, cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if err != 0:
        raise RuntimeError(f"imu_propagate kernel launch failed: cudaError {err}")
    timing.count_launch("imu_propagate.launches")
    rot, pos, vel, cov, p_rot, p_pos, p_vel, p_acc, p_gyr = torch.split(
        out, (9, 3, 3, DIM_STATE * DIM_STATE, 9 * m, 3 * m, 3 * m, 3 * m, 3 * m)
    )
    new_state = NavState(
        rot=rot.view(3, 3), pos=pos, vel=vel, bg=state.bg, ba=state.ba, grav=state.grav,
        cov=cov.view(DIM_STATE, DIM_STATE),
    )
    poses = ImuPoses(
        stamps=window.stamps, rot=p_rot.view(m, 3, 3), pos=p_pos.view(m, 3), vel=p_vel.view(m, 3),
        acc_w=p_acc.view(m, 3), gyr_b=p_gyr.view(m, 3),
    )
    return new_state, poses


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
    """Propagate nominal state + covariance through the IMU window to t_end:
    one kernel launch for CUDA tensors, `propagate_plain` for CPU tensors."""
    if state.pos.is_cuda:
        return _launch(state, window, t_end, acc_scale, cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc)
    if state.pos.device.type == "cpu":
        return propagate_plain(state, window, t_end, acc_scale, cov_gyr, cov_acc, cov_bias_gyr, cov_bias_acc)
    raise ValueError(f"propagate: unsupported device {state.pos.device}")


def undistort(
    points: torch.Tensor,
    t_offs: torch.Tensor,
    mask: torch.Tensor,
    poses: ImuPoses,
    state_end: NavState,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    imu_mask: torch.Tensor,
) -> torch.Tensor:
    """Motion-compensate LiDAR points to the window-end LiDAR frame: each
    point finds the last IMU pose at or before it by `searchsorted` and
    moves on from it with the rate and acceleration of the interval that
    pose starts (FAST-LIO's pairing); a point past the window's last valid
    sample (`imu_mask`, the window's) moves on with the last interval's.

    `ImuPoses` pairs slot j with the rate of interval j (`gyr_b[j]`) and
    the acceleration of interval j - 1 (`acc_w[j]`), so the acceleration
    is read one slot on."""
    stamps = poses.stamps
    last = torch.clamp(torch.sum(imu_mask.to(torch.int64), dim=0, keepdim=True) - 1, min=0)
    idx = torch.minimum(torch.clamp(torch.searchsorted(stamps, t_offs, right=True) - 1, min=0), last)
    dt = (t_offs - stamps[idx])[:, None]
    rate = poses.gyr_b[torch.clamp(torch.minimum(idx, last - 1), min=0)]
    acc = poses.acc_w[torch.minimum(idx + 1, last)]

    rot_i = poses.rot[idx] @ so3.exp(rate * dt)
    pos_i = poses.pos[idx] + poses.vel[idx] * dt + 0.5 * acc * dt * dt

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
