"""Batched SO(3) operations (PyTorch, shape-polymorphic over leading dims).

Port of fastlivo_tpu/ops/so3.py: the same branchless formulas (small-angle
Taylor branches selected with `torch.where`), so the two packages agree to
f32 rounding.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [v]x of v: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _eye_like(m: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) axis-angle -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-10
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    k = hat(w)
    return _eye_like(k) + a[..., None, None] * k + b[..., None, None] * (k @ k)


def exp_scaled(w: torch.Tensor, dt) -> torch.Tensor:
    """exp(w * dt)."""
    dt = torch.as_tensor(dt, dtype=w.dtype, device=w.device)
    return exp(w * dt[..., None])


def log(rot: torch.Tensor) -> torch.Tensor:
    """Logarithm map: (..., 3, 3) rotation -> (..., 3) axis-angle."""
    tr = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)

    w_asym = vee(rot - rot.transpose(-1, -2))  # = 2 sin(theta) * axis

    small = theta < 1e-4
    factor = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t) + _EPS),
    )
    w_generic = factor[..., None] * w_asym

    m = rot + _eye_like(rot)
    diag = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*k.shape, 3, 1)
    col = torch.gather(m, -1, idx)[..., 0]
    axis = col / (torch.linalg.vector_norm(col, dim=-1, keepdim=True) + _EPS)
    sign = torch.where(
        torch.sum(axis * w_asym, dim=-1, keepdim=True) < 0.0, -1.0, 1.0
    )
    w_pi = theta[..., None] * axis * sign

    near_pi = theta > (math.pi - 1e-3)
    return torch.where(near_pi[..., None], w_pi, w_generic)


def rot_to_euler(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> (roll, pitch, yaw), ZYX convention."""
    sy = torch.sqrt(rot[..., 0, 0] ** 2 + rot[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(
        singular,
        torch.atan2(-rot[..., 1, 2], rot[..., 1, 1]),
        torch.atan2(rot[..., 2, 1], rot[..., 2, 2]),
    )
    pitch = torch.atan2(
        -rot[..., 2, 0], torch.where(singular, torch.full_like(sy, 1e-12), sy)
    )
    yaw = torch.where(
        singular, torch.zeros_like(sy), torch.atan2(rot[..., 1, 0], rot[..., 0, 0])
    )
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z): (..., 4) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branchless Shepperd."""
    m = rot
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    q0 = torch.stack(
        [
            safe_sqrt(t0),
            (m[..., 2, 1] - m[..., 1, 2]) / safe_sqrt(t0),
            (m[..., 0, 2] - m[..., 2, 0]) / safe_sqrt(t0),
            (m[..., 1, 0] - m[..., 0, 1]) / safe_sqrt(t0),
        ],
        dim=-1,
    )
    q1 = torch.stack(
        [
            (m[..., 2, 1] - m[..., 1, 2]) / safe_sqrt(t1),
            safe_sqrt(t1),
            (m[..., 0, 1] + m[..., 1, 0]) / safe_sqrt(t1),
            (m[..., 2, 0] + m[..., 0, 2]) / safe_sqrt(t1),
        ],
        dim=-1,
    )
    q2 = torch.stack(
        [
            (m[..., 0, 2] - m[..., 2, 0]) / safe_sqrt(t2),
            (m[..., 0, 1] + m[..., 1, 0]) / safe_sqrt(t2),
            safe_sqrt(t2),
            (m[..., 1, 2] + m[..., 2, 1]) / safe_sqrt(t2),
        ],
        dim=-1,
    )
    q3 = torch.stack(
        [
            (m[..., 1, 0] - m[..., 0, 1]) / safe_sqrt(t3),
            (m[..., 2, 0] + m[..., 0, 2]) / safe_sqrt(t3),
            (m[..., 1, 2] + m[..., 2, 1]) / safe_sqrt(t3),
            safe_sqrt(t3),
        ],
        dim=-1,
    )
    ts = torch.stack([t0, t1, t2, t3], dim=-1)
    best = torch.argmax(ts, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(qs, -2, idx)[..., 0, :]
    q = q * 0.5
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
