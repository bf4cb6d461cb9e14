"""The 18-dim error-state filter state (port of fastlivo_tpu/state.py).

Error-state ordering:
    [0:3] dtheta (right perturbation)  [3:6] dp  [6:9] dv
    [9:12] dbg  [12:15] dba  [15:18] dg
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.ops import so3

DIM_STATE = 18
INIT_COV = 1e-3
GRAVITY_MS2 = 9.81


class NavState(NamedTuple):
    """Nominal navigation state + covariance, float32 tensors."""

    rot: torch.Tensor  # (3, 3) R_world_imu
    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    grav: torch.Tensor  # (3,)
    cov: torch.Tensor  # (18, 18)

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "NavState":
        dev = _device.resolve(device)
        z = torch.zeros(3, dtype=dtype, device=dev)
        return NavState(
            rot=torch.eye(3, dtype=dtype, device=dev),
            pos=z.clone(),
            vel=z.clone(),
            bg=z.clone(),
            ba=z.clone(),
            grav=torch.tensor([0.0, 0.0, -GRAVITY_MS2], dtype=dtype, device=dev),
            cov=torch.eye(DIM_STATE, dtype=dtype, device=dev) * INIT_COV,
        )


def boxplus(state: NavState, dx: torch.Tensor) -> NavState:
    """state (+) dx; covariance carried through unchanged."""
    return NavState(
        rot=state.rot @ so3.exp(dx[0:3]),
        pos=state.pos + dx[3:6],
        vel=state.vel + dx[6:9],
        bg=state.bg + dx[9:12],
        ba=state.ba + dx[12:15],
        grav=state.grav + dx[15:18],
        cov=state.cov,
    )


def boxminus(a: NavState, b: NavState) -> torch.Tensor:
    """a (-) b -> R^18 with rotation part Log(R_b^T R_a)."""
    return torch.cat(
        [
            so3.log(b.rot.T @ a.rot),
            a.pos - b.pos,
            a.vel - b.vel,
            a.bg - b.bg,
            a.ba - b.ba,
            a.grav - b.grav,
        ]
    )


def flatten_nominal(state: NavState) -> torch.Tensor:
    """The nominal state as a (9 + 3 * 5,) vector (rot as the flattened 3x3)
    for logging and checkpoints."""
    return torch.cat([state.rot.reshape(-1), state.pos, state.vel, state.bg, state.ba, state.grav])
