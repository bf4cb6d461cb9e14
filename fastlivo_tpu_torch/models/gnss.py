"""GNSS fusion: RTK ingestion, trajectory alignment, ESKF position updates
(port of fastlivo_tpu/models/gnss.py).

- `parse_rtk_file`, `GnssSample` and the host bookkeeping of `GnssFusion`
  are the JAX package's NumPy code;
- `observation_block` builds the (18,18)/(18,) innovation blocks that
  `lio_update` adds through `extra_hth`/`extra_hty`, on the device of its
  inputs;
- `align_trajectory` is the same yaw + antenna-lever Gauss-Newton with
  Huber weights; `torch.func.jacrev` replaces `jax.jacobian`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.ops import earth, so3
from fastlivo_tpu_torch.state import DIM_STATE


@dataclass
class GnssSample:
    time: float  # unix seconds
    ecef: np.ndarray  # (3,)
    std_enu: np.ndarray  # (3,)


def parse_rtk_file(path: str) -> List[GnssSample]:
    """Parse the reference's RTK result format (header until END_HEAD, then
    named columns; only ambiguity-fixed rows AR >= 3 are kept)."""
    samples: List[GnssSample] = []
    with open(path) as f:
        lines = f.readlines()
    i = 0
    while i < len(lines) and "END_HEAD" not in lines[i]:
        i += 1
    if i + 2 >= len(lines):
        return samples
    header = lines[i + 2].split()
    offsets = {"Week": 1, "GPSTime": 1, "X-ECEF": 1, "Y-ECEF": 1, "Z-ECEF": 1,
               "SD-E": 5, "SD-N": 5, "SD-U": 5, "AR": 5}
    cols = {}
    for c, name in enumerate(header):
        if name in offsets:
            cols[name] = c + offsets[name]
    required = ["Week", "GPSTime", "X-ECEF", "Y-ECEF", "Z-ECEF", "SD-E", "SD-N", "SD-U", "AR"]
    if any(k not in cols for k in required):
        return samples
    for line in lines[i + 4:]:
        v = line.split()
        if len(v) <= max(cols.values()):
            continue
        try:
            ar = int(float(v[cols["AR"]]))
            if ar < 3:
                continue
            samples.append(
                GnssSample(
                    time=earth.gps2unix(int(v[cols["Week"]]), float(v[cols["GPSTime"]])),
                    ecef=np.array([float(v[cols[k]]) for k in ("X-ECEF", "Y-ECEF", "Z-ECEF")]),
                    std_enu=np.array([float(v[cols[k]]) for k in ("SD-E", "SD-N", "SD-U")]),
                )
            )
        except ValueError:
            continue
    return samples


_RTK_HEADER = "Data Week GPSTime X-ECEF Y-ECEF Z-ECEF SD-E SD-N SD-U AR"


def write_rtk_file(path: str, samples: List[GnssSample], ar: int = 5) -> None:
    """Write samples in the format `parse_rtk_file` reads (every row with
    ambiguity ratio `ar`): a header ending in END_HEAD, the column names,
    a units line, then one row per sample. Each value sits where the
    parser's per-column offsets look for it."""
    lines = ["% RTK solution", "END_HEAD", "", _RTK_HEADER, "%"]
    for s in samples:
        week, sow = divmod(s.time - earth.GPS_EPOCH_UNIX + earth.GPS_LEAP_SECOND, 604800.0)
        x, y, z = (f"{v:.4f}" for v in s.ecef)
        e, n, u = (f"{v:.6f}" for v in s.std_enu)
        lines.append(" ".join(["D", "-", str(int(week)), f"{sow:.6f}", x, y, z,
                               "0", "0", "0", "0", e, n, u, str(ar)]))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def observation_block(
    rot: torch.Tensor,
    pos: torch.Tensor,
    gnss_pos_world: torch.Tensor,
    std_enu: torch.Tensor,
    antlever: torch.Tensor,
    outlier_gate_m: float = 2.0,
    up_weight: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-dof position observation -> (extra_hth (18,18), extra_hty (18,)).

    Measurement model: z_gnss = p + R * lever (antenna position in world).
    Innovation err = z - p - R*lever; H = [ -R [lever]x , I, 0.. ];
    accumulate H^T W err / H^T W H. (The reference's published H block uses
    [R[l]x, -I] against err = z - p + R*lever, which is sign-inconsistent;
    this is the JAX package's form.) W = diag(1/sd_e, 1/sd_n, up_weight/sd_u),
    zeroed when |err| > gate.
    """
    dtype, dev = pos.dtype, pos.device
    err = gnss_pos_world - pos - rot @ antlever
    ok = torch.linalg.vector_norm(err) <= outlier_gate_m

    h = torch.zeros((3, 6), dtype=dtype, device=dev)
    h[:, 0:3] = -(rot @ so3.hat(antlever))
    h[:, 3:6] = torch.eye(3, dtype=dtype, device=dev)
    w = torch.where(
        ok,
        torch.stack([1.0 / std_enu[0], 1.0 / std_enu[1], up_weight / std_enu[2]]).to(dtype),
        torch.zeros(3, dtype=dtype, device=dev),
    )
    hth = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
    hty = torch.zeros((DIM_STATE,), dtype=dtype, device=dev)
    hth[0:6, 0:6] = h.T @ (w[:, None] * h)
    hty[0:6] = h.T @ (w * err)
    return hth, hty


def align_trajectory(
    odo_pos: np.ndarray,
    odo_rot: np.ndarray,
    gnss_enu: np.ndarray,
    std_enu: np.ndarray,
    iters: int = 10,
    huber_delta: float = 1.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the ENU->world rotation (yaw only: both frames are
    gravity-aligned) and the antenna lever by Gauss-Newton with Huber
    weights, in f32.

    residual_i = R_we @ p_gnss_enu_i - (p_odo_i + R_i @ lever)

    Returns (rot_we (3,3), lever (3,)) as NumPy arrays.
    """
    f32 = dict(dtype=torch.float32, device=_device.resolve(device))
    odo_pos_t = torch.as_tensor(np.asarray(odo_pos, np.float32), **f32)
    odo_rot_t = torch.as_tensor(np.asarray(odo_rot, np.float32), **f32)
    gnss = torch.as_tensor(np.asarray(gnss_enu, np.float32), **f32)
    w0 = torch.as_tensor(np.asarray(1.0 / np.maximum(std_enu, 1e-3), np.float32), **f32)

    # Yaw seed from the endpoint displacement directions (host, as in JAX).
    gv = (gnss[-1] - gnss[0]).cpu().numpy()
    ov = (odo_pos_t[-1] - odo_pos_t[0]).cpu().numpy()
    gv2, ov2 = gv[:2], ov[:2]
    yaw = float(
        np.arctan2(ov2[1], ov2[0]) - np.arctan2(gv2[1], gv2[0])
    ) if np.linalg.norm(gv2) > 1e-6 and np.linalg.norm(ov2) > 1e-6 else 0.0
    z_axis = torch.tensor([0.0, 0.0, 1.0], **f32)
    r0 = so3.exp(torch.tensor([0.0, 0.0, yaw], **f32))

    def residuals(r_we, lever):
        pred = gnss @ r_we.T
        tgt = odo_pos_t + torch.einsum("nij,j->ni", odo_rot_t, lever)
        return (pred - tgt) * w0

    def gn_step(r_we, lever):
        def res_flat(dx):
            r = r_we @ so3.exp(z_axis * dx[0])
            return residuals(r, lever + dx[1:4]).reshape(-1)

        zero = torch.zeros(4, **f32)
        r = res_flat(zero)
        j = torch.func.jacrev(res_flat)(zero)
        rn = torch.linalg.vector_norm(r.reshape(-1, 3), dim=-1)
        hw = torch.clamp(huber_delta / torch.clamp(rn, min=1e-9), max=1.0)
        hw = torch.repeat_interleave(hw, 3)
        jw = j * hw[:, None]
        rw = r * hw
        dx = -torch.linalg.solve(jw.T @ jw + 1e-6 * torch.eye(4, **f32), jw.T @ rw)
        return r_we @ so3.exp(z_axis * dx[0]), lever + dx[1:4]

    r_we, lever = r0, torch.zeros(3, **f32)
    for _ in range(iters):
        r_we, lever = gn_step(r_we, lever)
    return r_we.cpu().numpy(), lever.cpu().numpy()


class GnssFusion:
    """Host-side GNSS front end: buffering, time matching, anchoring,
    initialization, and per-scan observation blocks on `device`."""

    def __init__(
        self,
        antlever: np.ndarray | None = None,
        outlier_gate_m: float = 2.0,
        init_window: int = 20,
        device=None,
    ):
        self.samples: List[GnssSample] = []
        self.anchor_ecef: Optional[np.ndarray] = None
        self.rot_we = np.eye(3)
        self.antlever = np.zeros(3) if antlever is None else np.asarray(antlever)
        self.outlier_gate_m = outlier_gate_m
        self.init_window = init_window
        self.device = _device.resolve(device)
        self.initialized = False
        self._odo_pos: List[np.ndarray] = []
        self._odo_rot: List[np.ndarray] = []
        self._gnss_enu: List[np.ndarray] = []
        self._gnss_std: List[np.ndarray] = []

    def load_rtk_file(self, path: str):
        self.samples = parse_rtk_file(path)

    def push(self, sample: GnssSample):
        self.samples.append(sample)

    def _enu(self, ecef: np.ndarray) -> np.ndarray:
        if self.anchor_ecef is None:
            self.anchor_ecef = np.asarray(ecef, np.float64)
        return earth.ecef2enu(np.asarray(ecef, np.float64), self.anchor_ecef)

    def match(self, t: float, tol: float = 0.05) -> Optional[GnssSample]:
        """Nearest-in-time sample within `tol` seconds."""
        best, bd = None, tol
        for s in self.samples:
            d = abs(s.time - t)
            if d < bd:
                best, bd = s, d
        return best

    def observe(self, t: float, rot: np.ndarray, pos: np.ndarray):
        """Called once per scan with the propagated pose. Returns
        (extra_hth, extra_hty) tensors on the device, or None if no sample
        matches or the alignment has not initialized yet."""
        s = self.match(t)
        if s is None:
            return None
        enu = self._enu(s.ecef)
        if not self.initialized:
            self._odo_pos.append(np.asarray(pos, np.float64))
            self._odo_rot.append(np.asarray(rot, np.float64))
            self._gnss_enu.append(enu)
            self._gnss_std.append(s.std_enu)
            if len(self._odo_pos) >= self.init_window:
                track_len = np.linalg.norm(self._odo_pos[-1] - self._odo_pos[0])
                if track_len > 1.0:  # need excitation for yaw observability
                    self.rot_we, self.antlever = align_trajectory(
                        np.asarray(self._odo_pos),
                        np.asarray(self._odo_rot),
                        np.asarray(self._gnss_enu),
                        np.mean(self._gnss_std, axis=0),
                        device=self.device,
                    )
                    self.initialized = True
            return None

        gnss_world = self.rot_we @ enu

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        return observation_block(
            t(rot), t(pos), t(gnss_world), t(s.std_enu), t(self.antlever), self.outlier_gate_m
        )
