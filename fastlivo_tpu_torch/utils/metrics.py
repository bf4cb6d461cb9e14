"""Trajectory evaluation: ATE and RPE (a copy of fastlivo_tpu/utils/metrics.py)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst (Umeyama)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    scale = float(np.trace(np.diag(d) @ s) / xs.var(0).sum()) if with_scale else 1.0
    t = mu_d - scale * rot @ mu_s
    return rot, t, scale


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, align: bool = False) -> float:
    """Absolute trajectory error (RMSE of position residuals)."""
    est = np.asarray(est_pos, np.float64)
    gt = np.asarray(gt_pos, np.float64)
    if align:
        rot, t, s = umeyama_alignment(est, gt)
        est = est @ (s * rot).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=-1))))


def rpe(
    est_pos: np.ndarray,
    est_rot: np.ndarray,
    gt_pos: np.ndarray,
    gt_rot: np.ndarray,
    delta: int = 10,
) -> Tuple[float, float]:
    """Relative pose error over a fixed frame delta. Returns (trans_rmse,
    rot_rmse_rad)."""
    t_errs, r_errs = [], []
    for i in range(len(est_pos) - delta):
        de = est_rot[i].T @ (est_pos[i + delta] - est_pos[i])
        dg = gt_rot[i].T @ (gt_pos[i + delta] - gt_pos[i])
        t_errs.append(np.sum((de - dg) ** 2))
        re = est_rot[i].T @ est_rot[i + delta]
        rg = gt_rot[i].T @ gt_rot[i + delta]
        dr = re.T @ rg
        ang = np.arccos(np.clip((np.trace(dr) - 1) / 2, -1, 1))
        r_errs.append(ang**2)
    return float(np.sqrt(np.mean(t_errs))), float(np.sqrt(np.mean(r_errs)))
