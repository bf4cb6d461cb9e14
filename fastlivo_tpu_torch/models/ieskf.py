"""The shared iterated error-state Kalman MAP step (port of
fastlivo_tpu/models/ieskf.py)."""

from __future__ import annotations

from typing import Tuple

import torch

from fastlivo_tpu_torch.ops import linalg


def map_step(
    p_inv: torch.Tensor,
    hth: torch.Tensor,
    hty: torch.Tensor,
    vec: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One MAP Gauss-Newton step with prior pull.

    dx = vec + S^-1 (hty - hth vec),  g_mat = S^-1 hth,  S = hth + p_inv.
    """
    s_mat = hth + p_inv
    dx = vec + linalg.psd_solve(s_mat, hty - hth @ vec)
    g_mat = linalg.psd_solve(s_mat, hth)
    return dx, g_mat


def posterior_cov(p: torch.Tensor, g_mat: torch.Tensor) -> torch.Tensor:
    """P <- (I - G) P, symmetrized."""
    cov = (torch.eye(p.shape[0], dtype=p.dtype, device=p.device) - g_mat) @ p
    return 0.5 * (cov + cov.T)
