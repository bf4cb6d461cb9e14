"""Batched plane estimation from k nearest neighbors (port of
fastlivo_tpu/ops/plane.py).

Fit n.p + d = 0 through k points by solving the 3x3 normal equations of
A x = -1 (x = n/d) with the adjugate closed form — the JAX package's
operation order, not `torch.linalg.solve`, so the valid bits agree — then
normalize and gate on the largest point-to-plane residual.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-20


def _solve3(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 3x3 solve via the adjugate; returns (x, det)."""
    c00 = a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1]
    c01 = a[..., 1, 2] * a[..., 2, 0] - a[..., 1, 0] * a[..., 2, 2]
    c02 = a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0]
    det = a[..., 0, 0] * c00 + a[..., 0, 1] * c01 + a[..., 0, 2] * c02

    adj = torch.stack(
        [
            torch.stack(
                [
                    c00,
                    a[..., 0, 2] * a[..., 2, 1] - a[..., 0, 1] * a[..., 2, 2],
                    a[..., 0, 1] * a[..., 1, 2] - a[..., 0, 2] * a[..., 1, 1],
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    c01,
                    a[..., 0, 0] * a[..., 2, 2] - a[..., 0, 2] * a[..., 2, 0],
                    a[..., 0, 2] * a[..., 1, 0] - a[..., 0, 0] * a[..., 1, 2],
                ],
                dim=-1,
            ),
            torch.stack(
                [
                    c02,
                    a[..., 0, 1] * a[..., 2, 0] - a[..., 0, 0] * a[..., 2, 1],
                    a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0],
                ],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    x = (adj @ b[..., None])[..., 0] / (det[..., None] + _EPS)
    return x, det


def esti_plane(
    neighbors: torch.Tensor,
    neighbor_valid: torch.Tensor,
    threshold: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit planes through (N, K, 3) neighbor sets; a plane needs all K
    neighbors valid and every residual within `threshold`. Returns
    (normal (N, 3), d (N,), valid (N,)), zeros where invalid."""
    g = neighbors.transpose(-1, -2) @ neighbors  # (N, 3, 3) Gram
    rhs = -torch.sum(neighbors, dim=1)
    x, det = _solve3(g, rhs)

    # Near-singular Grams give inf/NaN: sanitize so they cannot poison the
    # innovation sums downstream, and invalidate.
    finite = torch.all(torch.isfinite(x), dim=-1)
    x = torch.where(finite[..., None], x, 0.0)
    norm = torch.linalg.vector_norm(x, dim=-1)
    normal = x / (norm[..., None] + _EPS)
    d = 1.0 / (norm + _EPS)

    resid = torch.abs((neighbors @ normal[..., None])[..., 0] + d[:, None])
    all_valid = torch.all(neighbor_valid, dim=-1)
    fit_ok = torch.all(resid <= threshold, dim=-1)
    nondegenerate = finite & (torch.abs(det) > 1e-12) & (norm > _EPS)
    valid = all_valid & fit_ok & nondegenerate
    normal = torch.where(valid[..., None], normal, 0.0)
    d = torch.where(valid, d, 0.0)
    return normal, d, valid
