"""Batched plane estimation from k nearest neighbors (port of
fastlivo_tpu/ops/plane.py).

Fit n.p + d = 0 through k points as the least-squares solution of
A x = -1 (x = n/d), then normalize and gate on the largest point-to-plane
residual.

The normal equations are solved about the neighbors' mean c. With
M = sum (p - c)(p - c)^T, A^T A = M + k c c^T and A^T (-1) = -k c, so

    x = -k adj(M) c / (det M + k c^T adj(M) c),

whose denominator is det(A^T A). A LiDAR's neighbors lie a few cm apart and
metres from the origin: there A^T A's condition number reaches 1e7 and
its float32 adjugate (the JAX package's form) loses the normal, while M
holds only the spread and keeps it.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-20


def _adjugate(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 3x3 adjugate and determinant."""
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
    return adj, det


def _solve3(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched 3x3 solve via the adjugate; returns (x, det)."""
    adj, det = _adjugate(a)
    x = (adj @ b[..., None])[..., 0] / (det[..., None] + _EPS)
    return x, det


def esti_plane(
    neighbors: torch.Tensor,
    neighbor_valid: torch.Tensor,
    threshold: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit planes through (N, K, 3) neighbor sets; a plane needs all K
    neighbors valid, det(A^T A) above 1e-12 and every residual within
    `threshold`. Returns (normal (N, 3), d (N,), valid (N,)), zeros where
    invalid."""
    k = neighbors.shape[1]
    c = torch.mean(neighbors, dim=1)
    q = neighbors - c[:, None]
    adj, det_m = _adjugate(q.transpose(-1, -2) @ q)
    u = (adj @ c[..., None])[..., 0]
    det = det_m + k * torch.sum(c * u, dim=-1)  # det(A^T A)
    x = (-k) * u / (det[..., None] + _EPS)

    # Near-singular sets give inf/NaN: sanitize so they cannot poison the
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
