"""Small dense linear algebra for the filter core (port of
fastlivo_tpu/ops/linalg.py): Jacobi-preconditioned Cholesky solves and the
closed-form 3x3 smallest eigenpair."""

from __future__ import annotations

import math

import torch


def psd_solve(a: torch.Tensor, b: torch.Tensor, jitter: float = 1e-9) -> torch.Tensor:
    """Solve a x = b for symmetric positive-definite a with Jacobi
    preconditioning + Cholesky. b may be a vector or a matrix.

    `cholesky_ex` instead of `cholesky`: the latter reads its info flag
    back to the host on every call."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(a), min=1e-30))
    a_s = a * d[:, None] * d[None, :]
    a_s = a_s + torch.eye(a.shape[0], dtype=a.dtype, device=a.device) * jitter
    chol, _ = torch.linalg.cholesky_ex(a_s)
    if b.ndim == 1:
        y = torch.cholesky_solve((d * b)[:, None], chol)[:, 0]
        return d * y
    y = torch.cholesky_solve(d[:, None] * b, chol)
    return d[:, None] * y


def psd_inverse(a: torch.Tensor, jitter: float = 1e-9) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix (preconditioned)."""
    return psd_solve(a, torch.eye(a.shape[0], dtype=a.dtype, device=a.device), jitter)


def eigh3_smallest(a: torch.Tensor):
    """Smallest eigenvalue + unit eigenvector of batched symmetric 3x3
    matrices in closed form (trigonometric method) — the same formula as
    the JAX package, so the normals agree to f32 rounding.

    Args: a (..., 3, 3) symmetric. Returns (eigval (...,), eigvec (..., 3)).
    """
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = (a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]) / 3.0
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    p1 = a01**2 + a02**2 + a12**2
    d0 = a[..., 0, 0] - q
    d1 = a[..., 1, 1] - q
    d2 = a[..., 2, 2] - q
    p2 = d0**2 + d1**2 + d2**2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    b = (a - q[..., None, None] * eye) / p[..., None, None]
    detb = (
        b[..., 0, 0] * (b[..., 1, 1] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 1])
        - b[..., 0, 1] * (b[..., 1, 0] * b[..., 2, 2] - b[..., 1, 2] * b[..., 2, 0])
        + b[..., 0, 2] * (b[..., 1, 0] * b[..., 2, 1] - b[..., 1, 1] * b[..., 2, 0])
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    m = a - lam[..., None, None] * eye
    c01 = torch.linalg.cross(m[..., 0, :], m[..., 1, :], dim=-1)
    c02 = torch.linalg.cross(m[..., 0, :], m[..., 2, :], dim=-1)
    c12 = torch.linalg.cross(m[..., 1, :], m[..., 2, :], dim=-1)
    n01 = torch.sum(c01**2, dim=-1)
    n02 = torch.sum(c02**2, dim=-1)
    n12 = torch.sum(c12**2, dim=-1)
    best = torch.argmax(torch.stack([n01, n02, n12], dim=-1), dim=-1)
    stacked = torch.stack([c01, c02, c12], dim=-2)
    idx = best[..., None, None].expand(*best.shape, 1, 3)
    v = torch.gather(stacked, -2, idx)[..., 0, :]
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-20)
    return lam, v
