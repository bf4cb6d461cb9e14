"""Pinhole camera model (port of fastlivo_tpu/ops/camera.py, without
`from_config`, which needs the config module of a later slice)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Pinhole:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 1e-12 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))

    def project(self, p_cam: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (..., 2) (z > 0 assumed)."""
        z = p_cam[..., 2]
        x = p_cam[..., 0] / z
        y = p_cam[..., 1] / z
        if self.has_distortion:
            r2 = x * x + y * y
            radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
            xd = x * radial + 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
            yd = y * radial + self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
            x, y = xd, yd
        return torch.stack([self.fx * x + self.cx, self.fy * y + self.cy], dim=-1)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> unit bearing vectors (..., 3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        if self.has_distortion:
            x0, y0 = x, y
            for _ in range(5):
                r2 = x * x + y * y
                radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
                dx = 2 * self.p1 * x * y + self.p2 * (r2 + 2 * x * x)
                dy = self.p1 * (r2 + 2 * y * y) + 2 * self.p2 * x * y
                x = (x0 - dx) / radial
                y = (y0 - dy) / radial
        f = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    def in_frame(self, uv: torch.Tensor, border: int = 0) -> torch.Tensor:
        return (
            (uv[..., 0] >= border)
            & (uv[..., 0] < self.width - border)
            & (uv[..., 1] >= border)
            & (uv[..., 1] < self.height - border)
        )

    def dpi(self, p_cam: torch.Tensor) -> torch.Tensor:
        """Projection Jacobian d(uv)/d(p_cam): (..., 2, 3), pinhole part."""
        x = p_cam[..., 0]
        y = p_cam[..., 1]
        z_inv = 1.0 / p_cam[..., 2]
        z_inv2 = z_inv * z_inv
        zero = torch.zeros_like(x)
        row0 = torch.stack([self.fx * z_inv, zero, -self.fx * x * z_inv2], dim=-1)
        row1 = torch.stack([zero, self.fy * z_inv, -self.fy * y * z_inv2], dim=-1)
        return torch.stack([row0, row1], dim=-2)
