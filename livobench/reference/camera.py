"""The pinhole camera of the configurations (no lens distortion: both
shipped cameras have none, and `from_params` refuses any)."""

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

    @staticmethod
    def from_params(cam) -> "Pinhole":
        if any(abs(getattr(cam, f"d{i}")) > 0.0 for i in range(5)):
            raise ValueError("the reference's camera has no lens distortion")
        return Pinhole(cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy)

    def project(self, p: torch.Tensor) -> torch.Tensor:
        """Camera-frame points (..., 3) -> pixels (u, v) (..., 2)."""
        return torch.stack([self.fx * p[..., 0] / p[..., 2] + self.cx,
                            self.fy * p[..., 1] / p[..., 2] + self.cy], -1)

    def unproject(self, uv: torch.Tensor) -> torch.Tensor:
        """Pixels (..., 2) -> unit bearings (..., 3)."""
        f = torch.stack([(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy,
                         torch.ones_like(uv[..., 0])], -1)
        return f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)

    def inside(self, uv: torch.Tensor, border: float) -> torch.Tensor:
        return ((uv[..., 0] >= border) & (uv[..., 0] < self.width - border)
                & (uv[..., 1] >= border) & (uv[..., 1] < self.height - border))

    def jacobian(self, p: torch.Tensor) -> torch.Tensor:
        """d(u, v) / d(p), (..., 2, 3)."""
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        o = torch.zeros_like(z)
        return torch.stack([torch.stack([self.fx / z, o, -self.fx * x / (z * z)], -1),
                            torch.stack([o, self.fy / z, -self.fy * y / (z * z)], -1)], -2)
