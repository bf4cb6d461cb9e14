"""Precision and SO(3) for the reference.

`Arith` carries the reference's float type and its matrix product. The
reference proper runs in float64. Its control, the nearest precision below
the configuration's float32 with TF32 off, is `Arith(torch.float32,
tf32=True)`: every matmul rounds its operands to TF32's 10-bit mantissa,
as the card's tensor cores do, and accumulates in float32. The rounding is
done by hand, so the control reads the same on a CPU and on the card.
"""

from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, its mantissa rounded to 10 bits (nearest, ties away)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class Arith:
    def __init__(self, dtype=torch.float64, tf32: bool = False):
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def t(self, x, device=None) -> torch.Tensor:
        """x as a tensor of the reference's float type."""
        return torch.as_tensor(x, device=device).to(self.dtype)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with hat(a) b = a x b."""
    z = torch.zeros_like(w[..., 0])
    x, y, zz = w[..., 0], w[..., 1], w[..., 2]
    return torch.stack(
        [torch.stack([z, -zz, y], -1), torch.stack([zz, z, -x], -1), torch.stack([-y, x, z], -1)], -2
    )


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: the rotation by angle |w| about w / |w|."""
    th = torch.linalg.vector_norm(w, dim=-1)[..., None, None]
    k = hat(w)
    small = th < 1e-6
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th * th / 6.0, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th * th / 24.0, (1.0 - torch.cos(ths)) / (ths * ths))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + a * k + b * (k @ k)


def log(r: torch.Tensor) -> torch.Tensor:
    """The rotation vector of r (angles below pi)."""
    v = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0], r[..., 1, 0] - r[..., 0, 1]], -1)
    s = torch.linalg.vector_norm(v, dim=-1)
    c = 0.5 * (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1.0)
    th = torch.atan2(s, c)
    f = torch.where(s > 1e-12, th / torch.where(s > 1e-12, s, torch.ones_like(s)), torch.ones_like(s))
    return v * f[..., None]
