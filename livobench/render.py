"""The room renderer of the port's synthetic generator, frozen: every
pixel's ray is intersected with the room planes and shaded by a smooth
procedural texture of the world hit point (a copy of
fastlivo_tpu_torch/io/render.py's `texture` and `render_room`)."""

from __future__ import annotations

from typing import Tuple

import torch

from livobench.reference.camera import Pinhole


def texture(p: torch.Tensor) -> torch.Tensor:
    """Smooth multi-scale intensity field over world points (..., 3)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    v = (
        0.45 * torch.sin(2.1 * x + 0.7) * torch.cos(1.7 * y - 0.3)
        + 0.30 * torch.sin(5.3 * y + 1.1 * z)
        + 0.25 * torch.cos(8.9 * x - 4.1 * z + 0.5)
        + 0.20 * torch.sin(17.0 * (x + y) * 0.5)
        + 0.15 * torch.cos(29.0 * (y - z) * 0.5 + 1.3)
    )
    return 128.0 + 95.0 * v / 1.35


def render_room_hits(
    cam: Pinhole,
    rcw: torch.Tensor,
    pcw: torch.Tensor,
    half: float = 10.0,
    floor_z: float = -1.5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Render from a world->camera pose on the device of `rcw`. Returns
    (img (H, W) f32, hits (H, W, 3) world points, valid (H, W))."""
    dev = rcw.device
    uu, vv = torch.meshgrid(
        torch.arange(cam.width, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(cam.height, dtype=torch.float32, device=dev) + 0.5,
        indexing="xy",
    )
    uv = torch.stack([uu, vv], dim=-1).reshape(-1, 2)
    f = cam.unproject(uv)
    d = f @ rcw
    o = -rcw.T @ pcw
    big = 1e9

    def plane_hit(axis: int, value: float):
        dn = d[:, axis]
        t = (value - o[axis]) / torch.where(torch.abs(dn) > 1e-9, dn, 1e-9)
        p = o[None, :] + t[:, None] * d
        others = [i for i in range(3) if i != axis]
        inside = (
            (torch.abs(p[:, others[0]]) <= half + 1e-3)
            & (p[:, 2] >= floor_z - 1e-3)
            & (p[:, 2] <= 12.0)
        )
        if axis != 2:
            second = others[1] if others[1] != 2 else others[0]
            inside = inside & (torch.abs(p[:, second]) <= half + 1e-3)
        ok = (t > 1e-3) & inside
        return torch.where(ok, t, big), p

    ts, ps = [], []
    for axis, value in ((2, floor_z), (0, -half), (0, half), (1, -half), (1, half)):
        t, p = plane_hit(axis, value)
        ts.append(t)
        ps.append(p)
    tstack = torch.stack(ts, dim=0)
    pstack = torch.stack(ps, dim=0)
    best = torch.argmin(tstack, dim=0)
    hit = torch.gather(pstack, 0, best[None, :, None].expand(1, -1, 3))[0]
    tmin = torch.amin(tstack, dim=0)
    ok = tmin < big
    img = torch.where(ok, texture(hit), 0.0)
    h, w = cam.height, cam.width
    return (
        img.reshape(h, w).to(torch.float32),
        hit.reshape(h, w, 3).to(torch.float32),
        ok.reshape(h, w),
    )


def render_room(
    cam: Pinhole,
    rcw: torch.Tensor,
    pcw: torch.Tensor,
    half: float = 10.0,
    floor_z: float = -1.5,
) -> torch.Tensor:
    """Render an (H, W) float32 image of the room from a world->camera pose."""
    img, _, _ = render_room_hits(cam, rcw, pcw, half, floor_z)
    return img
