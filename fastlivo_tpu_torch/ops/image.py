"""Image operations for the photometric VIO path (port of
fastlivo_tpu/ops/image.py: the window-based samplers, the pyramid and the
dense Shi-Tomasi map).

Convention: images are (H, W) float32; pixel coords are (u, v) = (col,
row); all samplers take flat (..., 2) pixel arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from fastlivo_tpu_torch.ops import pallas_windows


def patch_grid(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(patch_size^2, 2) offsets (u=col, v=row) centered at the patch
    middle, row-major."""
    half = patch_size // 2
    r = torch.arange(patch_size, dtype=dtype, device=device) - half
    vv, uu = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)


def pad_image(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad an image on all sides."""
    return F.pad(img, (pad, pad, pad, pad))


def extract_windows(
    img_pad: torch.Tensor, origins: torch.Tensor, win: int, pad: int
) -> torch.Tensor:
    """One contiguous (win, win) block per candidate from a padded image.

    origins: (N, 2) int (u, v) top-left corners in UNPADDED pixel
    coordinates; they are clipped to the padded frame exactly as the JAX
    package clips them. A CUDA image goes to the CUDA kernel, a CPU image
    to its plain version (ops/pallas_windows.py).
    """
    hp, wp = img_pad.shape
    ou = torch.clamp(origins[:, 0] + pad, 0, wp - win)
    ov = torch.clamp(origins[:, 1] + pad, 0, hp - win)
    starts = torch.stack([ou, ov], dim=-1).to(torch.int32)
    return pallas_windows.extract_windows(img_pad, starts, win)


def strided_patch_sample(
    img_pad: torch.Tensor,
    centers: torch.Tensor,
    strides: torch.Tensor,
    patch_size: int,
    pad: int,
    stride_set: Tuple[int, ...] = (1, 2, 4),
    grad_units=None,
):
    """Patch (+ optional gradient) bilinear sampling on a stride lattice,
    from one contiguous window per candidate (see the JAX docstring for the
    lattice and the padding rule).

    Returns val or (val, du, dv), each (N, patch_size^2), row-major.
    """
    dtype = img_pad.dtype
    half = patch_size // 2
    g = 0 if grad_units is None else 1
    n_lat = patch_size + 2 * g
    max_s = max(stride_set)
    win = (n_lat - 1) * max_s + 2

    i0 = torch.floor(centers)
    frac = (centers - i0).to(dtype)
    i0 = i0.to(torch.int32)
    origins = i0 - strides[:, None] * (half + g)
    windows = extract_windows(img_pad, origins, win, pad)

    fu = frac[:, 0][:, None, None]
    fv = frac[:, 1][:, None, None]

    def lattice(s: int) -> torch.Tensor:
        span = (n_lat - 1) * s + 1

        def corner(dv, du):
            return windows[:, dv : dv + span : s, du : du + span : s]

        return (
            corner(0, 0) * (1 - fu) * (1 - fv)
            + corner(0, 1) * fu * (1 - fv)
            + corner(1, 0) * (1 - fu) * fv
            + corner(1, 1) * fu * fv
        )

    lat = lattice(stride_set[0])
    for s in stride_set[1:]:
        lat = torch.where((strides == s)[:, None, None], lattice(s), lat)

    n = centers.shape[0]
    val = lat[:, g : g + patch_size, g : g + patch_size].reshape(n, -1)
    if grad_units is None:
        return val
    inv = (1.0 / torch.clamp(grad_units, min=1e-9)).to(dtype)[:, None]
    du = 0.5 * (
        lat[:, g : g + patch_size, 2 : 2 + patch_size]
        - lat[:, g : g + patch_size, 0:patch_size]
    ).reshape(n, -1) * inv
    dv = 0.5 * (
        lat[:, 2 : 2 + patch_size, g : g + patch_size]
        - lat[:, 0:patch_size, g : g + patch_size]
    ).reshape(n, -1) * inv
    return val, du, dv


def sample_patch_grid(patches: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling inside small stored patches.

    patches: (N, S, S); coords: (N, K, 2) texel units, (0, 0) = top-left.
    Samples outside clamp to the border. The JAX package phrases this as a
    one-hot matvec for the TPU's matrix unit; here the four taps are
    gathered directly (same taps and weights; the four-term sum may round
    in another order).
    """
    n, s, _ = patches.shape
    u = torch.clamp(coords[..., 0], 0.0, s - 1.0)
    v = torch.clamp(coords[..., 1], 0.0, s - 1.0)
    u0 = torch.clamp(torch.floor(u), 0, s - 2).to(torch.int64)
    v0 = torch.clamp(torch.floor(v), 0, s - 2).to(torch.int64)
    fu = (u - u0).to(patches.dtype)
    fv = (v - v0).to(patches.dtype)
    flat = patches.reshape(n, s * s)
    idx = v0 * s + u0  # (N, K)

    def tap(off):
        return torch.gather(flat, 1, idx + off)

    return (
        tap(0) * ((1 - fu) * (1 - fv))
        + tap(1) * (fu * (1 - fv))
        + tap(s) * ((1 - fu) * fv)
        + tap(s + 1) * (fu * fv)
    )


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """2x2 average-pool pyramid, level 0 = full resolution (the four taps
    summed in the JAX reduce_window's row-major order)."""
    pyr = [img]
    cur = img
    for _ in range(levels - 1):
        h, w = cur.shape
        c = cur[: h - h % 2, : w - w % 2]
        cur = (((c[0::2, 0::2] + c[0::2, 1::2]) + c[1::2, 0::2]) + c[1::2, 1::2]) * 0.25
        pyr.append(cur)
    return pyr


def shi_tomasi_dense(img: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Dense Shi-Tomasi score map; score[y, x] sums the gradient Gram over
    the window offsets [-halfbox, halfbox) around (x, y)."""
    dx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    dy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    k = 2 * halfbox
    lo, hi = halfbox, k - 1 - halfbox

    def box(a):
        a = F.pad(a, (lo, hi, lo, hi))[None, None]
        return F.avg_pool2d(a, k, stride=1, divisor_override=1)[0, 0]

    dxx = box(dx * dx)
    dyy = box(dy * dy)
    dxy = box(dx * dy)
    area = k * k
    return 0.5 * (dxx + dyy - torch.sqrt((dxx - dyy) ** 2 + 4.0 * dxy**2)) / area
