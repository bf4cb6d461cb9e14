"""Image operations (port of fastlivo_tpu/ops/image.py): the window-based
samplers, the pyramid and the dense Shi-Tomasi map of the photometric VIO
path, `bilinear`, `extract_patches` and `shi_tomasi_at` for the classical
loop-gate matchers, and the JAX package's compat entries
`patch_residual_grad` and `shi_tomasi` (sparse, per center).

Convention: images are (H, W) float32; pixel coords are (u, v) = (col,
row); all samplers take flat (..., 2) pixel arrays.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from fastlivo_tpu_torch.ops import pallas_windows, patch_sample


def bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample img (H, W) at uv (..., 2); zero outside."""
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    u0i = u0.to(torch.int32)
    v0i = v0.to(torch.int32)

    def tap(du, dv):
        ui = u0i + du
        vi = v0i + dv
        ok = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        val = img[torch.clamp(vi, 0, h - 1).long(), torch.clamp(ui, 0, w - 1).long()]
        return torch.where(ok, val, 0.0)

    return (
        tap(0, 0) * (1 - fu) * (1 - fv)
        + tap(1, 0) * fu * (1 - fv)
        + tap(0, 1) * (1 - fu) * fv
        + tap(1, 1) * fu * fv
    )


def patch_grid(patch_size: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(patch_size^2, 2) offsets (u=col, v=row) centered at the patch
    middle, row-major."""
    half = patch_size // 2
    r = torch.arange(patch_size, dtype=dtype, device=device) - half
    vv, uu = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)


def _patch_uv(img, centers, patch_size, scale):
    """Patch lattice anchored at floor(center/scale)*scale and stepped by
    `scale` (a number or a per-point (N,) tensor)."""
    s = torch.as_tensor(scale, dtype=img.dtype, device=img.device)
    s = torch.broadcast_to(s, centers.shape[:-1])[..., None]  # (N, 1)
    base = torch.floor(centers / s) * s
    sub = (centers - base) / s
    grid = patch_grid(patch_size, img.dtype, img.device)  # (K, 2)
    uv = base[:, None, :] + (grid[None, :, :] + sub[:, None, :]) * s[:, None, :]
    return uv, s


def extract_patches(img: torch.Tensor, centers: torch.Tensor, patch_size: int, scale) -> torch.Tensor:
    """(N, 2) centers -> (N, patch_size^2) intensities on the reference's
    getpatch lattice (every texel shares the center's subpixel fraction)."""
    uv, _ = _patch_uv(img, centers, patch_size, scale)
    return bilinear(img, uv)


def patch_residual_grad(
    img: torch.Tensor, centers: torch.Tensor, patch_size: int, scale
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intensity and central-difference gradients on the getpatch lattice:
    (intensity (N, K), du (N, K), dv (N, K)), K = patch_size^2, gradients
    in full-resolution pixel units (divided by the scale)."""
    uv, s = _patch_uv(img, centers, patch_size, scale)
    val = bilinear(img, uv)
    zero = torch.zeros_like(s)
    off_u = torch.cat([s, zero], dim=-1)[:, None, :]
    off_v = torch.cat([zero, s], dim=-1)[:, None, :]
    du = 0.5 * (bilinear(img, uv + off_u) - bilinear(img, uv - off_u)) / s
    dv = 0.5 * (bilinear(img, uv + off_v) - bilinear(img, uv - off_v)) / s
    return val, du, dv


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
    lattice and the padding rule). One launch of the fused kernel for CUDA
    tensors, its plain version for CPU tensors (ops/patch_sample.py).

    Returns val or (val, du, dv), each (N, patch_size^2), row-major.
    """
    return patch_sample.patch_sample(
        img_pad, centers, strides, patch_size, pad, stride_set, grad_units
    )


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
    u0 = torch.clamp(torch.floor(u), 0, s - 2)
    v0 = torch.clamp(torch.floor(v), 0, s - 2)
    fu = (u - u0).to(patches.dtype)
    fv = (v - v0).to(patches.dtype)
    flat = patches.reshape(n, s * s)
    # A NaN coordinate (a degenerate warp) reads texel 0 with NaN weights,
    # so its sample is NaN, as the JAX one-hot matvec gives.
    idx = (torch.nan_to_num(v0) * s + torch.nan_to_num(u0)).to(torch.int64)  # (N, K)

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


def shi_tomasi_at(img: torch.Tensor, centers: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Shi-Tomasi scores at scattered (N, 2) centers: the dense map and
    one gather per point."""
    dense = shi_tomasi_dense(img, halfbox)
    h, w = img.shape
    u = torch.clamp(torch.floor(centers[:, 0]).to(torch.int32), 0, w - 1).long()
    v = torch.clamp(torch.floor(centers[:, 1]).to(torch.int32), 0, h - 1).long()
    return dense[v, u]


def shi_tomasi(img: torch.Tensor, centers: torch.Tensor, halfbox: int = 4) -> torch.Tensor:
    """Shi-Tomasi score (smaller eigenvalue of the gradient Gram / (2 area))
    at (N, 2) centers: bilinear central differences over the (2 halfbox)^2
    box from floor(center) - halfbox."""
    box = 2 * halfbox
    r = torch.arange(box, dtype=img.dtype, device=img.device) - halfbox
    yy, xx = torch.meshgrid(r, r, indexing="ij")
    grid = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)  # (B, 2)
    uv = torch.floor(centers)[:, None, :] + grid[None, :, :]
    off_u = torch.tensor([1.0, 0.0], dtype=img.dtype, device=img.device)
    off_v = torch.tensor([0.0, 1.0], dtype=img.dtype, device=img.device)
    dx = 0.5 * (bilinear(img, uv + off_u) - bilinear(img, uv - off_u))
    dy = 0.5 * (bilinear(img, uv + off_v) - bilinear(img, uv - off_v))
    dxx = torch.sum(dx * dx, dim=-1)
    dyy = torch.sum(dy * dy, dim=-1)
    dxy = torch.sum(dx * dy, dim=-1)
    area = box * box
    return 0.5 * (dxx + dyy - torch.sqrt((dxx - dyy) ** 2 + 4.0 * dxy**2)) / area
