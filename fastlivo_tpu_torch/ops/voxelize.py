"""Voxel-grid downsampling with fixed-shape output (port of
fastlivo_tpu/ops/voxelize.py)."""

from __future__ import annotations

from typing import Tuple

import torch

from fastlivo_tpu_torch.ops.scatter import segment_sum_sorted

_SENTINEL = torch.iinfo(torch.int32).max


def lexsort3(k0: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (k0, k1, k2) lexicographically, ties in
    original order — `jnp.lexsort((k2, k1, k0))`. Three stable sorts,
    least significant key first."""
    order = torch.sort(k2, stable=True).indices
    order = order[torch.sort(k1[order], stable=True).indices]
    order = order[torch.sort(k0[order], stable=True).indices]
    return order


def voxel_downsample(
    pts: torch.Tensor,
    mask: torch.Tensor,
    leaf: float,
    out_size: int,
    counted: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Centroid voxel-grid filter: the first `out_size` voxels in
    lexicographic voxel order are kept. Returns (out_pts (out_size, 3),
    out_mask (out_size,)), and with `counted` also the number of occupied
    voxels past `out_size` that it left out (a device int32 scalar, no
    host read)."""
    vox = torch.floor(pts / leaf).to(torch.int32)
    vox = torch.where(mask[:, None], vox, _SENTINEL)

    order = lexsort3(vox[:, 0], vox[:, 1], vox[:, 2])
    vox_s = vox[order]
    pts_s = pts[order]
    mask_s = mask[order]

    is_start = torch.cat(
        [
            torch.ones((1,), dtype=torch.bool, device=pts.device),
            torch.any(vox_s[1:] != vox_s[:-1], dim=-1),
        ]
    )
    is_start = is_start & mask_s
    seg_id = torch.cumsum(is_start.to(torch.int32), dim=0, dtype=torch.int32) - 1
    seg_id = torch.where(mask_s & (seg_id >= 0), seg_id, out_size)

    # Masked points sort last (sentinel key) and ids past out_size only
    # grow, so seg_id is nondecreasing: a sorted-segment reduction applies.
    sums = segment_sum_sorted(
        torch.where(mask_s[:, None], pts_s, 0.0), seg_id, out_size
    )
    cnts = segment_sum_sorted(mask_s.to(pts.dtype), seg_id, out_size)

    out_mask = cnts > 0
    out_pts = sums / torch.clamp(cnts, min=1.0)[:, None]
    out_pts = torch.where(out_mask[:, None], out_pts, 0.0)
    if not counted:
        return out_pts, out_mask
    return out_pts, out_mask, torch.clamp(torch.sum(is_start, dtype=torch.int32) - out_size, min=0)
