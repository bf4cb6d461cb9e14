"""Frustum / FOV culling (port of fastlivo_tpu/ops/frustum.py).

Capability parity with the reference's FOV_Checker (cone-vs-box tests used
for ikd-Tree map cropping in the legacy node). The hash-arena map does not
need FOV cropping for correctness, but cone culling remains useful for
visualization extracts and bounded republishing. Batched tensor ops on the
inputs' device.
"""

from __future__ import annotations

import math

import torch


def points_in_fov(
    pts: torch.Tensor,
    origin: torch.Tensor,
    axis: torch.Tensor,
    half_angle: float,
    max_dist: float,
) -> torch.Tensor:
    """Mask of points inside a view cone (apex `origin`, direction `axis`,
    aperture 2*half_angle, range max_dist). Parity with check_fov."""
    d = pts - origin
    dist = torch.linalg.vector_norm(d, dim=-1)
    cosang = torch.sum(d * axis, dim=-1) / torch.clamp(dist, min=1e-9)
    return (dist <= max_dist) & (cosang >= math.cos(half_angle))


def boxes_intersect_fov(
    box_min: torch.Tensor,
    box_max: torch.Tensor,
    origin: torch.Tensor,
    axis: torch.Tensor,
    half_angle: float,
    max_dist: float,
) -> torch.Tensor:
    """Conservative cone-vs-AABB test for (..., 3) box corners (parity with
    check_box): a box intersects the cone if its center lies inside the
    cone expanded by the box's bounding-sphere radius."""
    center = 0.5 * (box_min + box_max)
    radius = 0.5 * torch.linalg.vector_norm(box_max - box_min, dim=-1)
    d = center - origin
    dist = torch.linalg.vector_norm(d, dim=-1)
    in_range = dist <= max_dist + radius
    # angular test with the aperture widened by asin(r / dist)
    cosang = torch.sum(d * axis, dim=-1) / torch.clamp(dist, min=1e-9)
    widen = torch.arcsin(torch.clamp(radius / torch.clamp(dist, min=1e-9), 0.0, 1.0))
    ok_angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0)) <= half_angle + widen
    # boxes containing the apex always intersect
    contains = torch.all((origin >= box_min) & (origin <= box_max), dim=-1)
    return contains | (in_range & ok_angle)
