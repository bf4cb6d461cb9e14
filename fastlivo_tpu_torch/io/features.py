"""Optional scan feature extraction (edges / planes) + normal estimation
(host NumPy; a copy of fastlivo_tpu/io/features.py).

Capability parity with the reference's LOAM-style `give_feature` path
(reference: src/preprocess.cpp:683-1002 — per-line curvature windows,
plane_judge :1003, edge_jump_judge :1117) and the range-image normal
extraction behind the NORMAL flag (:130-246). The default reference
configs run raw-point mode (feature_extract_enable: 0), so these are
opt-in here too (`preprocess.feature_extract_en`).

Vectorized NumPy, operating on time-ordered scans: each LiDAR "line" is
treated as the time-ordered point sequence (per-ring splitting happens at
decode time when ring ids are available).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from fastlivo_tpu_torch.io.sensors import LidarScan


def classify_features(
    scan: LidarScan,
    window: int = 5,
    plane_curvature_max: float = 0.01,
    edge_curvature_min: float = 0.1,
    jump_ratio: float = 2.0,
    max_per_segment: int = 20,
    n_segments: int = 6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Classify scan points into plane and edge sets.

    Returns (plane_mask, edge_mask) boolean arrays over scan.pts.

    Method (capability port of give_feature): local curvature over a
    +-window neighborhood along the scan order; low-curvature points are
    surface candidates, high-curvature points with a validated range jump
    (edge_jump_judge: the nearer side must not be occluding) are edge
    candidates; per-segment caps keep the output balanced around the sweep.
    """
    pts = scan.pts
    n = len(pts)
    if n < 2 * window + 1:
        return np.zeros(n, bool), np.zeros(n, bool)

    rng = np.linalg.norm(pts, axis=1)
    # curvature: squared norm of the neighborhood sum minus (2w+1) x self
    # (the LOAM statistic), normalized by the LOCAL sampling scale
    # ((2w+1) x windowed point spacing) so it is dimensionless with respect
    # to both range and point density: a straight segment gives ~0, a sharp
    # corner gives O(1) regardless of how far away or finely sampled it is.
    acc = np.zeros((n, 3))
    for dv in range(-window, window + 1):
        acc += np.roll(pts, dv, axis=0)
    diff = acc - (2 * window + 1) * pts
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    seg = np.concatenate([seg[:1], seg])
    spacing = np.convolve(
        seg, np.ones(2 * window + 1) / (2 * window + 1), mode="same"
    )
    scale = (2 * window + 1) * np.maximum(spacing, 1e-9)
    curv = np.sum(diff**2, axis=1) / scale**2
    curv[:window] = np.inf
    curv[-window:] = np.inf

    # range jumps between consecutive points (for edge validation)
    dr_next = np.abs(np.diff(rng, append=rng[-1]))
    dr_prev = np.abs(np.diff(rng, prepend=rng[0]))
    gap = np.maximum(dr_next, dr_prev)
    # occlusion test: an edge whose far side is >jump_ratio x nearer range
    # step is likely an occlusion boundary, not structure. The whole
    # curvature window around an occlusion is tainted (its curvature spike
    # comes from the jump, not geometry), so dilate the mask by the window
    # (parity with give_feature suppressing jump neighborhoods,
    # preprocess.cpp:1117-1160).
    occluded = gap > jump_ratio * np.minimum(rng, np.roll(rng, -1))
    occ_dilated = occluded.copy()
    for dv in range(-window, window + 1):
        occ_dilated |= np.roll(occluded, dv)

    plane_mask = (curv < plane_curvature_max) & np.isfinite(curv)
    edge_cand = (curv > edge_curvature_min) & np.isfinite(curv) & ~occ_dilated

    # per-segment caps (reference splits each line into 6 segments)
    edge_mask = np.zeros(n, bool)
    seg_len = max(n // n_segments, 1)
    for s in range(0, n, seg_len):
        seg = slice(s, min(s + seg_len, n))
        idx = np.where(edge_cand[seg])[0]
        if len(idx) > max_per_segment:
            order = np.argsort(-curv[seg][idx])[:max_per_segment]
            idx = idx[order]
        edge_mask[np.asarray(seg.start) + idx] = True
    return plane_mask, edge_mask


def estimate_normals(
    pts: np.ndarray, k: int = 8, max_radius: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point normals via local plane fits (capability equivalent of the
    reference's range-image normal extraction, preprocess.cpp:130-246,
    without requiring the ring structure).

    Returns (normals (N,3) unit, valid (N,))."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    d, idx = tree.query(pts, k=k)
    nbr = pts[idx]  # (N, k, 3)
    ok = d[:, -1] < max_radius
    mean = nbr.mean(axis=1, keepdims=True)
    q = nbr - mean
    cov = np.einsum("nki,nkj->nij", q, q) / k
    evals, evecs = np.linalg.eigh(cov)
    normals = evecs[:, :, 0]
    # orient toward the sensor origin
    flip = np.sum(normals * pts, axis=1) > 0
    normals[flip] *= -1
    ok &= evals[:, 0] < 0.25 * np.maximum(evals[:, 1], 1e-12) * 10
    return normals, ok
