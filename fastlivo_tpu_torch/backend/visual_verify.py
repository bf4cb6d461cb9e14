"""Visual loop verification (port of fastlivo_tpu/backend/visual_verify.py).

The reference gates STD loop candidates on the SuperPoint+LightGlue match
ratio (>= 0.2) and derives a relative pose from the essential matrix.
Matchers:
- `SuperPointLightGlue`: the learned matcher on the given device, over the
  committed weights (`default_weights_paths`) or any npz pair;
- `PatchMatcher` / `OrientedPatchMatcher`: Shi-Tomasi keypoints on a grid
  with normalized-patch descriptors (the latter resampled along each
  keypoint's dominant gradient direction), NumPy host code over the port's
  image ops.
`essential_pose` is the 8-point RANSAC essential matrix with cheirality
pose recovery (the cv::findEssentialMat / recoverPose replacement).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.ops import image as img_ops
from fastlivo_tpu_torch.ops.camera import Pinhole


@dataclass
class MatchResult:
    pts1: np.ndarray  # (M, 2)
    pts2: np.ndarray  # (M, 2)
    n_keypoints: int  # keypoints detected in image 1 (the ratio denominator)

    @property
    def match_ratio(self) -> float:
        return len(self.pts1) / max(self.n_keypoints, 1)


class PatchMatcher:
    """Grid Shi-Tomasi keypoints + normalized patch descriptors."""

    def __init__(
        self,
        cell: int = 24,
        patch: int = 12,
        max_keypoints: int = 400,
        ratio_test: float = 0.85,
        min_score: float = 5.0,
        device=None,
    ):
        self.device = _device.resolve(device)
        self.cell = cell
        self.patch = patch
        self.max_keypoints = max_keypoints
        self.ratio_test = ratio_test
        self.min_score = min_score

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def keypoints(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape
        b = self.patch
        us, vs = np.meshgrid(
            np.arange(b, w - b, 2), np.arange(b, h - b, 2), indexing="xy"
        )
        cand = np.stack([us.reshape(-1), vs.reshape(-1)], -1).astype(np.float32)
        scores = img_ops.shi_tomasi_at(self._t(img), self._t(cand)).cpu().numpy()
        # per-cell argmax NMS
        cells = (cand[:, 0] // self.cell).astype(int) * 10000 + (
            cand[:, 1] // self.cell
        ).astype(int)
        order = np.lexsort((-scores, cells))
        first = np.concatenate([[True], np.diff(cells[order]) != 0])
        kp = cand[order[first]]
        ks = scores[order[first]]
        keep = ks > self.min_score
        kp, ks = kp[keep], ks[keep]
        if len(kp) > self.max_keypoints:
            kp = kp[np.argsort(-ks)[: self.max_keypoints]]
        return kp

    def describe(self, img: np.ndarray, kp: np.ndarray) -> np.ndarray:
        patches = img_ops.extract_patches(self._t(img), self._t(kp), self.patch, 2).cpu().numpy()
        mu = patches.mean(axis=1, keepdims=True)
        d = patches - mu
        return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-6)

    def match(self, img1: np.ndarray, img2: np.ndarray) -> MatchResult:
        kp1 = self.keypoints(img1)
        kp2 = self.keypoints(img2)
        if len(kp1) < 8 or len(kp2) < 8:
            return MatchResult(np.zeros((0, 2)), np.zeros((0, 2)), len(kp1))
        d1 = self.describe(img1, kp1)
        d2 = self.describe(img2, kp2)
        # cosine similarities via one matmul (descriptors are unit vectors)
        sim = d1 @ d2.T  # (N1, N2)
        best2 = np.argmax(sim, axis=1)
        s_sorted = np.sort(sim, axis=1)
        best, second = s_sorted[:, -1], s_sorted[:, -2]
        best1 = np.argmax(sim, axis=0)
        mutual = best1[best2] == np.arange(len(kp1))
        # Ratio test, but keep near-perfect matches outright: repetitive
        # texture legitimately produces close runner-ups.
        ratio_ok = (second < self.ratio_test * best) | (best > 0.98)
        keep = mutual & ratio_ok & (best > 0.6)
        return MatchResult(kp1[keep], kp2[best2[keep]], len(kp1))


class OrientedPatchMatcher(PatchMatcher):
    """PatchMatcher with per-keypoint orientation normalization: each
    descriptor patch is resampled along the keypoint's dominant gradient
    direction, making matching invariant to in-plane rotation (the
    viewpoint change plain patch correlation fails; learned matchers like
    SuperPoint+LightGlue handle it through training). Orientation
    normalization removes the dominant ambiguity source, so the default
    ratio test is slightly looser than the base matcher's."""

    def __init__(self, ratio_test: float = 0.9, **kw):
        super().__init__(ratio_test=ratio_test, **kw)

    def _orientation(self, img: np.ndarray, kp: np.ndarray) -> np.ndarray:
        gy, gx = np.gradient(img)
        h, w = img.shape
        r = np.arange(-self.patch, self.patch + 1, 2)
        dv, du = np.meshgrid(r, r, indexing="ij")
        cols = np.clip(kp[:, 0:1].astype(int) + du.reshape(-1), 0, w - 1)
        rows = np.clip(kp[:, 1:2].astype(int) + dv.reshape(-1), 0, h - 1)
        sx = gx[rows, cols].sum(axis=1)
        sy = gy[rows, cols].sum(axis=1)
        return np.arctan2(sy, sx)

    def describe(self, img: np.ndarray, kp: np.ndarray) -> np.ndarray:
        theta = self._orientation(img, kp)
        p = self.patch
        h, w = img.shape
        r = (np.arange(p) - p / 2 + 0.5) * 2.0  # stride-2 like the base
        dv, du = np.meshgrid(r, r, indexing="ij")
        du, dv = du.reshape(-1), dv.reshape(-1)
        c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
        us = kp[:, 0:1] + c * du[None, :] - s * dv[None, :]
        vs = kp[:, 1:2] + s * du[None, :] + c * dv[None, :]
        u0 = np.clip(np.floor(us).astype(int), 0, w - 2)
        v0 = np.clip(np.floor(vs).astype(int), 0, h - 2)
        fu = np.clip(us - u0, 0, 1)
        fv = np.clip(vs - v0, 0, 1)
        patches = (
            img[v0, u0] * (1 - fu) * (1 - fv)
            + img[v0, u0 + 1] * fu * (1 - fv)
            + img[v0 + 1, u0] * (1 - fu) * fv
            + img[v0 + 1, u0 + 1] * fu * fv
        )
        mu = patches.mean(axis=1, keepdims=True)
        d = patches - mu
        return d / (np.linalg.norm(d, axis=1, keepdims=True) + 1e-6)


class SuperPointLightGlue:
    """The learned matcher behind PatchMatcher's match() interface. The
    forward passes are `backend/superpoint_lightglue.py`'s modules on
    `device`; `weights_path` is a (superpoint.npz, lightglue.npz) pair.
    Absent weights raise rather than silently degrade."""

    def __init__(self, weights_path: Optional[Tuple[str, str]] = None, device=None,
                 n_layers: Optional[int] = None, **kw):
        self.weights_path = weights_path
        if weights_path is None:
            raise FileNotFoundError(
                "SuperPoint/LightGlue weights not provided: pass "
                "weights_path=(superpoint.npz path, lightglue.npz path), or "
                "use PatchMatcher / OrientedPatchMatcher."
            )
        from fastlivo_tpu_torch import convert
        from fastlivo_tpu_torch.backend import superpoint_lightglue as spl

        sp_path, lg_path = weights_path
        dev = _device.resolve(device)
        sp = convert.superpoint_from_numpy(spl.load_npz(sp_path), device=dev)
        lg = convert.lightglue_from_numpy(spl.load_npz(lg_path), n_layers, device=dev)
        self._impl = spl.SuperPointLightGlueMatcher(sp.eval(), lg.eval(), **kw)

    def match(self, img1: np.ndarray, img2: np.ndarray) -> MatchResult:
        return self._impl.match(img1, img2)


# The committed learned-matcher artifacts, by path from the repository
# root (a data file read, not an import of the JAX package).
WEIGHTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "fastlivo_tpu", "weights",
)


def default_weights_paths() -> Optional[Tuple[str, str]]:
    """The committed weight artifacts, if present."""
    sp = os.path.join(WEIGHTS_DIR, "superpoint_synth.npz")
    lg = os.path.join(WEIGHTS_DIR, "lightglue_synth.npz")
    if os.path.exists(sp) and os.path.exists(lg):
        return sp, lg
    return None


def default_matcher(device=None) -> "PatchMatcher":
    """The learned SuperPoint+LightGlue when weights are committed, else the
    rotation-robust OrientedPatchMatcher. Committed weights that fail to
    load raise: a broken artifact never demotes the gate."""
    paths = default_weights_paths()
    if paths is not None:
        return SuperPointLightGlue(weights_path=paths, device=device)
    return OrientedPatchMatcher(device=device)


def verify_loop(
    img1: np.ndarray,
    img2: np.ndarray,
    matcher: Optional[PatchMatcher] = None,
    min_match_ratio: float = 0.2,
) -> Tuple[bool, MatchResult]:
    """The reference's loop gate (laser_mapping.cpp:1314-1322)."""
    matcher = matcher or PatchMatcher()
    res = matcher.match(img1, img2)
    return res.match_ratio >= min_match_ratio, res


def essential_pose(
    res: MatchResult,
    cam: Pinhole,
    iters: int = 200,
    thresh_px: float = 1.5,
    seed: int = 0,
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """Essential matrix via 8-point RANSAC + cheirality pose recovery
    (the cv::findEssentialMat/recoverPose replacement,
    laser_mapping.cpp:1326-1328). Returns (R, t_unit, inliers) or None."""
    if len(res.pts1) < 8:
        return None
    k_inv = np.array(
        [[1 / cam.fx, 0, -cam.cx / cam.fx], [0, 1 / cam.fy, -cam.cy / cam.fy], [0, 0, 1.0]]
    )
    x1 = (np.concatenate([res.pts1, np.ones((len(res.pts1), 1))], 1) @ k_inv.T)
    x2 = (np.concatenate([res.pts2, np.ones((len(res.pts2), 1))], 1) @ k_inv.T)
    n = len(x1)
    rng = np.random.default_rng(seed)
    thresh = thresh_px / cam.fx

    def solve8(a, b):
        m = np.stack(
            [
                a[:, 0] * b[:, 0], a[:, 1] * b[:, 0], b[:, 0],
                a[:, 0] * b[:, 1], a[:, 1] * b[:, 1], b[:, 1],
                a[:, 0], a[:, 1], np.ones(len(a)),
            ],
            axis=1,
        )
        _, _, vt = np.linalg.svd(m)
        e = vt[-1].reshape(3, 3)
        u, s, vt2 = np.linalg.svd(e)
        return u @ np.diag([1.0, 1.0, 0.0]) @ vt2

    def sampson(e, a, b):
        ex1 = a @ e.T
        etx2 = b @ e
        num = np.sum(b * ex1, axis=1) ** 2
        den = ex1[:, 0] ** 2 + ex1[:, 1] ** 2 + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
        return num / np.maximum(den, 1e-12)

    best_e, best_inl = None, 0
    for _ in range(iters):
        pick = rng.choice(n, 8, replace=False)
        try:
            e = solve8(x1[pick], x2[pick])
        except np.linalg.LinAlgError:
            continue
        inl = sampson(e, x1, x2) < thresh**2
        if inl.sum() > best_inl:
            best_inl, best_e, best_mask = int(inl.sum()), e, inl
    if best_e is None or best_inl < 8:
        return None
    e = solve8(x1[best_mask], x2[best_mask])

    # decompose into 4 (R, t) candidates; pick by cheirality
    u, _, vt = np.linalg.svd(e)
    if np.linalg.det(u) < 0:
        u = -u
    if np.linalg.det(vt) < 0:
        vt = -vt
    w = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    cands = [(u @ w @ vt, u[:, 2]), (u @ w @ vt, -u[:, 2]),
             (u @ w.T @ vt, u[:, 2]), (u @ w.T @ vt, -u[:, 2])]

    def cheirality(rot, t):
        # triangulate midpoints and count points in front of both cameras
        good = 0
        for a, b in zip(x1[best_mask][:50], x2[best_mask][:50]):
            # solve depths: d2 * b = rot @ (d1 * a) + t
            m = np.stack([rot @ a, -b], axis=1)
            d, *_ = np.linalg.lstsq(m, -t, rcond=None)
            if d[0] > 0 and d[1] > 0:
                good += 1
        return good

    rot, t = max(cands, key=lambda rt: cheirality(*rt))
    return rot, t, best_inl
