"""Keyframe pose graph with odometry + loop factors (NumPy/SciPy host code;
the port's own copy of fastlivo_tpu/backend/pose_graph.py).

Capability parity with the reference's GTSAM iSAM2 usage
(reference: src/laser_mapping.cpp — keyframe gating :1118-1131, prior/
between odometry factors with distance-weighted noise :1133-1151, loop
BetweenFactors :1152-1168, incremental solve + trajectory dump
:1170-1221). Graph sizes are tiny (hundreds of keyframes), so instead of
iSAM2's incremental Bayes tree this uses a dense SE(3) Gauss-Newton batch
solve (NumPy) re-run on demand — simpler, deterministic, and fast at this
scale.

Factors:
  prior on pose 0;
  between(i, i+1) from odometry with translation-scaled noise;
  between(i, j) from verified loop closures.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from scipy.spatial.transform import Rotation as _R


def _log(rot: np.ndarray) -> np.ndarray:
    return _R.from_matrix(rot).as_rotvec()


def _exp(w: np.ndarray) -> np.ndarray:
    return _R.from_rotvec(w).as_matrix()


@dataclass
class BetweenFactor:
    i: int
    j: int
    rot: np.ndarray  # R_i_j (j expressed in i)
    trans: np.ndarray
    weight: float = 1.0


@dataclass
class PoseGraph:
    rots: List[np.ndarray] = field(default_factory=list)
    trans: List[np.ndarray] = field(default_factory=list)
    stamps: List[float] = field(default_factory=list)
    odo_factors: List[BetweenFactor] = field(default_factory=list)
    loop_factors: List[BetweenFactor] = field(default_factory=list)

    # ----- construction (keyframe gating mirrors save_keyframe,
    # laser_mapping.cpp:1118-1131) -----

    def maybe_add_keyframe(
        self,
        rot: np.ndarray,
        t: np.ndarray,
        trans_thresh: float = 1.0,
        rot_thresh: float = 0.2,
        stamp: float = 0.0,
    ) -> Optional[int]:
        """Add a keyframe if moved enough since the last one. Returns the
        new keyframe index or None."""
        if self.rots:
            pr, pt = self.rots[-1], self.trans[-1]
            dt = np.linalg.norm(t - pt)
            dr = np.linalg.norm(_log(pr.T @ rot))
            if dt < trans_thresh and dr < rot_thresh:
                return None
        idx = len(self.rots)
        self.rots.append(np.asarray(rot, np.float64).copy())
        self.trans.append(np.asarray(t, np.float64).copy())
        self.stamps.append(float(stamp))
        if idx > 0:
            pr, pt = self.rots[idx - 1], self.trans[idx - 1]
            rel_r = pr.T @ self.rots[idx]
            rel_t = pr.T @ (self.trans[idx] - pt)
            # distance-weighted noise (laser_mapping.cpp:1139-1145)
            w = 1.0 / max(np.linalg.norm(rel_t), 0.1)
            self.odo_factors.append(BetweenFactor(idx - 1, idx, rel_r, rel_t, w))
        return idx

    def add_loop(self, i: int, j: int, rot_ij: np.ndarray, t_ij: np.ndarray, weight: float = 10.0):
        """Loop constraint: pose_j = pose_i * T_ij."""
        self.loop_factors.append(
            BetweenFactor(i, j, np.asarray(rot_ij), np.asarray(t_ij), weight)
        )

    # ----- batch solve -----

    def optimize(
        self, iters: int = 10, huber_delta: float = 0.1
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Gauss-Newton over all poses (pose 0 fixed by a strong prior).

        Loop factors get a Huber robust kernel (IRLS) plus an outlier
        reject-and-resolve pass: loops whose residual at the optimum is
        grossly inconsistent with the consensus are dropped and the graph
        re-solved. A single aliased match must not warp the whole chain —
        the reference leans on its visual match-ratio gate for this
        (laser_mapping.cpp:1314-1322); consensus gating is strictly
        stronger and needs no camera.

        Returns (rots (K,3,3), trans (K,3))."""
        k = len(self.rots)
        if k <= 1 or not (self.odo_factors or self.loop_factors):
            return np.asarray(self.rots), np.asarray(self.trans)

        # Consensus gate BEFORE solving, at the odometry poses: odometry is
        # locally consistent, so each loop's initial residual measures
        # (accumulated drift + loop-transform error). Genuine corrections
        # cluster (drift varies smoothly); a gross outlier stands out from
        # the median. Gating at the optimum would not work — the solver
        # bends the chain to satisfy the outlier.
        loops = list(self.loop_factors)
        if len(loops) >= 3:
            res = []
            for f in loops:
                rr = _log(f.rot.T @ self.rots[f.i].T @ self.rots[f.j])
                rt = self.rots[f.i].T @ (self.trans[f.j] - self.trans[f.i]) - f.trans
                res.append(np.linalg.norm(np.concatenate([rr, rt])))
            res = np.asarray(res)
            thresh = max(4.0 * np.median(res), 2.0 * huber_delta)
            loops = [f for f, r in zip(loops, res) if r <= thresh]

        rots, trans = self._solve(loops, iters, huber_delta)
        return np.asarray(rots), np.asarray(trans)

    def _solve(self, loop_factors, iters: int, huber_delta: float):
        k = len(self.rots)
        rots = [r.copy() for r in self.rots]
        trans = [t.copy() for t in self.trans]
        factors = [(f, False) for f in self.odo_factors] + [
            (f, True) for f in loop_factors
        ]
        for _ in range(iters):
            dim = 6 * k
            h = np.zeros((dim, dim))
            g = np.zeros(dim)
            # strong prior on pose 0
            h[0:6, 0:6] += np.eye(6) * 1e8

            for f, is_loop in factors:
                ri, ti = rots[f.i], trans[f.i]
                rj, tj = rots[f.j], trans[f.j]
                # residuals: r_rot = Log(R_ij^T Ri^T Rj), r_t = Ri^T(tj-ti) - t_ij
                r_rot = _log(f.rot.T @ ri.T @ rj)
                r_tr = ri.T @ (tj - ti) - f.trans
                w = f.weight
                if is_loop:
                    rn = np.linalg.norm(np.concatenate([r_rot, r_tr]))
                    w = w * min(1.0, huber_delta / max(rn, 1e-12)) ** 0.5
                r = np.concatenate([r_rot, r_tr]) * w

                # Jacobians (right perturbation R <- R Exp(dw), t <- t + dt),
                # small-angle approximation of the Log-map derivative.
                j_i = np.zeros((6, 6))
                j_j = np.zeros((6, 6))
                # rotation residual wrt dwi, dwj
                j_i[0:3, 0:3] = -(rj.T @ ri)
                j_j[0:3, 0:3] = np.eye(3)
                # translation residual wrt dwi: d(Ri Exp(dw))^T (tj-ti)
                #   = -[dw]x Ri^T (tj-ti) => J = [Ri^T (tj-ti)]x
                v = ri.T @ (tj - ti)
                j_i[3:6, 0:3] = _hat(v)
                j_i[3:6, 3:6] = -ri.T
                j_j[3:6, 3:6] = ri.T

                j_i *= w
                j_j *= w
                si, sj = 6 * f.i, 6 * f.j
                h[si : si + 6, si : si + 6] += j_i.T @ j_i
                h[sj : sj + 6, sj : sj + 6] += j_j.T @ j_j
                h[si : si + 6, sj : sj + 6] += j_i.T @ j_j
                h[sj : sj + 6, si : si + 6] += j_j.T @ j_i
                g[si : si + 6] += j_i.T @ r
                g[sj : sj + 6] += j_j.T @ r

            dx = np.linalg.solve(h + np.eye(dim) * 1e-6, -g)
            for i in range(k):
                rots[i] = rots[i] @ _exp(dx[6 * i : 6 * i + 3])
                trans[i] = trans[i] + dx[6 * i + 3 : 6 * i + 6]
            if np.linalg.norm(dx) < 1e-8:
                break
        return rots, trans


def _hat(v: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]]
    )
