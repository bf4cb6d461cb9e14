"""STD (Stable Triangle Descriptor) loop closure (port of
fastlivo_tpu/backend/std_loop.py).

The per-keyframe batch work, `fit_voxel_planes` (voxelize the aggregated
key cloud and fit one plane per voxel), runs on the detector's device; the
corners, descriptors, hash database, voting and SVD verification are the
JAX package's NumPy host code.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.maps.voxel_map import voxel_corner
from fastlivo_tpu_torch.ops import linalg
from fastlivo_tpu_torch.ops.scatter import segment_sum_sorted, set_drop
from fastlivo_tpu_torch.ops.voxelize import lexsort3
from fastlivo_tpu_torch.utils.config import LoopParams

_INT32_MAX = torch.iinfo(torch.int32).max
_INT32_MIN = torch.iinfo(torch.int32).min


@dataclass(frozen=True)
class StdConfig:
    voxel_size: float = 2.0
    voxel_init_num: int = 10
    plane_detection_thre: float = 0.01
    plane_merge_normal_thre: float = 0.1
    proj_image_resolution: float = 0.5
    proj_dis_min: float = 0.0
    proj_dis_max: float = 2.0
    corner_thre: float = 10.0
    max_corner_num: int = 100
    non_max_suppression_radius: float = 2.0
    descriptor_near_num: int = 10
    descriptor_min_len: float = 2.0
    descriptor_max_len: float = 50.0
    std_side_resolution: float = 0.2
    skip_near_num: int = 50
    candidate_num: int = 50
    rough_dis_threshold: float = 0.01
    vertex_diff_threshold: float = 0.5
    icp_threshold: float = 0.5
    normal_threshold: float = 0.2
    dis_threshold: float = 0.5
    ds_size: float = 0.25
    max_planes: int = 1024  # static plane-voxel budget of the fit

    @staticmethod
    def from_params(p: LoopParams) -> "StdConfig":
        return StdConfig(
            voxel_size=p.voxel_size,
            voxel_init_num=p.voxel_init_num,
            plane_detection_thre=p.plane_detection_thre,
            plane_merge_normal_thre=p.plane_merge_normal_thre,
            proj_image_resolution=p.proj_image_resolution,
            proj_dis_min=p.proj_dis_min,
            proj_dis_max=p.proj_dis_max,
            corner_thre=p.corner_thre,
            non_max_suppression_radius=p.non_max_suppression_radius,
            descriptor_near_num=p.descriptor_near_num,
            descriptor_min_len=p.descriptor_min_len,
            descriptor_max_len=p.descriptor_max_len,
            std_side_resolution=p.std_side_resolution,
            skip_near_num=p.skip_near_num,
            candidate_num=p.candidate_num,
            rough_dis_threshold=p.rough_dis_threshold,
            vertex_diff_threshold=p.vertex_diff_threshold,
            icp_threshold=p.icp_threshold,
            normal_threshold=p.normal_threshold,
            dis_threshold=p.dis_threshold,
            ds_size=p.ds_size,
        )


# ---------------------------------------------------------------------------
# Device stage: batched voxel plane fitting.
# ---------------------------------------------------------------------------


def fit_voxel_planes(
    pts: torch.Tensor,
    mask: torch.Tensor,
    voxel_size: float,
    max_voxels: int,
    min_points: int = 10,
    plane_thresh: float = 0.01,
) -> Dict[str, torch.Tensor]:
    """Voxelize + per-voxel plane fit as one sort/segment/eigh pass.

    Voxels are numbered in lexicographic order (three stable sorts, as
    `jnp.lexsort`); the ones past the first `max_voxels` are dropped, as
    JAX's segment_sum drops their out-of-range ids. Moments accumulate in
    voxel-local coordinates (the corner shift is exact in f32).

    Returns fixed-shape tensors: coords (V,3) int32 (INT32_MIN where
    empty, JAX's segment_max identity), center (V,3), normal (V,3), min_eig
    (V,), count (V,), is_plane (V,), valid (V,).
    """
    dev, dtype = pts.device, pts.dtype
    vox = torch.floor(pts / voxel_size).to(torch.int32)
    vox = torch.where(mask[:, None], vox, _INT32_MAX)
    order = lexsort3(vox[:, 0], vox[:, 1], vox[:, 2])
    vox_s, pts_s, mask_s = vox[order], pts[order], mask[order]

    is_start = torch.cat(
        [torch.ones((1,), dtype=torch.bool, device=dev), torch.any(vox_s[1:] != vox_s[:-1], dim=-1)]
    ) & mask_s
    seg = torch.cumsum(is_start.to(torch.int32), dim=0, dtype=torch.int32) - 1
    # Masked points sort last, so seg stays nondecreasing; ids >= max_voxels
    # are dropped by the sorted-segment sums.
    seg = torch.where(mask_s & (seg >= 0), seg, max_voxels)

    base = torch.where(mask_s[:, None], voxel_corner(vox_s, voxel_size, dtype), 0.0)
    pts_l = pts_s - base
    w = mask_s.to(dtype)
    cnt = segment_sum_sorted(w, seg, max_voxels)
    s1 = segment_sum_sorted(pts_l * w[:, None], seg, max_voxels)
    outer = pts_l[:, :, None] * pts_l[:, None, :] * w[:, None, None]
    s2 = segment_sum_sorted(outer, seg, max_voxels)
    # Every point of a segment carries the same voxel: its first point's.
    first = set_drop(
        torch.full((max_voxels,), -1, dtype=torch.int64, device=dev),
        torch.where(is_start, seg, max_voxels),
        torch.arange(seg.shape[0], device=dev),
    )
    has = first >= 0
    coords = torch.where(
        has[:, None], vox_s[torch.clamp(first, min=0)], _INT32_MIN
    )

    c = torch.clamp(cnt, min=1.0)
    mean_l = s1 / c[:, None]
    cov = s2 / c[:, None, None] - mean_l[:, :, None] * mean_l[:, None, :]
    cov = cov + torch.eye(3, dtype=dtype, device=dev) * 1e-9
    center = mean_l + voxel_corner(coords, voxel_size, dtype)
    min_eig, normal = linalg.eigh3_smallest(cov)

    valid = cnt >= 1.0
    is_plane = valid & (cnt >= min_points) & (min_eig < plane_thresh)
    return {
        "coords": coords,
        "center": center,
        "normal": normal,
        "min_eig": min_eig,
        "count": cnt,
        "is_plane": is_plane,
        "valid": valid,
    }


# ---------------------------------------------------------------------------
# Host stage: corners, descriptors, database, search.
# ---------------------------------------------------------------------------


def extract_corners(
    pts: np.ndarray, voxels: Dict[str, np.ndarray], cfg: StdConfig
) -> np.ndarray:
    """Corner extraction (capability port of corner_extractor/extract_corner,
    STDesc.cpp:509-783): points of non-plane voxels that lie just off an
    adjacent plane are projected onto it; density peaks of the projected
    image become corners (position = cell centroid reprojected, intensity =
    count, normal = projection plane normal), then radius NMS.

    Returns (K, 7): x, y, z, intensity, nx, ny, nz.
    """
    valid = np.asarray(voxels["valid"])
    coords = np.asarray(voxels["coords"])[valid]
    centers = np.asarray(voxels["center"])[valid]
    normals = np.asarray(voxels["normal"])[valid]
    planes = np.asarray(voxels["is_plane"])[valid]
    counts = np.asarray(voxels["count"])[valid]

    vox_index = {tuple(c): i for i, c in enumerate(coords)}
    pvox = np.floor(pts / cfg.voxel_size).astype(np.int64)

    # Points grouped per voxel.
    from collections import defaultdict as dd

    vox_pts: Dict[int, List[int]] = dd(list)
    for i, c in enumerate(map(tuple, pvox)):
        j = vox_index.get(c)
        if j is not None:
            vox_pts[j].append(i)

    faces = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
    )
    res = cfg.proj_image_resolution
    corners = []
    projected_normals: Dict[int, List[np.ndarray]] = dd(list)

    for j in range(len(coords)):
        if planes[j] or counts[j] <= 10:
            continue
        idx = vox_pts.get(j)
        if not idx:
            continue
        # adjacent plane voxels (6 faces)
        for f in faces:
            nb = vox_index.get(tuple(coords[j] + f))
            if nb is None or not planes[nb]:
                continue
            pn, pc = normals[nb], centers[nb]
            # de-dup projections onto (anti)parallel planes
            # (STDesc.cpp:568-583).
            if any(
                min(np.linalg.norm(pn - q), np.linalg.norm(pn + q)) < 0.5
                for q in projected_normals[j]
            ):
                continue
            projected_normals[j].append(pn)

            p = pts[idx]
            dis = np.abs((p - pc) @ pn)
            keep = (dis >= cfg.proj_dis_min) & (dis <= cfg.proj_dis_max)
            p = p[keep]
            if len(p) <= 5:
                continue
            # plane basis
            x_axis = np.array([1.0, 1.0, 0.0])
            if abs(pn[2]) > 1e-9:
                x_axis[2] = -(pn[0] + pn[1]) / pn[2]
            elif abs(pn[1]) > 1e-9:
                x_axis = np.array([1.0, -pn[0] / pn[1], 0.0])
            else:
                x_axis = np.array([0.0, 1.0, 0.0])
            x_axis /= np.linalg.norm(x_axis)
            y_axis = np.cross(pn, x_axis)
            y_axis /= np.linalg.norm(y_axis)

            q = p - ((p - pc) @ pn)[:, None] * pn  # project onto plane
            u = (q - pc) @ x_axis
            v = (q - pc) @ y_axis
            iu = np.floor((u - u.min()) / res).astype(int)
            iv = np.floor((v - v.min()) / res).astype(int)
            nu, nv = iu.max() + 1, iv.max() + 1
            flat = iu * nv + iv
            cnt2 = np.bincount(flat, minlength=nu * nv).reshape(nu, nv)
            su = np.bincount(flat, weights=u, minlength=nu * nv).reshape(nu, nv)
            sv = np.bincount(flat, weights=v, minlength=nu * nv).reshape(nu, nv)

            # density peaks per 5x5 segment (STDesc.cpp:712-741)
            seg = 5
            for su0 in range(0, nu, seg):
                for sv0 in range(0, nv, seg):
                    blk = cnt2[su0 : su0 + seg, sv0 : sv0 + seg]
                    if blk.size == 0:
                        continue
                    m = blk.max()
                    if m < cfg.corner_thre:
                        continue
                    bi, bj = np.unravel_index(np.argmax(blk), blk.shape)
                    ui, vi = su0 + bi, sv0 + bj
                    mu = su[ui, vi] / cnt2[ui, vi]
                    mv = sv[ui, vi] / cnt2[ui, vi]
                    c3 = pc + mu * x_axis + mv * y_axis
                    corners.append([*c3, m, *pn])

    if not corners:
        return np.zeros((0, 7))
    corners = np.asarray(corners)

    # radius NMS keeping the densest (non_maxi_suppression, :783-823)
    order = np.argsort(-corners[:, 3])
    kept: List[int] = []
    for i in order:
        if all(
            np.linalg.norm(corners[i, :3] - corners[k, :3])
            > cfg.non_max_suppression_radius
            for k in kept
        ):
            kept.append(i)
    corners = corners[kept]
    if len(corners) > cfg.max_corner_num:
        corners = corners[np.argsort(-corners[:, 3])[: cfg.max_corner_num]]
    return corners


@dataclass
class FrameDescriptors:
    frame_id: int
    sides: np.ndarray  # (D, 3) sorted side lengths (scaled)
    verts: np.ndarray  # (D, 3, 3) vertex positions A, B, C
    attached: np.ndarray  # (D, 3) vertex intensities


def build_descriptors(
    corners: np.ndarray, frame_id: int, cfg: StdConfig
) -> FrameDescriptors:
    """Triangle descriptors over k-nearest corner triplets with sorted side
    lengths and side-consistent vertex ordering (build_stdesc,
    STDesc.cpp:824-958)."""
    k = min(cfg.descriptor_near_num, len(corners))
    empty = FrameDescriptors(
        frame_id, np.zeros((0, 3)), np.zeros((0, 3, 3)), np.zeros((0, 3))
    )
    if k < 3:
        return empty
    from scipy.spatial import cKDTree

    pos = corners[:, :3]
    tree = cKDTree(pos)
    _, nbrs = tree.query(pos, k=k)

    seen = set()
    sides_l, verts_l, att_l = [], [], []
    scale = 1.0 / cfg.std_side_resolution
    for i in range(len(corners)):
        for m in range(1, k - 1):
            for n in range(m + 1, k):
                tri = [i, int(nbrs[i, m]), int(nbrs[i, n])]
                p = pos[tri]
                a = np.linalg.norm(p[0] - p[1])
                b = np.linalg.norm(p[0] - p[2])
                c = np.linalg.norm(p[1] - p[2])
                if not (
                    cfg.descriptor_min_len < a < cfg.descriptor_max_len
                    and cfg.descriptor_min_len < b < cfg.descriptor_max_len
                    and cfg.descriptor_min_len < c < cfg.descriptor_max_len
                ):
                    continue
                # vertex opposite the shortest side first, etc.: sort sides
                # ascending; vertex order follows (A opposite the longest?
                # reference assigns via shared-index bookkeeping; equivalent:
                # A = vertex not on the shortest side pairing...).
                # Sides: a = |p0p1|, b = |p0p2|, c = |p1p2|.
                # After ascending sort of (a, b, c), assign vertices so that
                # A is shared by the two shortest, C by the two longest.
                sl = np.array([a, b, c])
                order = np.argsort(sl)
                sl = sl[order]
                key = tuple((sl * 1000).astype(np.int64))
                if key in seen:
                    continue
                seen.add(key)
                side_verts = {0: (0, 1), 1: (0, 2), 2: (1, 2)}
                s_a, s_b, s_c = order  # side indices sorted ascending
                va = set(side_verts[s_a]) & set(side_verts[s_b])
                vb = set(side_verts[s_a]) & set(side_verts[s_c])
                vc = set(side_verts[s_b]) & set(side_verts[s_c])
                ia, ib, ic = va.pop(), vb.pop(), vc.pop()
                verts_l.append(p[[ia, ib, ic]])
                att_l.append(corners[tri][[ia, ib, ic], 3])
                sides_l.append(sl * scale)
    if not sides_l:
        return empty
    return FrameDescriptors(
        frame_id,
        np.asarray(sides_l),
        np.asarray(verts_l),
        np.asarray(att_l),
    )


class StdLoopDetector:
    """Keyframe loop detection: accumulate keyframe clouds, build/search
    descriptors, verify geometrically. Mirrors the reference loop thread's
    use of STDescManager (laser_mapping.cpp:1223-1349)."""

    def __init__(self, cfg: StdConfig, device=None):
        self.cfg = cfg
        self.device = _device.resolve(device)
        self.db: Dict[Tuple[int, int, int], List[Tuple[int, int]]] = defaultdict(list)
        self.frames: List[FrameDescriptors] = []
        self.plane_clouds: List[np.ndarray] = []  # (P, 6) center+normal

    # ----- per-keyframe processing -----

    def process_keyframe(self, cloud: np.ndarray) -> Tuple[FrameDescriptors, np.ndarray]:
        """cloud: (N, 3) world-frame keyframe points. Returns descriptors
        and the plane cloud."""
        pts = torch.as_tensor(np.asarray(cloud, np.float32), device=self.device)
        vox = fit_voxel_planes(
            pts,
            torch.ones(len(cloud), dtype=torch.bool, device=self.device),
            voxel_size=self.cfg.voxel_size,
            max_voxels=self.cfg.max_planes,
            min_points=self.cfg.voxel_init_num,
            plane_thresh=self.cfg.plane_detection_thre,
        )
        vox = {k: v.cpu().numpy() for k, v in vox.items()}
        plane_sel = vox["is_plane"]
        plane_cloud = np.concatenate(
            [vox["center"][plane_sel], vox["normal"][plane_sel]], axis=1
        )
        corners = extract_corners(cloud, vox, self.cfg)
        descs = build_descriptors(corners, len(self.frames), self.cfg)
        return descs, plane_cloud

    def add_frame(self, descs: FrameDescriptors, plane_cloud: np.ndarray):
        """AddSTDescs (STDesc.cpp:355-375): hash by rounded side lengths."""
        fid = len(self.frames)
        descs.frame_id = fid
        for d in range(len(descs.sides)):
            key = tuple(np.round(descs.sides[d]).astype(np.int64))
            self.db[key].append((fid, d))
        self.frames.append(descs)
        self.plane_clouds.append(plane_cloud)

    # ----- search -----

    def search(self, descs: FrameDescriptors):
        """SearchLoop: returns (frame_id, score, rot, t) or None."""
        if len(descs.sides) == 0 or len(self.frames) == 0:
            return None
        cur_id = len(self.frames)

        votes: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for d in range(len(descs.sides)):
            s = descs.sides[d]
            thr = np.linalg.norm(s) * self.cfg.rough_dis_threshold
            base = np.round(s).astype(np.int64)
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        key = (base[0] + dx, base[1] + dy, base[2] + dz)
                        for fid, di in self.db.get(key, []):
                            if cur_id - fid < self.cfg.skip_near_num:
                                continue
                            cand = self.frames[fid]
                            if np.linalg.norm(cand.sides[di] - s) >= thr:
                                continue
                            # relative vertex-attachment gate
                            # (STDesc.cpp:1017-1029).
                            a1 = descs.attached[d]
                            a2 = cand.attached[di]
                            rel = 2.0 * np.linalg.norm(a1 - a2) / max(
                                np.linalg.norm(a1 + a2), 1e-9
                            )
                            if rel >= self.cfg.vertex_diff_threshold:
                                continue
                            votes[fid].append((d, di))

        if not votes:
            return None
        ranked = sorted(votes.items(), key=lambda kv: -len(kv[1]))[
            : self.cfg.candidate_num
        ]

        best = None
        for fid, pairs in ranked:
            out = self._verify(descs, fid, pairs)
            if out is None:
                continue
            score, rot, t, _ = out
            if best is None or score > best[1]:
                best = (fid, score, rot, t)
        if best is not None and best[1] > self.cfg.icp_threshold:
            return best
        return None

    def _verify(self, descs: FrameDescriptors, fid: int, pairs: List[Tuple[int, int]]):
        """candidate_verify (STDesc.cpp:1102-1194): RANSAC-ish over sampled
        triangle correspondences (SVD per sample, consensus on vertex
        distances), then plane-overlap score."""
        cand = self.frames[fid]
        m = len(pairs)
        skip = m // 50 + 1
        sample = pairs[::skip]
        src_v = descs.verts[[p[0] for p in pairs]]  # (M, 3, 3)
        dst_v = cand.verts[[p[1] for p in pairs]]

        best_vote, best_rt = 0, None
        for d, di in sample:
            rot, t = _triangle_svd(descs.verts[d], cand.verts[di])
            pred = src_v @ rot.T + t
            ok = np.all(np.linalg.norm(pred - dst_v, axis=-1) < 3.0, axis=-1)
            vote = int(ok.sum())
            if vote > best_vote:
                best_vote, best_rt = vote, (rot, t)
        if best_vote < 4 or best_rt is None:
            return None
        rot, t = best_rt
        # Refine with Kabsch over ALL consensus vertices (the reference
        # keeps the single-triangle estimate, STDesc.cpp:1160-1186, and
        # exposes PlaneGeomrtricIcp for later refinement; a one-shot
        # all-inlier Kabsch is cheaper and much tighter).
        pred = src_v @ rot.T + t
        ok = np.all(np.linalg.norm(pred - dst_v, axis=-1) < 3.0, axis=-1)
        if ok.sum() >= 2:
            rot, t = _triangle_svd(
                src_v[ok].reshape(-1, 3), dst_v[ok].reshape(-1, 3)
            )
        rot, t = self.plane_icp(fid, rot, t)
        score = self._plane_overlap(fid, rot, t)
        return score, rot, t, best_vote

    def plane_icp(
        self, fid: int, rot: np.ndarray, t: np.ndarray, iters: int = 5
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Plane-to-plane ICP refinement (PlaneGeomrtricIcp,
        STDesc.cpp:1282-1366): Gauss-Newton on point-to-plane residuals of
        matched plane centers."""
        src = self._current_plane_cloud
        dst = self.plane_clouds[fid]
        if len(src) == 0 or len(dst) == 0:
            return rot, t
        from scipy.spatial import cKDTree

        tree = cKDTree(dst[:, :3])
        for _ in range(iters):
            p = src[:, :3] @ rot.T + t
            n = src[:, 3:] @ rot.T
            _, idx = tree.query(p, k=1)
            q = dst[idx, :3]
            qn = dst[idx, 3:]
            nd = np.minimum(
                np.linalg.norm(n - qn, axis=-1), np.linalg.norm(n + qn, axis=-1)
            )
            r = np.sum(qn * (p - q), axis=-1)
            w = (nd < self.cfg.normal_threshold) & (np.abs(r) < 2.0)
            if w.sum() < 6:
                return rot, t
            # J wrt [dtheta (right), dt]: d(rot @ ps)/dtheta = -rot [ps]x
            ps = src[w, :3]
            j_rot = -np.einsum("ni,nij->nj", qn[w], rot @ _hat_batch(ps))
            j = np.concatenate([j_rot, qn[w]], axis=1)  # (M, 6)
            rhs = -(j.T @ r[w])
            dx = np.linalg.solve(j.T @ j + np.eye(6) * 1e-6, rhs)
            from scipy.spatial.transform import Rotation as _Rot

            rot = rot @ _Rot.from_rotvec(dx[:3]).as_matrix()
            t = t + dx[3:6]
            if np.linalg.norm(dx) < 1e-8:
                break
        return rot, t

    def _plane_overlap(self, fid: int, rot: np.ndarray, t: np.ndarray) -> float:
        """plane_geometric_verify (STDesc.cpp:1222-1282): fraction of current
        plane centers that land on a matching plane of the candidate."""
        src = self._current_plane_cloud
        dst = self.plane_clouds[fid]
        if len(src) == 0 or len(dst) == 0:
            return 0.0
        from scipy.spatial import cKDTree

        tree = cKDTree(dst[:, :3])
        p = src[:, :3] @ rot.T + t
        n = src[:, 3:] @ rot.T
        _, idx = tree.query(p, k=min(3, len(dst)))
        idx = np.atleast_2d(idx.T).T
        good = np.zeros(len(src), bool)
        for j in range(idx.shape[1]):
            q = dst[idx[:, j], :3]
            qn = dst[idx[:, j], 3:]
            nd = np.minimum(
                np.linalg.norm(n - qn, axis=-1), np.linalg.norm(n + qn, axis=-1)
            )
            p2p = np.abs(np.sum(qn * (p - q), axis=-1))
            good |= (nd < self.cfg.normal_threshold) & (p2p < self.cfg.dis_threshold)
        return float(good.mean())

    def detect(self, cloud: np.ndarray):
        """Full per-keyframe entry: process, search against the database,
        then add. Returns (loop_frame_id, score, rot, t) or None."""
        descs, plane_cloud = self.process_keyframe(cloud)
        self._current_plane_cloud = plane_cloud
        result = self.search(descs)
        self.add_frame(descs, plane_cloud)
        return result


def _hat_batch(v: np.ndarray) -> np.ndarray:
    out = np.zeros((len(v), 3, 3))
    out[:, 0, 1] = -v[:, 2]
    out[:, 0, 2] = v[:, 1]
    out[:, 1, 0] = v[:, 2]
    out[:, 1, 2] = -v[:, 0]
    out[:, 2, 0] = -v[:, 1]
    out[:, 2, 1] = v[:, 0]
    return out


def _triangle_svd(src_verts: np.ndarray, dst_verts: np.ndarray):
    """Relative transform from one triangle correspondence (triangle_solver,
    STDesc.cpp:1194-1221): Kabsch on the three centered vertices."""
    sc = src_verts.mean(0)
    dc = dst_verts.mean(0)
    cov = (src_verts - sc).T @ (dst_verts - dc)
    u, _, vt = np.linalg.svd(cov)
    rot = vt.T @ u.T
    if np.linalg.det(rot) < 0:
        vt[2] *= -1
        rot = vt.T @ u.T
    t = dc - rot @ sc
    return rot, t
