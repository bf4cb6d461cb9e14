"""LiDAR-inertial odometry, written from the mathematics.

State: rotation R (world from IMU), position, velocity, gyro and
accelerometer biases, gravity, and the 18x18 error-state covariance, the
error ordered (rotation, position, velocity, gyro bias, accelerometer
bias, gravity), the rotation error on the right: R exp(dtheta).

Propagation (`propagate`): between IMU samples j and j+1 the rate and the
specific force are the two samples' means less the biases (the force
scaled by the initialization's accelerometer scale); R_{j+1} = R_j exp(w
dt), the world acceleration R_{j+1} a + g moves position and velocity by
constant acceleration, and P <- F P F^T + Q with the first-order error
transition F and the white-noise Q of the configuration's densities.
From the last sample to the group's end the last interval's rate and
acceleration continue.

Motion compensation (`undistort`): a point taken at time t is moved from
the LiDAR frame at t, the pose of its IMU interval continued to t, into
the LiDAR frame at the group's end.

The update (`update`): the scan's points, thinned by a centroid voxel
filter, are matched each to the k nearest map points over the stencil of
voxels around its own (`PointMap.knn`); a least-squares plane n.x + d = 0
(|n| = 1, from A x = -1) through them is kept when every neighbour lies
within the threshold of it. A point's residual is its world position's
distance to its plane; it counts when the plane holds, |r| <= limit and
1 - 0.9 |r| / sqrt(|p_lidar|) > 0.9. The iterated update minimizes the
prior term plus the weighted residuals by Gauss-Newton steps on the
manifold, searching the neighbours again after a step below the
convergence thresholds (or on the second to last trip when none was) and
ending after the second such search or the last trip. The posterior
covariance is (I - G) P, G = (P^-1 + H^T W H)^-1 H^T W H. An update whose
position moves more than `max_jump_m`, or is not finite, is dropped.

The map's insert rule (`insert_gate`, `PointMap.insert`): a point enters
unless it has k valid neighbours from the last search and one of them
lies nearer the centre of the point's filter voxel than the point itself,
or the nearest lies inside that voxel; a map voxel keeps its first
`max_points_per_voxel` points.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from livobench.reference import arith as A

R2D = 180.0 / np.pi
MODELS = ("point_to_plane",)  # the LIO measurement models written here
OFF = 1 << 20  # voxel coordinates are coded as three 21-bit fields


class State(NamedTuple):
    rot: torch.Tensor
    pos: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    grav: torch.Tensor
    cov: torch.Tensor


def state_of(values, ar: A.Arith, device) -> State:
    """A state from seven arrays (rot, pos, vel, bg, ba, grav, cov)."""
    return State(*(ar.t(v, device) for v in values))


def boxplus(s: State, d: torch.Tensor) -> State:
    return State(s.rot @ A.exp(d[0:3]), s.pos + d[3:6], s.vel + d[6:9], s.bg + d[9:12],
                 s.ba + d[12:15], s.grav + d[15:18], s.cov)


def boxminus(a: State, b: State) -> torch.Tensor:
    """a - b: (log(R_b^T R_a), the rest's differences)."""
    return torch.cat([A.log(b.rot.T @ a.rot), a.pos - b.pos, a.vel - b.vel, a.bg - b.bg,
                      a.ba - b.ba, a.grav - b.grav])


# ---------------------------------------------------------------------------
# IMU.
# ---------------------------------------------------------------------------


class Track(NamedTuple):
    """Poses at the window's samples and the rates that continue them."""

    t: torch.Tensor  # (k,)
    rot: torch.Tensor  # (k, 3, 3)
    pos: torch.Tensor
    vel: torch.Tensor
    w: torch.Tensor  # (k, 3) body rate from sample j on
    a: torch.Tensor  # (k, 3) world acceleration from sample j on


def propagate(ar: A.Arith, s: State, g, acc_scale: float, imu) -> Tuple[State, Track]:
    dev = s.pos.device
    t, gyr, acc = ar.t(g.imu_t, dev), ar.t(g.gyr, dev), ar.t(g.acc, dev)
    k = t.shape[0]
    if k < 2:
        raise ValueError("a group's IMU window needs two samples")
    eye = torch.eye(3, dtype=ar.dtype, device=dev)
    rot, pos, vel, cov = s.rot, s.pos, s.vel, s.cov
    rots, poss, vels, ws, accs = [rot], [pos], [vel], [], []
    for j in range(k - 1):
        w = 0.5 * (gyr[j] + gyr[j + 1]) - s.bg
        a = 0.5 * (acc[j] + acc[j + 1]) * acc_scale - s.ba
        dt = t[j + 1] - t[j]
        f = torch.eye(18, dtype=ar.dtype, device=dev)
        f[0:3, 0:3] = A.exp(-w * dt)
        f[0:3, 9:12] = -eye * dt
        f[3:6, 6:9] = eye * dt
        f[6:9, 0:3] = -ar.mm(rot, A.hat(a)) * dt
        f[6:9, 12:15] = -rot * dt
        f[6:9, 15:18] = eye * dt
        q = torch.zeros(18, dtype=ar.dtype, device=dev)
        q[0:3], q[6:9] = imu.cov_gyr * dt * dt, imu.cov_acc * dt * dt
        q[9:12], q[12:15] = imu.cov_bias_gyr * dt * dt, imu.cov_bias_acc * dt * dt
        cov = ar.mm(ar.mm(f, cov), f.T) + torch.diag(q)
        rot = ar.mm(rot, A.exp(w * dt))
        aw = ar.mm(rot, a[:, None])[:, 0] + s.grav
        pos = pos + vel * dt + 0.5 * aw * dt * dt
        vel = vel + aw * dt
        rots.append(rot), poss.append(pos), vels.append(vel), ws.append(w), accs.append(aw)
    ws.append(ws[-1]), accs.append(accs[-1])
    tr = Track(t, torch.stack(rots), torch.stack(poss), torch.stack(vels), torch.stack(ws), torch.stack(accs))
    de = ar.t(g.t_end, dev) - t[-1]
    end = State(ar.mm(rot, A.exp(ws[-1] * de)), pos + vel * de + 0.5 * accs[-1] * de * de,
                vel + accs[-1] * de, s.bg, s.ba, s.grav, cov)
    return end, tr


def undistort(ar: A.Arith, pts: torch.Tensor, pt_t: torch.Tensor, tr: Track, end: State,
              r_il: torch.Tensor, t_il: torch.Tensor) -> torch.Tensor:
    """LiDAR-frame points at their times -> the LiDAR frame at the end."""
    j = torch.clamp(torch.searchsorted(tr.t, pt_t, right=True) - 1, 0, tr.t.shape[0] - 1)
    dt = (pt_t - tr.t[j])[:, None]
    rot = tr.rot[j] @ A.exp(tr.w[j] * dt)
    pos = tr.pos[j] + tr.vel[j] * dt + 0.5 * tr.a[j] * dt * dt
    p_imu = ar.mm(pts, r_il.T) + t_il
    p_w = ar.mm(rot, p_imu[:, :, None])[:, :, 0] + pos
    return ar.mm(ar.mm(p_w - end.pos, end.rot) - t_il, r_il)


# ---------------------------------------------------------------------------
# Voxels.
# ---------------------------------------------------------------------------


def voxel_codes(vox: torch.Tensor) -> torch.Tensor:
    """Integer voxel coordinates (..., 3) -> int64 codes ordered as the
    coordinates are, lexicographically."""
    v = vox.to(torch.int64) + OFF
    return (v[..., 0] << 42) | (v[..., 1] << 21) | v[..., 2]


def downsample(pts: torch.Tensor, leaf: float, capacity: int) -> torch.Tensor:
    """The centroid of each occupied leaf voxel, the voxels in
    lexicographic order, the first `capacity` of them."""
    codes = voxel_codes(torch.floor(pts / leaf))
    uniq, inv = torch.unique(codes, sorted=True, return_inverse=True)
    sums = torch.zeros((uniq.shape[0], 3), dtype=pts.dtype, device=pts.device).index_add_(0, inv, pts)
    cnt = torch.zeros(uniq.shape[0], dtype=pts.dtype, device=pts.device).index_add_(
        0, inv, torch.ones_like(pts[:, 0]))
    return (sums / cnt[:, None])[:capacity]


def stencil(nearby_type: int) -> torch.Tensor:
    """The voxel offsets searched around a point's voxel: itself, then
    the 6 face, 12 edge and 8 corner neighbours as the type includes."""
    offs = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
    ring = {0: 0, 6: 1, 18: 2, 26: 3}[nearby_type]
    return torch.tensor([o for o in offs if sum(map(abs, o)) <= ring], dtype=torch.int64)


class PointMap:
    """Map voxels of side `res`, each with up to `cap` points."""

    def __init__(self, res: float, cap: int, codes, pts, counts):
        order = torch.argsort(codes)
        self.res, self.cap = res, cap
        self.codes, self.pts, self.counts = codes[order], pts[order], counts[order]

    @staticmethod
    def empty(res: float, cap: int, ar: A.Arith, device) -> "PointMap":
        return PointMap(res, cap, torch.zeros(0, dtype=torch.int64, device=device),
                        torch.zeros((0, cap, 3), dtype=ar.dtype, device=device),
                        torch.zeros(0, dtype=torch.int64, device=device))

    @staticmethod
    def of_arena(keys, occupied, counts, points, res: float, ar: A.Arith) -> "PointMap":
        """From a hashed arena's slots: their voxel keys, occupancy,
        point counts and (slots, cap, 3) points."""
        keep = occupied & (counts > 0)
        return PointMap(res, points.shape[1], voxel_codes(keys[keep]), points[keep].to(ar.dtype),
                        counts[keep].to(torch.int64))

    def rows(self, codes: torch.Tensor) -> torch.Tensor:
        """The row of each code's voxel, -1 where the map has none."""
        if self.codes.numel() == 0:
            return torch.full_like(codes, -1)
        i = torch.clamp(torch.searchsorted(self.codes, codes), max=self.codes.shape[0] - 1)
        return torch.where(self.codes[i] == codes, i, -1)

    def knn(self, q: torch.Tensor, k: int, max_d2: float, nearby_type: int, chunk: int = 2048):
        """(neighbours (N, k, 3), valid (N, k)), nearest first."""
        offs = stencil(nearby_type).to(q.device)
        out_p, out_v = [], []
        s = self.cap
        for c0 in range(0, q.shape[0], chunk):
            qc = q[c0:c0 + chunk]
            vox = torch.floor(qc / self.res).to(torch.int64)
            r = self.rows(voxel_codes(vox[:, None, :] + offs[None, :, :]))  # (n, o)
            rc = torch.clamp(r, min=0)
            cand = self.pts[rc].reshape(qc.shape[0], -1, 3)  # (n, o * s, 3)
            ok = (torch.arange(s, device=q.device)[None, None, :] < self.counts[rc][:, :, None]) & (r >= 0)[:, :, None]
            d2 = torch.where(ok.reshape(qc.shape[0], -1), ((cand - qc[:, None, :]) ** 2).sum(-1), torch.inf)
            kk = min(k, d2.shape[1])
            best, idx = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
            nb = torch.gather(cand, 1, idx[:, :, None].expand(-1, -1, 3))
            if kk < k:
                nb = torch.cat([nb, torch.zeros((nb.shape[0], k - kk, 3), dtype=nb.dtype, device=nb.device)], 1)
                best = torch.cat([best, torch.full((best.shape[0], k - kk), torch.inf, dtype=best.dtype,
                                                   device=best.device)], 1)
            v = best <= max_d2
            out_p.append(torch.where(v[:, :, None], nb, 0.0))
            out_v.append(v)
        return torch.cat(out_p), torch.cat(out_v)

    def insert(self, p: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
        """Append the added points to their voxels, in order, each voxel up
        to `cap`; returns which points went in."""
        codes = voxel_codes(torch.floor(p / self.res))
        new = torch.unique(codes[add & (self.rows(codes) < 0)])
        if new.numel():
            dev = p.device
            self.__init__(self.res, self.cap, torch.cat([self.codes, new]),
                          torch.cat([self.pts, torch.zeros((new.shape[0], self.cap, 3), dtype=self.pts.dtype, device=dev)]),
                          torch.cat([self.counts, torch.zeros(new.shape[0], dtype=torch.int64, device=dev)]))
        rows = self.rows(codes)
        idx = torch.nonzero(add)[:, 0]
        r = rows[idx]
        order = torch.argsort(r * (p.shape[0] + 1) + idx)  # by voxel, then in order
        r_s, idx_s = r[order], idx[order]
        first = torch.ones_like(r_s, dtype=torch.bool)
        first[1:] = r_s[1:] != r_s[:-1]
        pos = torch.arange(r_s.shape[0], device=p.device)
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        dest = self.counts[r_s] + (pos - start)
        ok = dest < self.cap
        self.pts[r_s[ok], dest[ok]] = p[idx_s[ok]].to(self.pts.dtype)
        self.counts = torch.clamp(self.counts.index_add(0, r_s, torch.ones_like(r_s)), max=self.cap)
        went = torch.zeros_like(add)
        went[idx_s[ok]] = True
        return went


# ---------------------------------------------------------------------------
# The update.
# ---------------------------------------------------------------------------


def plane(ar: A.Arith, nb: torch.Tensor, nv: torch.Tensor, thresh: float):
    """(normal, d, ok) of the least-squares planes through (N, k, 3)."""
    gram = ar.mm(nb.transpose(1, 2), nb)
    x, info = torch.linalg.solve_ex(gram, -nb.sum(1))
    ok = (info == 0) & torch.isfinite(x).all(-1)
    x = torch.where(ok[:, None], x, 1.0)
    norm = torch.linalg.vector_norm(x, dim=-1)
    n = x / norm[:, None]
    d = 1.0 / norm
    ok = ok & nv.all(-1) & ((ar.mm(nb, n[:, :, None])[:, :, 0] + d[:, None]).abs() <= thresh).all(-1)
    return torch.where(ok[:, None], n, 0.0), torch.where(ok, d, 0.0), ok


def update(ar: A.Arith, prior: State, pts: torch.Tensor, pmap: PointMap, r_il, t_il, p):
    """The iterated update of the (M, 3) LiDAR-frame points. Returns
    (posterior, accepted, last neighbours, their validity, (trips, points
    in the last trip's residuals))."""
    lio, mp = p.lio, p.map
    if lio.measurement_model not in MODELS:
        raise ValueError(f"the reference's LIO implements {', '.join(MODELS)}, not {lio.measurement_model!r}")
    dev = pts.device
    p_inv = torch.linalg.inv(prior.cov)
    p_imu = ar.mm(pts, r_il.T) + t_il
    body = torch.sqrt(torch.clamp(torch.linalg.vector_norm(pts, dim=-1), min=1e-6))
    wgt = 1.0 / lio.laser_point_cov

    def world(s):
        return ar.mm(p_imu, s.rot.T) + s.pos

    def search(s):
        return pmap.knn(world(s), mp.num_match_points, lio.max_search_dist2, mp.nearby_type)

    nb, nv = search(prior)
    cur, rematch, again, gain, n_eff = prior, 0, False, None, 0
    for it in range(lio.max_iteration):
        if again:
            nb, nv = search(cur)
        n, d, ok = plane(ar, nb, nv, lio.plane_threshold)
        r = (n * world(cur)).sum(-1) + d
        valid = ok & (r.abs() <= lio.residual_limit) & (1.0 - 0.9 * r.abs() / body > 0.9)
        h = torch.cat([torch.linalg.cross(p_imu, ar.mm(n, cur.rot), dim=-1), n], -1)
        h = torch.where(valid[:, None], h, 0.0)
        n_eff = int(valid.sum())
        hth = torch.zeros((18, 18), dtype=ar.dtype, device=dev)
        hty = torch.zeros(18, dtype=ar.dtype, device=dev)
        hth[0:6, 0:6] = wgt * ar.mm(h.T, h)
        hty[0:6] = wgt * ar.mm(h.T, torch.where(valid, -r, 0.0)[:, None])[:, 0]
        s_mat = p_inv + hth
        dx = torch.linalg.solve(s_mat, ar.mm(p_inv, boxminus(prior, cur)[:, None])[:, 0] + hty)
        gain = torch.linalg.solve(s_mat, hth)
        cur = boxplus(cur, dx)
        conv = bool((torch.linalg.vector_norm(dx[0:3]) * R2D < lio.converge_rot_deg)
                    & (torch.linalg.vector_norm(dx[3:6]) * 100.0 < lio.converge_trans_cm))
        again = conv or (rematch == 0 and it == lio.max_iteration - 2)
        rematch += again
        if rematch >= 2:
            break
    cov = ar.mm(torch.eye(18, dtype=ar.dtype, device=dev) - gain, prior.cov)
    post = cur._replace(cov=0.5 * (cov + cov.T))
    accept = bool(torch.isfinite(post.pos).all() and torch.isfinite(post.cov).all()
                  and torch.linalg.vector_norm(post.pos - prior.pos) <= lio.max_jump_m)
    return (post if accept else prior), accept, nb, nv, (it + 1, n_eff)


def insert_gate(p_w: torch.Tensor, nb: torch.Tensor, nv: torch.Tensor, leaf: float) -> torch.Tensor:
    center = (torch.floor(p_w / leaf) + 0.5) * leaf
    outside = ((nb[:, 0, :] - center).abs() > 0.5 * leaf).all(-1)
    self_d2 = ((p_w - center) ** 2).sum(-1)
    closer = (nv & (((nb - center[:, None, :]) ** 2).sum(-1) < self_d2[:, None] + 1e-6)).any(-1)
    return ~nv[:, 0] | outside | ~(nv.all(-1) & closer)


def world_points(ar: A.Arith, pts: torch.Tensor, s: State, r_il, t_il) -> torch.Tensor:
    return ar.mm(ar.mm(pts, r_il.T) + t_il, s.rot.T) + s.pos
