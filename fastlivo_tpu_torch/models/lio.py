"""LIO: the iterated error-state Kalman update (port of the single-device
paths of fastlivo_tpu/models/lio.py) with its three measurement models:
point-to-plane (kNN + plane fit, the default), VGICP (distribution to
point) and surfel (running voxel moments).

The JAX `lax.while_loop` over iterations, with the neighbor re-search
under a `lax.cond`, becomes a Python loop that reads the `done` and
`search_en` flags from the device once per trip (one host read per
iteration), so the trip count is exactly the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import ieskf
from fastlivo_tpu_torch.ops import linalg, plane, so3
from fastlivo_tpu_torch.state import DIM_STATE, NavState, boxminus, boxplus

_R2D = 57.29577951308232

_NO_MULTI_DEVICE = (
    "multi-device LIO (axis_name / map_axis) is not ported to "
    "fastlivo_tpu_torch yet (ROADMAP.md section 1, item 14)"
)


@dataclass(frozen=True)
class LioConfig:
    """Static LIO parameters (same fields and defaults as the JAX package).

    measurement_model: "point_to_plane" (default), "vgicp" or "surfel".
    vgicp_source_mode: "neighborhood" (per-point GICP source covariances
    from the scan's own kNN) or "isotropic" (vgicp_source_cov * I)."""

    max_iteration: int = 10
    num_match_points: int = 5
    laser_point_cov: float = 0.00015
    plane_threshold: float = 0.1
    residual_limit: float = 2.0
    converge_rot_deg: float = 0.01
    converge_trans_cm: float = 0.015
    filter_size_map: float = 0.3
    max_search_dist2: float = 25.0
    measurement_model: str = "point_to_plane"
    vgicp_source_cov: float = 0.01
    vgicp_source_mode: str = "neighborhood"
    vgicp_source_k: int = 8
    vgicp_source_eps: float = 1e-3
    surfel_min_points: float = 6.0
    surfel_planarity_max: float = 0.01
    surfel_conf_weight: bool = True
    max_jump_m: float = 1.0
    min_effective: int = 50


class LioInfo(NamedTuple):
    n_effective: torch.Tensor  # () int32
    res_mean: torch.Tensor  # () f32
    iterations: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool


def transform_to_world(
    pts_body: torch.Tensor,
    rot: torch.Tensor,
    pos: torch.Tensor,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LiDAR frame -> (IMU frame, world frame)."""
    p_imu = pts_body @ rot_il.T + t_il
    p_w = p_imu @ rot.T + pos
    return p_imu, p_w


def _plane_sums(normal, pd2, p_imu, rot, valid, w):
    """Point-to-plane Jacobian rows [([p]x R^T n)^T, n^T], hard-zeroed where
    invalid (a NaN in a masked row would still poison the sums), reduced to
    H^T W H (6x6) and H^T W (-r) (6,)."""
    rn = normal @ rot
    a = torch.linalg.cross(p_imu, rn, dim=-1)
    h = torch.cat([a, normal], dim=-1)
    h = torch.where(valid[:, None], h, 0.0)
    pd2_c = torch.where(valid, pd2, 0.0)
    hth = (h * w[:, None]).T @ h
    hty = h.T @ (w * (-pd2_c))
    return hth, hty


def _residual_gate(normal, d, plane_ok, p_w, pts_body, pts_mask, cfg: LioConfig):
    """Residual pd2 = n.p_w + d and the effective-point gate
    s = 1 - 0.9 |pd2| / sqrt(|p_body|) > 0.9, |pd2| <= residual_limit."""
    pd2 = torch.sum(normal * p_w, dim=-1) + d
    body_norm = torch.linalg.vector_norm(pts_body, dim=-1)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.clamp(body_norm, min=1e-6))
    valid = pts_mask & plane_ok & (s > 0.9) & (torch.abs(pd2) <= cfg.residual_limit)
    return pd2, valid


def _innovation(
    rot, pos, pts_body, pts_mask, neighbors, neighbor_valid, rot_il, t_il, cfg: LioConfig,
):
    """Point-to-plane innovation: the plane is refit from the cached
    neighbors every iteration. Returns (H^T R^-1 H (6x6), H^T R^-1 (-r),
    n_effective, residual sum)."""
    p_imu, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)
    normal, d, plane_ok = plane.esti_plane(neighbors, neighbor_valid, cfg.plane_threshold)
    pd2, valid = _residual_gate(normal, d, plane_ok, p_w, pts_body, pts_mask, cfg)
    w = valid.to(pts_body.dtype) / cfg.laser_point_cov
    hth, hty = _plane_sums(normal, pd2, p_imu, rot, valid, w)
    n_eff = torch.sum(valid.to(torch.int32)).to(torch.int32)
    res_sum = torch.sum(torch.where(valid, torch.abs(pd2), 0.0))
    return hth, hty, n_eff, res_sum


def scan_source_covariances(
    pts_body: torch.Tensor,
    pts_mask: torch.Tensor,
    cfg: LioConfig,
    ds_leaf: float = 0.5,
) -> torch.Tensor:
    """Per-point GICP source covariances from the scan's own neighborhoods,
    with the plane regularization s * (I - (1 - eps) n n^T) (n the smallest
    eigenvector); points with fewer than 4 neighbors get s * I. The
    neighborhoods come from a scratch voxel arena built over the scan
    itself. Returns (N, 3, 3)."""
    dtype = pts_body.dtype
    dev = pts_body.device
    scratch_cfg = vm.VoxelMapConfig(
        resolution=ds_leaf * 4.0, capacity=1 << 14, max_points=16, probe_depth=8, nearby_type=6,
    )
    scratch = vm.make_map(scratch_cfg, dtype, device=dev)
    scratch = vm.insert(scratch, pts_body, pts_mask, scratch_cfg)
    nbr, _, nv = vm.knn(scratch, pts_body, scratch_cfg, k=cfg.vgicp_source_k, max_dist2=4.0)
    w = nv.to(dtype)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mean = torch.sum(nbr * w[..., None], dim=1) / cnt[:, None]
    d = (nbr - mean[:, None, :]) * w[..., None]
    cov = d.transpose(-1, -2) @ d / cnt[:, None, None]
    eye = torch.eye(3, dtype=dtype, device=dev)
    cov = cov + eye * 1e-9
    _, normal = linalg.eigh3_smallest(cov)
    reg = eye - (1.0 - cfg.vgicp_source_eps) * (normal[:, :, None] * normal[:, None, :])
    enough = torch.sum(nv.to(torch.int32), dim=1) >= 4
    return torch.where(enough[:, None, None], reg, eye.expand(reg.shape)) * cfg.vgicp_source_cov


def _innovation_vgicp(
    rot, pos, pts_body, pts_mask, neighbors, neighbor_valid, rot_il, t_il, cfg: LioConfig,
    src_cov: torch.Tensor | None = None,
):
    """Distribution-to-point innovation: error_i = mean(neighbors_i) - p_w_i,
    weight (cov(neighbors_i) + R C_src_i R^T)^-1, Jacobian
    [-R [p_imu]x, I]. src_cov None means the isotropic vgicp_source_cov * I.

    `inv_ex`, not `inv`: the latter checks for singular inputs and so reads
    a flag back to the host; JAX's inverse returns non-finite values
    there and never raises."""
    dtype = pts_body.dtype
    dev = pts_body.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    p_imu, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)

    w_nb = neighbor_valid.to(dtype)
    cnt = torch.clamp(torch.sum(w_nb, dim=1), min=1.0)
    mean_b = torch.sum(neighbors * w_nb[..., None], dim=1) / cnt[:, None]
    d = (neighbors - mean_b[:, None, :]) * w_nb[..., None]
    cov_b = d.transpose(-1, -2) @ d / cnt[:, None, None]
    if src_cov is None:
        rcr = cov_b + eye * cfg.vgicp_source_cov
    else:
        # Rotate the body-frame source covariance into the world at the
        # current iterate.
        rw = rot @ rot_il
        rcr = cov_b + rw @ src_cov @ rw.T
        rcr = rcr + eye * 1e-6

    err = mean_b - p_w
    valid = (
        pts_mask
        & torch.all(neighbor_valid, dim=-1)
        & (torch.linalg.vector_norm(err, dim=-1) <= cfg.residual_limit)
    )

    h_rot = -(rot @ so3.hat(p_imu))
    h = torch.cat([h_rot, eye.expand(h_rot.shape)], dim=-1)  # (N, 3, 6)

    inv = torch.linalg.inv_ex(rcr).inverse
    w = valid.to(dtype) * torch.sqrt(cnt)
    inv = inv * w[:, None, None]

    h = torch.where(valid[:, None, None], h, 0.0)
    err_c = torch.where(valid[:, None], err, 0.0)
    mh = inv @ h  # (N, 3, 6)
    hth = h.reshape(-1, 6).T @ mh.reshape(-1, 6)
    hty = mh.reshape(-1, 6).T @ err_c.reshape(-1)

    n_eff = torch.sum(valid.to(torch.int32)).to(torch.int32)
    res_sum = torch.sum(torch.where(valid, torch.linalg.vector_norm(err, dim=-1), 0.0))
    return hth, hty, n_eff, res_sum


def surfel_match(
    rot, pos, pts_body, lidar_map, rot_il, t_il, map_cfg, cfg, map_axis=None
) -> vm.SurfelResult:
    """Associate each point with a map surfel at the current pose estimate
    (the plane itself is pose-independent and is cached by lio_update)."""
    if map_axis is not None:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    _, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)
    return vm.surfel_lookup(
        lidar_map, p_w, map_cfg, cfg.surfel_min_points, cfg.surfel_planarity_max
    )


def _innovation_surfel(
    rot, pos, pts_body, pts_mask, surf: vm.SurfelResult, rot_il, t_il, cfg: LioConfig,
    axis_name=None,
):
    """Point-to-surfel innovation: the point-to-plane structure with the
    plane from a cached surfel match and, with surfel_conf_weight, the
    measurement variance inflated by the surfel's own uncertainty."""
    if axis_name is not None:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    p_imu, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)
    pd2, valid = _residual_gate(surf.normal, surf.d, surf.valid, p_w, pts_body, pts_mask, cfg)
    if cfg.surfel_conf_weight:
        min_eig = torch.where(torch.isfinite(surf.min_eig), surf.min_eig, 0.0)
        r_i = cfg.laser_point_cov + min_eig * (1.0 + 3.0 / torch.clamp(surf.n_pts, min=1.0))
    else:
        r_i = torch.tensor(cfg.laser_point_cov, dtype=pts_body.dtype, device=pts_body.device)
    w = valid.to(pts_body.dtype) / r_i
    hth, hty = _plane_sums(surf.normal, pd2, p_imu, rot, valid, w)
    n_eff = torch.sum(valid.to(torch.int32)).to(torch.int32)
    res_sum = torch.sum(torch.where(valid, torch.abs(pd2), 0.0))
    return hth, hty, n_eff, res_sum


def _embed18(hth6: torch.Tensor, hty6: torch.Tensor, dtype):
    hth = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=hth6.device)
    hth[0:6, 0:6] = hth6
    hty = torch.zeros((DIM_STATE,), dtype=dtype, device=hty6.device)
    hty[0:6] = hty6
    return hth, hty


def lio_update(
    state_prop: NavState,
    lidar_map: vm.VoxelHashMap,
    pts_body: torch.Tensor,
    pts_mask: torch.Tensor,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    map_cfg: vm.VoxelMapConfig,
    cfg: LioConfig,
    extra_hth: torch.Tensor | None = None,
    extra_hty: torch.Tensor | None = None,
    axis_name: str | None = None,
    map_axis: str | None = None,
) -> Tuple[NavState, LioInfo, Tuple[torch.Tensor, torch.Tensor]]:
    """One full iterated ESKF update. Returns (posterior, LioInfo,
    (nbr, nbr_valid)): the kNN neighbor cache (point_to_plane, vgicp),
    reused by the map-insert gate, or for the surfel model the matched
    planes packed as nbr[:, 0] = normal, nbr[:, 1] = (d, min_eig, n_pts)."""
    if axis_name is not None or map_axis is not None:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    dtype = pts_body.dtype
    dev = pts_body.device
    p_inv = linalg.psd_inverse(state_prop.cov)
    surfel_mode = cfg.measurement_model == "surfel"
    src_cov = None
    if cfg.measurement_model == "vgicp" and cfg.vgicp_source_mode == "neighborhood":
        src_cov = scan_source_covariances(pts_body, pts_mask, cfg)

    def search(rot, pos):
        if surfel_mode:
            surf = surfel_match(rot, pos, pts_body, lidar_map, rot_il, t_il, map_cfg, cfg)
            eig = torch.where(torch.isfinite(surf.min_eig), surf.min_eig, 0.0)
            nbr = torch.stack(
                [surf.normal, torch.stack([surf.d, eig, surf.n_pts], dim=-1)], dim=1
            )
            return nbr, surf.valid[:, None]
        _, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)
        nbr, _, nbr_valid = vm.knn(
            lidar_map, p_w, map_cfg, k=cfg.num_match_points, max_dist2=cfg.max_search_dist2
        )
        return nbr, nbr_valid & pts_mask[:, None]

    def innovation(rot, pos, nbr, nbr_valid):
        if surfel_mode:
            surf = vm.SurfelResult(
                normal=nbr[:, 0, :], d=nbr[:, 1, 0], valid=nbr_valid[:, 0],
                min_eig=nbr[:, 1, 1], n_pts=nbr[:, 1, 2],
            )
            return _innovation_surfel(rot, pos, pts_body, pts_mask, surf, rot_il, t_il, cfg)
        if cfg.measurement_model == "vgicp":
            return _innovation_vgicp(
                rot, pos, pts_body, pts_mask, nbr, nbr_valid, rot_il, t_il, cfg, src_cov=src_cov
            )
        return _innovation(rot, pos, pts_body, pts_mask, nbr, nbr_valid, rot_il, t_il, cfg)

    nbr, nbr_valid = search(state_prop.rot, state_prop.pos)
    rot, pos, vel = state_prop.rot, state_prop.pos, state_prop.vel
    bg, ba, grav = state_prop.bg, state_prop.ba, state_prop.grav
    g_mat = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
    rematch_num = torch.zeros((), dtype=torch.int32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    n_eff = torch.zeros((), dtype=torch.int32, device=dev)
    res_sum = torch.zeros((), dtype=dtype, device=dev)
    search_en = False
    it = 0
    while True:  # the JAX while_loop: one host read of (done, search_en) per trip
        if search_en:
            nbr, nbr_valid = search(rot, pos)
        hth6, hty6, n_eff, res_sum = innovation(rot, pos, nbr, nbr_valid)
        hth, hty = _embed18(hth6, hty6, dtype)
        if extra_hth is not None:
            hth = hth + extra_hth
            hty = hty + extra_hty

        cur = NavState(rot, pos, vel, bg, ba, grav, state_prop.cov)
        vec = boxminus(state_prop, cur)
        dx, g_mat = ieskf.map_step(p_inv, hth, hty, vec)
        new = boxplus(cur, dx)
        rot_add = torch.linalg.vector_norm(dx[0:3])
        t_add = torch.linalg.vector_norm(dx[3:6])
        converged = (rot_add * _R2D < cfg.converge_rot_deg) & (
            t_add * 100.0 < cfg.converge_trans_cm
        )
        want_rematch = converged | ((rematch_num == 0) & (it == cfg.max_iteration - 2))
        rematch_num = rematch_num + want_rematch.to(torch.int32)
        done = (rematch_num >= 2) | (it == cfg.max_iteration - 1)
        rot, pos, vel, bg, ba, grav = new.rot, new.pos, new.vel, new.bg, new.ba, new.grav
        it += 1
        flags = torch.stack([done, want_rematch]).tolist()
        if flags[0]:
            break
        search_en = flags[1]

    cov = ieskf.posterior_cov(state_prop.cov, g_mat)
    posterior = NavState(rot, pos, vel, bg, ba, grav, cov)
    info = LioInfo(
        n_effective=n_eff,
        res_mean=res_sum / torch.clamp(n_eff.to(dtype), min=1.0),
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        converged=converged,
    )
    return posterior, info, (nbr, nbr_valid)


def map_insert_gate(
    pts_world: torch.Tensor,
    pts_mask: torch.Tensor,
    neighbors: torch.Tensor,
    neighbor_valid: torch.Tensor,
    filter_size_map: float,
) -> torch.Tensor:
    """Which scan points enter the map: a point is added when it has no
    valid neighbor, its nearest neighbor lies outside the point's filter
    voxel in every axis, or the K neighbors are not all valid, or none of
    them is closer to the filter-voxel center than the point."""
    center = (torch.floor(pts_world / filter_size_map) + 0.5) * filter_size_map
    has_nbr = neighbor_valid[:, 0]
    d_nn = torch.abs(neighbors[:, 0, :] - center)
    outside = torch.all(d_nn > 0.5 * filter_size_map, dim=-1)
    dist_self = torch.sum((pts_world - center) ** 2, dim=-1)
    dist_nbrs = torch.sum((neighbors - center[:, None, :]) ** 2, dim=-1)
    nbr_closer = torch.any(neighbor_valid & (dist_nbrs < dist_self[:, None] + 1e-6), dim=-1)
    all_valid = torch.all(neighbor_valid, dim=-1)
    need_add = ~(all_valid & nbr_closer)
    return pts_mask & (~has_nbr | outside | need_add)
