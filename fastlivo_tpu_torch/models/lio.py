"""LIO: the iterated error-state Kalman update with the surfel measurement
model (port of the surfel path of fastlivo_tpu/models/lio.py).

The JAX `lax.while_loop` over iterations, with the surfel re-match under a
`lax.cond`, becomes a Python loop that reads the `done` and `search_en`
flags from the device once per trip (one host read per iteration), so the
trip count is exactly the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch

from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import ieskf
from fastlivo_tpu_torch.ops import linalg
from fastlivo_tpu_torch.state import DIM_STATE, NavState, boxminus, boxplus

_R2D = 57.29577951308232

_NOT_PORTED = (
    "measurement model {!r} is not ported to fastlivo_tpu_torch yet "
    "(ROADMAP.md section 1, item 8: the other LIO models)"
)
_NO_MULTI_DEVICE = (
    "multi-device LIO (axis_name / map_axis) is not ported to "
    "fastlivo_tpu_torch yet (ROADMAP.md section 1, item 14)"
)


@dataclass(frozen=True)
class LioConfig:
    """Static LIO parameters (same fields and defaults as the JAX package;
    only measurement_model="surfel" is ported)."""

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
    """Point-to-surfel innovation: H^T R^-1 H (6x6), H^T R^-1 (-r) (6,),
    the effective count and the residual sum. Invalid rows are hard-zeroed
    before the reductions."""
    if axis_name is not None:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    p_imu, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)
    normal, d, surf_ok = surf.normal, surf.d, surf.valid

    pd2 = torch.sum(normal * p_w, dim=-1) + d
    body_norm = torch.linalg.vector_norm(pts_body, dim=-1)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(torch.clamp(body_norm, min=1e-6))
    valid = pts_mask & surf_ok & (s > 0.9) & (torch.abs(pd2) <= cfg.residual_limit)

    rn = normal @ rot
    a = torch.linalg.cross(p_imu, rn, dim=-1)
    h = torch.cat([a, normal], dim=-1)
    h = torch.where(valid[:, None], h, 0.0)
    pd2_c = torch.where(valid, pd2, 0.0)
    if cfg.surfel_conf_weight:
        min_eig = torch.where(torch.isfinite(surf.min_eig), surf.min_eig, 0.0)
        r_i = cfg.laser_point_cov + min_eig * (1.0 + 3.0 / torch.clamp(surf.n_pts, min=1.0))
    else:
        r_i = torch.tensor(cfg.laser_point_cov, dtype=pts_body.dtype, device=pts_body.device)
    w = valid.to(pts_body.dtype) / r_i
    hth = (h * w[:, None]).T @ h
    hty = h.T @ (w * (-pd2_c))

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
    """One full iterated surfel ESKF update. Returns (posterior, LioInfo,
    (nbr, nbr_valid)) where the cache packs the matched surfel planes:
    nbr[:, 0] = normal, nbr[:, 1] = (d, min_eig, n_pts)."""
    if cfg.measurement_model != "surfel":
        raise NotImplementedError(_NOT_PORTED.format(cfg.measurement_model))
    if axis_name is not None or map_axis is not None:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    dtype = pts_body.dtype
    dev = pts_body.device
    p_inv = linalg.psd_inverse(state_prop.cov)

    def search(rot, pos):
        surf = surfel_match(rot, pos, pts_body, lidar_map, rot_il, t_il, map_cfg, cfg)
        eig = torch.where(torch.isfinite(surf.min_eig), surf.min_eig, 0.0)
        nbr = torch.stack(
            [surf.normal, torch.stack([surf.d, eig, surf.n_pts], dim=-1)], dim=1
        )
        return nbr, surf.valid[:, None]

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
        surf = vm.SurfelResult(
            normal=nbr[:, 0, :], d=nbr[:, 1, 0], valid=nbr_valid[:, 0],
            min_eig=nbr[:, 1, 1], n_pts=nbr[:, 1, 2],
        )
        hth6, hty6, n_eff, res_sum = _innovation_surfel(
            rot, pos, pts_body, pts_mask, surf, rot_il, t_il, cfg
        )
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
