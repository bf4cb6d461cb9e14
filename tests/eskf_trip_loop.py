"""The LIO update's loop before its trips were factored into
`models.lio.eskf_trip`, kept op for op as the tests' eager reference: each
trip dispatched from a Python loop, one flag read a trip, the same
`lio.eskf.trips`, `lio.eskf.searches` and `sync.eskf_flags` counts. The
surfel innovation's constant variance is made inside the trip, as it was.
`lio_case` makes the updates both are held to on one device. Imports no
jax, so the tests marked `cuda` use it too."""

from typing import Tuple

import numpy as np
import torch

import chip_smoke

from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import ieskf
from fastlivo_tpu_torch.models.lio import (
    _R2D, LioConfig, LioInfo, _embed18, _innovation, _innovation_surfel, _innovation_vgicp,
    scan_source_covariances, surfel_match, transform_to_world,
)
from fastlivo_tpu_torch.ops import linalg, so3, voxelize
from fastlivo_tpu_torch.state import DIM_STATE, NavState, boxminus, boxplus
from fastlivo_tpu_torch.utils import timing


def loop_lio_update(
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
    axis_name=None,
    map_axis=None,
) -> Tuple[NavState, LioInfo, Tuple[torch.Tensor, torch.Tensor]]:
    """One full iterated ESKF update. Returns (posterior, LioInfo,
    (nbr, nbr_valid)): the kNN neighbor cache (point_to_plane, vgicp),
    reused by the map-insert gate, or for the surfel model the matched
    planes packed as nbr[:, 0] = normal, nbr[:, 1] = (d, min_eig, n_pts).

    axis_name: the `Axis` pts_body is sharded over; the innovations are
    summed over it, before extra_hth/extra_hty are added. map_axis: the
    `Axis` lidar_map is sharded over; pts_body must then be replicated over
    it, and the lookups merge over it. Both may be set (a 2-D mesh)."""
    dtype = pts_body.dtype
    dev = pts_body.device
    p_inv = linalg.psd_inverse(state_prop.cov)
    surfel_mode = cfg.measurement_model == "surfel"
    src_cov = None
    if cfg.measurement_model == "vgicp" and cfg.vgicp_source_mode == "neighborhood":
        src_cov = scan_source_covariances(pts_body, pts_mask, cfg)

    def search(rot, pos):
        timing.count("lio.eskf.searches")
        with timing.span("lio.eskf.search"):
            return _search(rot, pos)

    def _search(rot, pos):
        if surfel_mode:
            surf = surfel_match(rot, pos, pts_body, lidar_map, rot_il, t_il, map_cfg, cfg, map_axis)
            eig = torch.where(torch.isfinite(surf.min_eig), surf.min_eig, 0.0)
            nbr = torch.stack(
                [surf.normal, torch.stack([surf.d, eig, surf.n_pts], dim=-1)], dim=1
            )
            return nbr, surf.valid[:, None]
        _, p_w = transform_to_world(pts_body, rot, pos, rot_il, t_il)
        if map_axis is not None:
            nbr, _, nbr_valid = vm.sharded_knn(
                lidar_map, p_w, map_cfg, map_axis, k=cfg.num_match_points,
                max_dist2=cfg.max_search_dist2,
            )
        else:
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
            point_cov = None if cfg.surfel_conf_weight else torch.tensor(
                cfg.laser_point_cov, dtype=pts_body.dtype, device=pts_body.device
            )
            return _innovation_surfel(
                rot, pos, pts_body, pts_mask, surf, rot_il, t_il, cfg, axis_name, point_cov
            )
        if cfg.measurement_model == "vgicp":
            return _innovation_vgicp(
                rot, pos, pts_body, pts_mask, nbr, nbr_valid, rot_il, t_il, cfg, axis_name,
                src_cov=src_cov,
            )
        return _innovation(
            rot, pos, pts_body, pts_mask, nbr, nbr_valid, rot_il, t_il, cfg, axis_name
        )

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
        timing.count("lio.eskf.trips")
        if search_en:
            nbr, nbr_valid = search(rot, pos)
        with timing.span("lio.eskf.innovation"):
            hth6, hty6, n_eff, res_sum = innovation(rot, pos, nbr, nbr_valid)
        with timing.span("lio.eskf.solve"):
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
            timing.sync_point("eskf_flags")  # the trip's host read, where the device catches up
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


MAP_CFG = vm.VoxelMapConfig(resolution=0.5, capacity=1 << 14, max_points=32, lookup_unique_cap=1024)
OFFSETS = ((0.05, -0.04, 0.02), (-0.03, 0.06, -0.01))  # prior minus truth, m, an update each

# name -> (dtype, LioConfig fields, whether GNSS extras are added): every
# measurement model and source mode, both dtypes, the extras, and an update
# that ends at max_iteration.
CASES = {
    "point_to_plane_f32": (torch.float32, {}, False),
    "point_to_plane_f64": (torch.float64, {}, False),
    "vgicp_neighborhood": (torch.float32, dict(measurement_model="vgicp", vgicp_source_mode="neighborhood"), False),
    "vgicp_isotropic": (torch.float32, dict(measurement_model="vgicp", vgicp_source_mode="isotropic"), False),
    "surfel": (torch.float32, dict(measurement_model="surfel"), False),
    "surfel_unweighted": (torch.float32, dict(measurement_model="surfel", surfel_conf_weight=False), False),
    "gnss_extras": (torch.float64, {}, True),
    "max_iteration": (torch.float64, dict(max_iteration=3), False),
}


def gnss_extras(prior: NavState, truth: np.ndarray, var: float = 0.01):
    """A position fix at `truth` as GNSS fusion adds it: H^T R^-1 H and
    H^T R^-1 (z - p) over the position block, R = var * I."""
    dtype, dev = prior.pos.dtype, prior.pos.device
    hth = torch.zeros((DIM_STATE, DIM_STATE), dtype=dtype, device=dev)
    hth[3:6, 3:6] = torch.eye(3, dtype=dtype, device=dev) / var
    hty = torch.zeros((DIM_STATE,), dtype=dtype, device=dev)
    hty[3:6] = (torch.as_tensor(truth, dtype=dtype, device=dev) - prior.pos) / var
    return hth, hty


def lio_case(device, dtype, n_raw=8192, seed=3, offsets=OFFSETS):
    """A map of three downsampled room scans (`chip_smoke.Scene`) and one
    update per offset: each a new scan seen from a true pose, and a prior
    that far off it and turned 0.02 rad. Returns (map, updates), each
    update a dict of `lio_update`'s first six arguments (`args`) and the
    true position (`truth`)."""
    scene = chip_smoke.Scene(n_raw, 32, seed=seed)
    lmap = vm.make_map(MAP_CFG, dtype, device=device)
    for _ in range(3):
        w = torch.as_tensor(scene.room_points(n_raw), dtype=dtype).to(device)
        pts, mask = voxelize.voxel_downsample(w, torch.ones(n_raw, dtype=torch.bool, device=device), 0.15, n_raw // 2)
        lmap = vm.insert(lmap, pts, mask, MAP_CFG)
    eye = torch.eye(3, dtype=dtype, device=device)
    zero = torch.zeros(3, dtype=dtype, device=device)
    updates = []
    for k, off in enumerate(offsets):
        truth = chip_smoke.pose_at(chip_smoke.HALF_DT) + np.array([0.05, -0.04, 0.02]) * (k + 1)
        body = torch.as_tensor(scene.room_points(n_raw) - truth, dtype=dtype).to(device)
        ds, ds_mask = voxelize.voxel_downsample(
            body, torch.ones(n_raw, dtype=torch.bool, device=device), 0.15, n_raw // 2
        )
        st = scene.initial_state()
        prior = NavState(**{k_: torch.as_tensor(v, dtype=dtype).to(device) for k_, v in st.items()})
        prior = prior._replace(
            rot=so3.exp(torch.tensor([0.0, 0.0, 0.02], dtype=dtype, device=device)),
            pos=torch.as_tensor(truth + np.asarray(off), dtype=dtype).to(device),
        )
        updates.append(dict(args=(prior, lmap, ds, ds_mask, eye, zero), truth=truth))
    return lmap, updates
