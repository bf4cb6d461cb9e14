"""The per-scan and per-frame programs of the single-device LIVO cycle
(port of fastlivo_tpu/models/pipeline.py: `lio_scan_step` with the surfel
model, `vio_scan_step`, `bootstrap_map`, `step_summary`).

The chain per scan is the JAX package's:

    IMU propagate -> undistort -> voxel downsample -> iterated surfel ESKF
    -> health gate -> slab insert gate -> map insert

`LivoPipeline`, `lio_scan_multi` and the multi-device branches are later
slices (ROADMAP.md section 1, items 9 and 14).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch

from fastlivo_tpu_torch.maps import visual_map as vmap_mod
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import imu as imu_mod
from fastlivo_tpu_torch.models import lio
from fastlivo_tpu_torch.models import vio as vio_mod
from fastlivo_tpu_torch.ops import so3, voxelize
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.state import NavState

_NO_MULTI_DEVICE = (
    "multi-device steps (axis_name, map_sharded) are not ported to "
    "fastlivo_tpu_torch yet (ROADMAP.md section 1, item 14)"
)


@dataclass(frozen=True)
class StepConfig:
    """All static shapes/params of the per-scan program (same fields and
    defaults as the JAX package; `from_config` comes with the config
    module in a later slice)."""

    map_cfg: vm.VoxelMapConfig = field(default_factory=vm.VoxelMapConfig)
    lio_cfg: lio.LioConfig = field(default_factory=lio.LioConfig)
    ds_leaf: float = 0.15
    ds_capacity: int = 16384
    imu_window: int = 128
    cov_gyr: float = 0.01
    cov_acc: float = 0.01
    cov_bias_gyr: float = 1e-4
    cov_bias_acc: float = 1e-4
    cam: Optional[Pinhole] = None
    vio_cfg: vio_mod.VioConfig = field(default_factory=vio_mod.VioConfig)
    vm_cfg: vmap_mod.VisualMapConfig = field(default_factory=vmap_mod.VisualMapConfig)
    map_sharded: bool = False


class ScanInput(NamedTuple):
    """One LiDAR measurement group (fixed shapes, padded)."""

    pts: torch.Tensor  # (N, 3) raw points, LiDAR frame
    t_offs: torch.Tensor  # (N,)
    mask: torch.Tensor  # (N,)
    imu: imu_mod.ImuWindow
    t_end: torch.Tensor  # ()
    acc_scale: torch.Tensor  # ()


def _maybe_dedup(pts_w, mask, map_cfg):
    """Unique-voxel dedup shared between the insert gate and the insert."""
    n = pts_w.shape[0]
    cap = min(map_cfg.lookup_unique_cap or n, n)
    return vm.unique_voxels(vm.voxel_coord(pts_w, map_cfg.resolution), mask, cap)


def _propagate(state, scan: ScanInput, cfg: StepConfig):
    return imu_mod.propagate(
        state, scan.imu, scan.t_end, scan.acc_scale,
        cfg.cov_gyr, cfg.cov_acc, cfg.cov_bias_gyr, cfg.cov_bias_acc,
    )


def lio_scan_step(
    state: NavState,
    lidar_map: vm.VoxelHashMap,
    scan: ScanInput,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    extra_hth: Optional[torch.Tensor] = None,
    extra_hty: Optional[torch.Tensor] = None,
    axis_name: Optional[str] = None,
) -> Tuple[NavState, vm.VoxelHashMap, lio.LioInfo, Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One full scan-end measurement update (surfel model, one device).

    Returns (posterior state, updated map, LioInfo, (world_cloud,
    world_mask), packed summary — see `step_summary`). A rejected update
    (non-finite, or a correction above lio_cfg.max_jump_m) returns the
    propagated state and leaves the map untouched.
    """
    if axis_name is not None or cfg.map_sharded:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    if cfg.lio_cfg.measurement_model != "surfel":
        raise NotImplementedError(lio._NOT_PORTED.format(cfg.lio_cfg.measurement_model))
    state_prop, poses = _propagate(state, scan, cfg)
    pts_und = imu_mod.undistort(
        scan.pts, scan.t_offs, scan.mask, poses, state_prop, rot_il, t_il
    )
    ds_pts, ds_mask = voxelize.voxel_downsample(pts_und, scan.mask, cfg.ds_leaf, cfg.ds_capacity)

    posterior, info, _ = lio.lio_update(
        state_prop, lidar_map, ds_pts, ds_mask, rot_il, t_il, cfg.map_cfg, cfg.lio_cfg,
        extra_hth=extra_hth, extra_hty=extra_hty,
    )

    jump = torch.linalg.vector_norm(posterior.pos - state_prop.pos)
    finite = torch.all(torch.isfinite(posterior.pos)) & torch.all(torch.isfinite(posterior.cov))
    accept = finite & (jump <= cfg.lio_cfg.max_jump_m)
    posterior = NavState(*(torch.where(accept, a, b) for a, b in zip(posterior, state_prop)))

    _, p_w = lio.transform_to_world(ds_pts, posterior.rot, posterior.pos, rot_il, t_il)
    ds_mask = ds_mask & accept
    p_w = torch.where(torch.isfinite(p_w), p_w, 0.0)
    dd = _maybe_dedup(p_w, ds_mask, cfg.map_cfg)
    add = vm.slab_insert_gate(
        lidar_map, p_w, ds_mask, cfg.map_cfg,
        cfg.lio_cfg.filter_size_map, cfg.lio_cfg.num_match_points, dedup=dd,
    )
    lidar_map = vm.insert(lidar_map, p_w, add, cfg.map_cfg, dedup=dd)

    summary = step_summary(posterior, info, jump, accept)
    return posterior, lidar_map, info, (p_w, ds_mask), summary


def step_summary(state_out: NavState, info, jump: torch.Tensor, accept: torch.Tensor) -> torch.Tensor:
    """[pos(3), quat wxyz(4), n_eff, jump_m, accepted, res_mean]."""
    q = so3.rot_to_quat(state_out.rot)
    dtype = state_out.pos.dtype
    return torch.cat(
        [
            state_out.pos,
            q,
            torch.stack(
                [info.n_effective.to(dtype), jump, accept.to(dtype), info.res_mean]
            ),
        ]
    )


def vio_scan_step(
    state: NavState,
    visual_map: vmap_mod.VisualMap,
    scan: ScanInput,
    img: torch.Tensor,
    world_cloud: torch.Tensor,
    world_mask: torch.Tensor,
    rot_ci: torch.Tensor,
    t_ci: torch.Tensor,
    cfg: StepConfig,
) -> Tuple[NavState, vmap_mod.VisualMap, vio_mod.VioInfo, torch.Tensor]:
    """One image-bounded update: propagate to the image time, then the
    photometric iterated EKF against the last scan's world cloud. Returns
    (posterior, visual map, VioInfo, [pos(3), quat wxyz(4), n_selected])."""
    state_prop, _ = _propagate(state, scan, cfg)
    posterior, visual_map, info = vio_mod.vio_update(
        state_prop, visual_map, img, world_cloud, world_mask,
        cfg.cam, rot_ci, t_ci, cfg.vm_cfg, cfg.vio_cfg,
    )
    q = so3.rot_to_quat(posterior.rot)
    summary = torch.cat([posterior.pos, q, info.n_selected.to(posterior.pos.dtype)[None]])
    return posterior, visual_map, info, summary


def bootstrap_map(
    lidar_map: vm.VoxelHashMap,
    scan: ScanInput,
    state: NavState,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    axis_name: Optional[str] = None,
) -> vm.VoxelHashMap:
    """First-scan map initialization: downsample and insert at the current
    pose, no filter update."""
    if axis_name is not None or cfg.map_sharded:
        raise NotImplementedError(_NO_MULTI_DEVICE)
    ds_pts, ds_mask = voxelize.voxel_downsample(scan.pts, scan.mask, cfg.ds_leaf, cfg.ds_capacity)
    _, p_w = lio.transform_to_world(ds_pts, state.rot, state.pos, rot_il, t_il)
    return vm.insert(lidar_map, p_w, ds_mask, cfg.map_cfg)
