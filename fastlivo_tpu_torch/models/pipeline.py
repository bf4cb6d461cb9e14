"""The per-scan and per-frame programs of the LIVO cycle and the host
pipeline that drives them (port of fastlivo_tpu/models/pipeline.py:
`StepConfig` with `from_config`, `lio_scan_step` with every measurement
model, `lio_scan_multi`, `vio_scan_step`, `bootstrap_map`, `step_summary`
and `LivoPipeline`).

The chain per scan is the JAX package's:

    IMU propagate -> undistort -> voxel downsample -> iterated ESKF
    -> health gate -> insert gate -> map insert

`LivoPipeline` also carries the back end: GNSS fusion (an (18,18)/(18,)
observation block per scan, linearized at the propagated prior), the STD
loop-closure back end with its pose graph and visual gate, loop-corrected
map re-anchoring (`reanchor_map`) and the annotated-frame dump. Every
update's summary is read back on the host as the update ends.

Multi-device (`parallel`): one process per rank under torch.distributed,
every rank running the same pipeline on the same log. `axis_name` is a
`parallel.axis.Axis`: the scan points are sharded over it and the
innovations summed (map replicated), or, with `StepConfig.map_sharded`,
the arena is hash-partitioned over its innermost axis and the lookups
merge over it (a joined 2-D axis shards the queries over its outer axis).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from fastlivo_tpu_torch import device as _device
from fastlivo_tpu_torch.io import export
from fastlivo_tpu_torch.maps import visual_map as vmap_mod
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import imu as imu_mod
from fastlivo_tpu_torch.models import lio
from fastlivo_tpu_torch.models import vio as vio_mod
from fastlivo_tpu_torch.ops import so3, voxelize
from fastlivo_tpu_torch.ops.camera import Pinhole
from fastlivo_tpu_torch.parallel.axis import map_axis_of
from fastlivo_tpu_torch.state import NavState
from fastlivo_tpu_torch.utils import timing


@dataclass(frozen=True)
class StepConfig:
    """All static shapes/params of the per-scan program (same fields and
    defaults as the JAX package)."""

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

    @staticmethod
    def from_config(cfg) -> "StepConfig":
        """From a `utils.config.FastLivoConfig`."""
        par = cfg.parallel
        return StepConfig(
            map_sharded=bool(par.n_devices > 1 and par.map_sharded),
            cam=Pinhole.from_config(cfg.camera) if cfg.vio.img_enable else None,
            vio_cfg=vio_mod.VioConfig(
                grid_size=cfg.vio.grid_size,
                patch_size=cfg.vio.patch_size,
                max_iterations=cfg.vio.max_iterations,
                outlier_threshold=cfg.vio.outlier_threshold,
                img_point_cov=cfg.vio.img_point_cov,
                depth_continuous_thresh=cfg.vio.depth_continuous_thresh,
                ncc_en=cfg.vio.ncc_en,
                ncc_thre=cfg.vio.ncc_thre,
                levels=cfg.vio.pyr_levels,
                exposure_en=cfg.vio.exposure_en,
            ),
            vm_cfg=vmap_mod.VisualMapConfig(
                capacity=cfg.vio.max_visual_points,
                max_obs=cfg.vio.max_obs_per_point,
                patch_size=cfg.vio.patch_size,
            ),
            map_cfg=vm.VoxelMapConfig(
                resolution=cfg.map.resolution,
                capacity=cfg.map.capacity,
                max_points=cfg.map.max_points_per_voxel,
                nearby_type=cfg.map.nearby_type,
                probe_depth=cfg.map.probe_depth,
                surfel_decay=cfg.map.surfel_decay,
                surfel_freeze_n=cfg.map.surfel_freeze_n,
                lookup_unique_cap=cfg.map.lookup_unique_cap,
            ),
            lio_cfg=lio.LioConfig(
                max_iteration=cfg.lio.max_iteration,
                num_match_points=cfg.map.num_match_points,
                laser_point_cov=cfg.lio.laser_point_cov,
                plane_threshold=cfg.lio.plane_threshold,
                residual_limit=cfg.lio.residual_limit,
                converge_rot_deg=cfg.lio.converge_rot_deg,
                converge_trans_cm=cfg.lio.converge_trans_cm,
                filter_size_map=cfg.lio.filter_size_map,
                measurement_model=cfg.lio.measurement_model,
                max_jump_m=cfg.lio.max_jump_m,
                min_effective=cfg.lio.min_effective,
                vgicp_source_cov=cfg.lio.vgicp_source_cov,
                vgicp_source_mode=cfg.lio.vgicp_source_mode,
                vgicp_source_k=cfg.lio.vgicp_source_k,
                surfel_min_points=cfg.lio.surfel_min_points,
                surfel_planarity_max=cfg.lio.surfel_planarity_max,
                surfel_conf_weight=cfg.lio.surfel_conf_weight,
            ),
            ds_leaf=cfg.lio.filter_size_surf,
            ds_capacity=cfg.lio.max_points,
            imu_window=cfg.imu.imu_int_frame,
            cov_gyr=cfg.imu.cov_gyr,
            cov_acc=cfg.imu.cov_acc,
            cov_bias_gyr=cfg.imu.cov_bias_gyr,
            cov_bias_acc=cfg.imu.cov_bias_acc,
        )


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


def axis_roles(axis_name, cfg: StepConfig):
    """(map_axis, query_axis) of a step over `axis_name`: with
    cfg.map_sharded the innermost axis shards the arena and the outer one
    of a joined axis the queries; otherwise the queries shard over the
    whole axis and the map is replicated."""
    if axis_name is None:
        return None, None
    if cfg.map_sharded:
        return map_axis_of(axis_name), (axis_name.parts[0] if axis_name.parts else None)
    if axis_name.parts:
        raise ValueError("multi-axis meshes require cfg.map_sharded=True")
    return None, axis_name


def lio_scan_step(
    state: NavState,
    lidar_map: vm.VoxelHashMap,
    scan: ScanInput,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    extra_hth: Optional[torch.Tensor] = None,
    extra_hty: Optional[torch.Tensor] = None,
    axis_name=None,
) -> Tuple[NavState, vm.VoxelHashMap, lio.LioInfo, Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """One full scan-end measurement update.

    Returns (posterior state, updated map, LioInfo, (world_cloud,
    world_mask), packed summary — see `step_summary`). A rejected update
    (non-finite, or a correction above lio_cfg.max_jump_m) returns the
    propagated state and leaves the map untouched.

    With `axis_name` (an `Axis`): scan.pts/t_offs/mask are this rank's
    slice of the raw scan (`parallel.shard_scan`); state and extras are
    replicated. Undistortion runs on the slice; the undistorted scan is
    gathered and downsampled identically on every rank (a global voxel
    dedup, as on one device), then each rank takes its query slice (points
    mode) or keeps all of it (map-sharded). The returned world cloud is the
    rank's slice in points mode and the whole cloud in map-sharded mode.
    """
    map_axis, query_axis = axis_roles(axis_name, cfg)
    with timing.span("lio.propagate"):
        state_prop, poses = _propagate(state, scan, cfg)
    with timing.span("lio.undistort"):
        pts_und = imu_mod.undistort(
            scan.pts, scan.t_offs, scan.mask, poses, state_prop, rot_il, t_il, scan.imu.mask
        )
    with timing.span("lio.downsample"):
        if axis_name is None:
            ds_pts, ds_mask, ds_dropped = voxelize.voxel_downsample(
                pts_und, scan.mask, cfg.ds_leaf, cfg.ds_capacity, counted=True
            )
        else:
            ds_pts, ds_mask, ds_dropped = voxelize.voxel_downsample(
                axis_name.all_gather(pts_und), axis_name.all_gather(scan.mask), cfg.ds_leaf,
                cfg.ds_capacity, counted=True,
            )
            if query_axis is not None:
                shard = cfg.ds_capacity // query_axis.size
                lo = query_axis.index * shard
                ds_pts, ds_mask = ds_pts[lo: lo + shard], ds_mask[lo: lo + shard]

    with timing.span("lio.eskf"):
        posterior, info, (nbr, nv) = lio.lio_update(
            state_prop, lidar_map, ds_pts, ds_mask, rot_il, t_il, cfg.map_cfg, cfg.lio_cfg,
            extra_hth=extra_hth, extra_hty=extra_hty, axis_name=query_axis, map_axis=map_axis,
        )

    with timing.span("lio.insert"):
        lidar_map, p_w, ds_mask, jump, accept, posterior, counts = _gate_and_insert(
            state_prop, posterior, lidar_map, ds_pts, ds_mask, nbr, nv, rot_il, t_il, cfg,
            map_axis, query_axis,
        )
    summary = step_summary(posterior, info, jump, accept, (ds_dropped, *counts))
    return posterior, lidar_map, info, (p_w, ds_mask), summary


def _gate_and_insert(state_prop, posterior, lidar_map, ds_pts, ds_mask, nbr, nv, rot_il, t_il,
                     cfg: StepConfig, map_axis, query_axis):
    """The health gate, then the insert gate and the map insert of the
    accepted scan: (map, world cloud, its mask, jump, accept, posterior,
    the insert's `vm.InsertCounts`; a map-sharded arena counts this rank's
    shard)."""
    jump = torch.linalg.vector_norm(posterior.pos - state_prop.pos)
    finite = torch.all(torch.isfinite(posterior.pos)) & torch.all(torch.isfinite(posterior.cov))
    accept = finite & (jump <= cfg.lio_cfg.max_jump_m)
    posterior = NavState(*(torch.where(accept, a, b) for a, b in zip(posterior, state_prop)))

    _, p_w = lio.transform_to_world(ds_pts, posterior.rot, posterior.pos, rot_il, t_il)
    ds_mask = ds_mask & accept
    p_w = torch.where(torch.isfinite(p_w), p_w, 0.0)
    if cfg.lio_cfg.measurement_model == "surfel":
        # No kNN cache: gate on the point's own voxel slab. Every rank gates
        # and inserts the whole scan: a replicated map stays identical, and
        # a shard gates against its own voxels (a voxel it does not own
        # reads as empty, and the insert masks it off).
        p_w_ins, m_ins = p_w, ds_mask
        if query_axis is not None:
            p_w_ins, m_ins = query_axis.all_gather(p_w), query_axis.all_gather(ds_mask)
            if map_axis is not None:  # 2-D mesh: the returned cloud is whole too
                p_w, ds_mask = p_w_ins, m_ins
        dd = _maybe_dedup(p_w_ins, m_ins, cfg.map_cfg)
        add = vm.slab_insert_gate(
            lidar_map, p_w_ins, m_ins, cfg.map_cfg,
            cfg.lio_cfg.filter_size_map, cfg.lio_cfg.num_match_points, dedup=dd,
        )
    else:
        add = lio.map_insert_gate(p_w, ds_mask, nbr, nv, cfg.lio_cfg.filter_size_map)
        p_w_ins = p_w
        if query_axis is not None:
            p_w_ins, add = query_axis.all_gather(p_w), query_axis.all_gather(add)
            if map_axis is not None:
                p_w, ds_mask = p_w_ins, query_axis.all_gather(ds_mask)
        dd = None
    if map_axis is not None:  # as vm.sharded_insert: only this rank's voxels
        add = add & vm.owned_mask(p_w_ins, cfg.map_cfg.resolution, map_axis)
    lidar_map, counts = vm.insert(lidar_map, p_w_ins, add, cfg.map_cfg, dedup=dd, counted=True)
    return lidar_map, p_w, ds_mask, jump, accept, posterior, counts


def lio_scan_multi(
    state: NavState,
    lidar_map: vm.VoxelHashMap,
    scans: ScanInput,
    rot_il: torch.Tensor,
    t_il: torch.Tensor,
    cfg: StepConfig,
    axis_name=None,
) -> Tuple[NavState, vm.VoxelHashMap, torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K scan-end measurement updates chained: `scans` is a ScanInput whose
    leaves carry a leading K axis. Returns (posterior state, map, summaries
    (K, 15), (world clouds (K, N, 3), masks (K, N))), the results of K
    sequential `lio_scan_step` calls (the JAX package's scan-batched step;
    `LivoPipeline` calls `lio_scan_step` once per scan)."""
    summaries, clouds, masks = [], [], []
    for k in range(scans.pts.shape[0]):
        scan = ScanInput(
            pts=scans.pts[k], t_offs=scans.t_offs[k], mask=scans.mask[k],
            imu=imu_mod.ImuWindow(*(x[k] for x in scans.imu)),
            t_end=scans.t_end[k], acc_scale=scans.acc_scale[k],
        )
        state, lidar_map, _, (p_w, msk), summary = lio_scan_step(
            state, lidar_map, scan, rot_il, t_il, cfg, axis_name=axis_name
        )
        summaries.append(summary)
        clouds.append(p_w)
        masks.append(msk)
    return state, lidar_map, torch.stack(summaries), (torch.stack(clouds), torch.stack(masks))


# The counts that a LIO step's summary carries after its first 11 entries,
# in order, under the tracer's counter names (`LivoPipeline` adds them up):
# the voxels the downsample left out, and the insert's `vm.InsertCounts`.
SUMMARY_COUNTERS = ("lio.downsample.voxels_dropped", "map.points_added", "map.fresh_voxels",
                    "map.unclaimed_voxels")


def step_summary(state_out: NavState, info, jump: torch.Tensor, accept: torch.Tensor,
                 counts=()) -> torch.Tensor:
    """[pos(3), quat wxyz(4), n_eff, jump_m, accepted, res_mean], then
    `counts`, device scalars (`lio_scan_step` passes SUMMARY_COUNTERS')."""
    q = so3.rot_to_quat(state_out.rot)
    dtype = state_out.pos.dtype
    return torch.cat(
        [
            state_out.pos,
            q,
            torch.stack(
                [info.n_effective.to(dtype), jump, accept.to(dtype), info.res_mean,
                 *(x.to(dtype) for x in counts)]
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
    axis_name=None,
) -> vm.VoxelHashMap:
    """First-scan map initialization: downsample and insert at the current
    pose, no filter update. With `axis_name` the scan arrives sharded and
    is gathered first; a sharded arena inserts its owned voxels, replicas
    insert the whole scan."""
    pts, mask = scan.pts, scan.mask
    if axis_name is not None:
        pts, mask = axis_name.all_gather(pts), axis_name.all_gather(mask)
    ds_pts, ds_mask = voxelize.voxel_downsample(pts, mask, cfg.ds_leaf, cfg.ds_capacity)
    _, p_w = lio.transform_to_world(ds_pts, state.rot, state.pos, rot_il, t_il)
    if axis_name is not None and cfg.map_sharded:
        return vm.sharded_insert(lidar_map, p_w, ds_mask, cfg.map_cfg, map_axis_of(axis_name))
    return vm.insert(lidar_map, p_w, ds_mask, cfg.map_cfg)


def scan_to_device(scan: ScanInput, device) -> ScanInput:
    """A ScanInput with NumPy (or tensor) leaves, on `device`: one copy
    per leaf, each a host synchronization from pageable memory on the GPU
    (counted on every device)."""

    def t(x):
        timing.sync_point("to_device")
        return torch.as_tensor(x).to(device)

    with timing.span("pipeline.to_device"):
        return ScanInput(
            pts=t(scan.pts), t_offs=t(scan.t_offs), mask=t(scan.mask),
            imu=imu_mod.ImuWindow(*(t(x) for x in scan.imu)),
            t_end=t(scan.t_end), acc_scale=t(scan.acc_scale),
        )


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class LivoPipeline:
    """Host-side orchestrator: owns the device state and feeds the per-scan
    and per-frame programs the measurement groups of the synchronizer
    (`io.sync`), one group at a time.

    `device=None` means the GPU and raises without one. Every processed
    update leaves one small summary (pose, and the effective count or the
    selected-patch count), read back when the update ends and kept in
    `trajectory`, `n_effective` and `n_selected`. `lio.scan_batch` must be
    1: the JAX package's deferred reads of K summaries at a time are not
    ported.

    Multi-device (`cfg.parallel`): inside an initialised torch.distributed
    group every rank builds this pipeline on the same log and the scan step
    runs over the group's mesh (`mesh`): points-sharded with a replicated
    map, or, with parallel.map_sharded, over a hash-partitioned arena of
    map.capacity slots per rank. parallel.n_devices must equal the group's
    size; n_devices > 1 without a group raises (there is no silent
    single-rank run). VIO and the back end run replicated on every rank
    with identical inputs, but loop detections arrive on each rank's
    background thread when they finish: `reanchor_map` applies rank 0's
    decision and corrections on every rank. Only rank 0 writes files."""

    def __init__(self, cfg, dtype=torch.float32, device=None):
        if cfg.lio.scan_batch != 1:
            raise ValueError(
                f"lio.scan_batch is {cfg.lio.scan_batch}; the port reads each update's "
                "summary when the update ends and supports only lio.scan_batch 1"
            )
        self.device = _device.resolve(device)
        self.cfg = cfg
        self.step_cfg = StepConfig.from_config(cfg)
        self.dtype = dtype
        dev = self.device
        self.mesh = self._make_mesh(cfg.parallel)
        self.rank = 0 if self.mesh is None else self.mesh.axis.index

        rot = np.asarray(cfg.extrinsics.extrinsic_r, np.float32).reshape(3, 3)
        self.rot_il = torch.tensor(rot, dtype=dtype, device=dev)
        self.t_il = torch.tensor(cfg.extrinsics.extrinsic_t, dtype=dtype, device=dev)
        # Camera-IMU from camera-LiDAR and LiDAR-IMU: p_c = Rcl p_l + Pcl.
        rcl = np.asarray(cfg.camera.rcl, np.float32).reshape(3, 3)
        pcl = np.asarray(cfg.camera.pcl, np.float32)
        rot_ci = rcl @ rot.T
        self.rot_ci = torch.tensor(rot_ci, dtype=dtype, device=dev)
        self.t_ci = torch.tensor(
            pcl - rot_ci @ np.asarray(cfg.extrinsics.extrinsic_t, np.float32), dtype=dtype, device=dev
        )

        self.state = NavState.identity(dtype, dev)
        self.map = vm.make_map(self.step_cfg.map_cfg, dtype, dev)
        self.visual_map = vmap_mod.make_visual_map(self.step_cfg.vm_cfg, dtype, dev)
        self.initializer = imu_mod.StaticInitializer(
            init_count=cfg.imu.init_count, zero_velocity_thresh=cfg.imu.zero_velocity_thresh
        )
        self.first_scan = True
        self._first_scan_t: Optional[float] = None
        self._init_time = cfg.lio.init_time
        self.trajectory: list = []  # (t, pos, quat wxyz) per update, for TUM export
        self.n_effective: List[int] = []  # per LIO update
        self.n_selected: List[int] = []  # per VIO update
        # VIO updates before the first LIO update: they see no world cloud.
        self.vio_before_lio = 0
        self.health = {"rejected": 0, "low_constraint": 0, "resets": 0}
        self._min_effective = self.step_cfg.lio_cfg.min_effective
        # The last accepted scan's world cloud, for the next VIO frames.
        self.world_cloud = torch.zeros((self.step_cfg.ds_capacity, 3), dtype=dtype, device=dev)
        self.world_mask = torch.zeros((self.step_cfg.ds_capacity,), dtype=torch.bool, device=dev)
        # Insert epoch -> timestamp: every bootstrap and every scan step
        # inserts once (the arena epoch advances by one), so the list index
        # is the epoch; reanchor_map maps epochs to keyframe segments.
        self._epoch_stamps: List[float] = []
        self._last_vio_img: Optional[np.ndarray] = None  # for the loop gate
        self._img_frame_idx = 0
        # Ordinal of the last process_scan / process_image call: the update
        # id of the tracer's spans (utils.timing).
        self.n_updates = 0

        # Loop closure + pose graph back end; detection runs on a worker
        # thread unless loop.background is off, and finish() drains it.
        self.loop_backend = None
        if cfg.loop.loop_en:
            from fastlivo_tpu_torch.backend.loop_manager import LoopBackend

            self.loop_backend = LoopBackend(cfg, background=cfg.loop.background, device=dev)
        # GNSS fusion: observation blocks on the pipeline's device.
        self.gnss = None
        self.gnss_blocks = 0  # LIO updates that carried a GNSS block
        if cfg.gnss.gnss_en:
            from fastlivo_tpu_torch.models.gnss import GnssFusion

            self.gnss = GnssFusion(
                antlever=np.asarray(cfg.gnss.antenna_lever),
                outlier_gate_m=cfg.gnss.outlier_gate_m,
                init_window=cfg.gnss.init_window,
                device=dev,
            )
            if cfg.gnss.rtk_file:
                self.gnss.load_rtk_file(cfg.gnss.rtk_file)

    def _make_mesh(self, par):
        """The mesh of cfg.parallel inside an initialised process group, or
        None on a single process (the JAX package's checks first)."""
        import dataclasses

        import torch.distributed as dist

        n_dev = int(par.n_devices)
        if n_dev > 1:
            if par.n_hosts > 1 and not par.map_sharded:
                raise ValueError("parallel.n_hosts > 1 requires parallel.map_sharded")
            if n_dev % par.n_hosts:
                raise ValueError("n_devices must be divisible by n_hosts")
            mp = self.cfg.lio.max_points
            if (mp * 2) % n_dev or mp % n_dev:
                raise ValueError(
                    f"lio.max_points ({mp}) must be divisible by parallel.n_devices ({n_dev}) "
                    "for point sharding"
                )
        if not (dist.is_available() and dist.is_initialized()):
            if n_dev > 1:
                raise ValueError(
                    f"parallel.n_devices is {n_dev} but no torch.distributed process group is "
                    "initialised (a world of 1 process): start one rank per device, e.g. "
                    f"torchrun --nproc-per-node {n_dev} -m fastlivo_tpu_torch.run ..."
                )
            return None
        world = dist.get_world_size()
        if n_dev != world:
            raise ValueError(
                f"parallel.n_devices is {n_dev} but the torch.distributed process group has "
                f"{world} ranks"
            )
        from fastlivo_tpu_torch import parallel

        # In a group the mode follows map_sharded at any size, world 1 too.
        self.step_cfg = dataclasses.replace(self.step_cfg, map_sharded=bool(par.map_sharded))
        if par.n_hosts > 1:
            mesh = parallel.make_mesh_2d(par.n_hosts, n_dev // par.n_hosts)
        else:
            mesh = parallel.make_mesh(n_dev)
        self._sharded_step = parallel.make_sharded_lio_step(mesh, self.step_cfg)
        self._sharded_boot = parallel.make_sharded_bootstrap(mesh, self.step_cfg)
        return mesh

    @property
    def n_map_shards(self) -> int:
        """Shard count of the map arena (1: replicated or one device)."""
        if self.mesh is None or not self.step_cfg.map_sharded:
            return 1
        return self.mesh.map_axis.size

    def global_map(self) -> vm.VoxelHashMap:
        """The whole arena on every rank: the shards concatenated in rank
        order along the capacity axis (the JAX package's global array), or
        the map itself when it is not sharded. A collective: every rank
        calls it."""
        if self.n_map_shards == 1:
            return self.map
        ax = self.mesh.map_axis
        return vm.VoxelHashMap(*(x if x.ndim == 0 else ax.all_gather(x) for x in self.map))

    def place_map(self, m: vm.VoxelHashMap) -> vm.VoxelHashMap:
        """This rank's part of a whole arena (`global_map`'s layout): its
        shard's rows, or the arena itself when it is not sharded."""
        if self.n_map_shards == 1:
            return m
        ax = self.mesh.map_axis
        return vm.VoxelHashMap(*(
            x if x.ndim == 0 else x.reshape(ax.size, -1, *x.shape[1:])[ax.index].clone()
            for x in m
        ))

    def _lio_step(self, scan: ScanInput, extra=None):
        """One scan step; the returned world cloud is the whole cloud on
        every rank (in points mode each rank's step returns its slice, and
        VIO and the loop back end need all of it)."""
        if self.mesh is None:
            return lio_scan_step(
                self.state, self.map, scan, self.rot_il, self.t_il, self.step_cfg,
                extra_hth=None if extra is None else extra[0],
                extra_hty=None if extra is None else extra[1],
            )
        from fastlivo_tpu_torch import parallel

        state, m, info, (cloud, mask), summary = self._sharded_step(
            self.state, self.map, parallel.shard_scan(scan, self.mesh), self.rot_il, self.t_il,
            *(extra or ()),
        )
        if not self.step_cfg.map_sharded:
            cloud, mask = self.mesh.axis.all_gather(cloud), self.mesh.axis.all_gather(mask)
        return state, m, info, (cloud, mask), summary

    def _bootstrap(self, scan: ScanInput) -> vm.VoxelHashMap:
        if self.mesh is None:
            return bootstrap_map(self.map, scan, self.state, self.rot_il, self.t_il, self.step_cfg)
        from fastlivo_tpu_torch import parallel

        return self._sharded_boot(
            self.map, parallel.shard_scan(scan, self.mesh), self.state, self.rot_il, self.t_il
        )

    def _init_feed(self, scan: ScanInput):
        mask = _host(scan.imu.mask)
        if self.initializer.push(_host(scan.imu.gyr)[mask], _host(scan.imu.acc)[mask]):
            self.state = self.initializer.initial_state(self.dtype, self.device)

    def _advance(self, scan: ScanInput):
        """Propagate through a group's IMU window without a measurement
        update: the window builder's clock moves on whether or not an
        update runs."""
        self.state, _ = imu_mod.propagate(self.state, scan.imu, scan.t_end, scan.acc_scale)

    def _record(self, t_abs: float, summary: torch.Tensor) -> np.ndarray:
        """One host read of a step summary; its pose joins the trajectory."""
        timing.sync_point("readback")
        with timing.span("pipeline.readback"):
            s = summary.cpu().numpy()
        self.trajectory.append((t_abs, s[0:3], s[3:7]))
        return s

    def process_scan(self, scan: ScanInput, t_abs: float):
        """Feed one scan-end measurement group. Returns LioInfo, or None
        during static initialization and the EKF warm-up."""
        self.n_updates += 1
        with timing.span("pipeline.process_scan", update=self.n_updates):
            return self._process_scan(scan, t_abs)

    def _process_scan(self, scan: ScanInput, t_abs: float):
        if not self.initializer.done:
            self._init_feed(scan)
            return None
        scan = scan_to_device(scan, self.device)
        if self.first_scan:
            self._first_scan_t = t_abs
        # EKF warm-up: propagate and insert, no update, until init_time has
        # passed since the first scan.
        if self.first_scan or (
            self._first_scan_t is not None and t_abs - self._first_scan_t < self._init_time
        ):
            self._advance(scan)
            self.map = self._bootstrap(scan)
            self._epoch_stamps.append(t_abs)
            self.first_scan = False
            return None

        prev_cloud = (self.world_cloud, self.world_mask)
        extra = None
        if self.gnss is not None:
            # The GNSS block is linearized at the propagated prior: one
            # extra propagate and one host read of (rot, pos) per scan.
            sp, _ = _propagate(self.state, scan, self.step_cfg)
            timing.sync_point("gnss_prior", 2)
            extra = self.gnss.observe(t_abs, _host(sp.rot), _host(sp.pos))
            self.gnss_blocks += extra is not None
        self.state, self.map, info, (self.world_cloud, self.world_mask), summary = self._lio_step(
            scan, extra
        )
        timing.count("pipeline.lio_updates")
        self._epoch_stamps.append(t_abs)
        s = self._record(t_abs, summary)
        n_eff, accepted = int(s[7]), bool(s[9] > 0.5)
        for name, n in zip(SUMMARY_COUNTERS, s[11:]):
            timing.count(name, int(n))
        self.n_effective.append(n_eff)
        # The health gate ran on the device (a rejected update returned the
        # propagated state and left the map untouched); here the counters
        # and the world-cloud rollback to the last accepted scan.
        if n_eff < self._min_effective:
            self.health["low_constraint"] += 1
        if not accepted:
            self.health["rejected"] += 1
            self.health["resets"] += 1
            self.world_cloud, self.world_mask = prev_cloud
        if self.loop_backend is not None:
            # One device-to-host copy of the masked world cloud per scan,
            # and one of the attitude.
            timing.sync_point("loop_cloud", 2)
            wc = self.world_cloud[self.world_mask].cpu().numpy()
            self.loop_backend.on_scan(
                _host(self.state.rot), s[0:3], wc, stamp=t_abs, img=self._last_vio_img,
            )
        return info

    def process_image(self, scan: ScanInput, img, t_abs: float):
        """Feed one image-bounded measurement group (VIO update at the image
        time). Returns VioInfo, or None before initialization."""
        self.n_updates += 1
        with timing.span("pipeline.process_image", update=self.n_updates):
            return self._process_image(scan, img, t_abs)

    def _process_image(self, scan: ScanInput, img, t_abs: float):
        if not self.initializer.done:
            # Image-bounded groups carry part of each sweep's IMU window;
            # the static initialization needs them too.
            self._init_feed(scan)
            return None
        scan = scan_to_device(scan, self.device)
        if self.step_cfg.cam is None or self.first_scan:
            self._advance(scan)
            return None
        with timing.span("pipeline.image_to_device"):
            self._last_vio_img = np.asarray(_host(img), dtype=np.float32)
            img = torch.tensor(self._last_vio_img, dtype=self.dtype, device=self.device)
        self.state, self.visual_map, info, summary = vio_scan_step(
            self.state, self.visual_map, scan, img, self.world_cloud, self.world_mask,
            self.rot_ci, self.t_ci, self.step_cfg,
        )
        timing.count("pipeline.vio_updates")
        if self.cfg.runtime.img_save_en and self.rank == 0:
            self._dump_annotated_frame(img)
        n_sel = int(self._record(t_abs, summary)[7])
        self.n_selected.append(n_sel)
        timing.count("vio.selected", n_sel)
        self.vio_before_lio += not self.n_effective
        return info

    def _dump_annotated_frame(self, img: torch.Tensor):
        """Keypatch-annotated frame to <runtime.out_dir>/img/ (the
        reference's /rgb_img stream). Debug path: one candidate re-selection
        and one host read per frame."""
        from fastlivo_tpu_torch.io import annotate

        uv, valid, inlier = vio_mod.candidate_overlay(
            self.state, self.visual_map, img, self.world_cloud, self.world_mask,
            self.step_cfg.cam, self.rot_ci, self.t_ci, self.step_cfg.vm_cfg, self.step_cfg.vio_cfg,
        )
        annotate.save_annotated(
            self.cfg.runtime.out_dir, self._img_frame_idx, self._last_vio_img,
            _host(uv), _host(valid), _host(inlier),
        )
        self._img_frame_idx += 1

    def reanchor_map(self) -> bool:
        """Re-anchor the live voxel arena with the loop-corrected keyframe
        poses: every arena point moves by the rigid correction of the
        keyframe nearest in time to its insert epoch, and the arena is
        rebuilt by `vm.reanchor`. Returns True if a correction was applied.

        In a process group every rank calls it, and rank 0 decides: it
        drains its loop back end's pending detections, and its go/no-go and
        corrections are broadcast. A rank whose background detections lag
        (or whose loops differ) thus applies the same corrections as the
        others, so the replicas stay equal and the shards' collectives
        match."""
        if self.mesh is None:
            corr = self._loop_corrections()
        else:
            if self.loop_backend is not None:
                self.loop_backend.drain()
            corr = self._replicate_corrections(self._loop_corrections() if self.rank == 0 else None)
        if corr is None:
            return False
        seg, r_seg, t_seg, newest_stamp = corr
        dev = self.device
        # A sharded arena re-inserts each corrected chunk on its new owner
        # (corrections move points across voxel and shard boundaries).
        sharded = {"axis": self.mesh.map_axis} if self.mesh is not None and self.step_cfg.map_sharded else {}
        self.map = vm.reanchor(
            self.map,
            self.step_cfg.map_cfg,
            torch.as_tensor(seg, dtype=torch.int32, device=dev),
            torch.as_tensor(r_seg, dtype=self.dtype, device=dev),
            torch.as_tensor(t_seg, dtype=self.dtype, device=dev),
            **sharded,
        )
        # The rebuild advances the epoch by its chunk count; the re-anchored
        # content is attributed to the newest keyframe (consistent with the
        # corrected trajectory), so a second correction segments correctly.
        new_epoch = int(self.map.epoch)
        if new_epoch > len(self._epoch_stamps):
            self._epoch_stamps.extend([newest_stamp] * (new_epoch - len(self._epoch_stamps)))
        return True

    def _loop_corrections(self):
        """From the loop back end's corrected keyframes: (seg_of_epoch (E,),
        r_seg (K, 3, 3), t_seg (K, 3), the newest keyframe's stamp), or None
        when there is nothing to correct."""
        if self.loop_backend is None or not self.loop_backend.loops:
            return None
        if not self._epoch_stamps:
            return None
        g = self.loop_backend.graph
        rots_c, trans_c = self.loop_backend.corrected_trajectory()
        rots_d = np.asarray(g.rots)
        trans_d = np.asarray(g.trans)
        kf_stamps = np.asarray(g.stamps)
        if len(kf_stamps) == 0:
            return None
        # Per-keyframe rigid correction: corrected = R_seg @ drifted + t_seg.
        r_seg = rots_c @ rots_d.transpose(0, 2, 1)
        t_seg = trans_c - np.einsum("kij,kj->ki", r_seg, trans_d)
        # Each insert epoch goes to the nearest keyframe by timestamp.
        ep = np.asarray(self._epoch_stamps)
        hi = np.clip(np.searchsorted(kf_stamps, ep), 0, len(kf_stamps) - 1)
        lo = np.clip(hi - 1, 0, len(kf_stamps) - 1)
        seg = np.where(np.abs(ep - kf_stamps[lo]) < np.abs(ep - kf_stamps[hi]), lo, hi)
        return seg, r_seg, t_seg, float(kf_stamps[-1])

    def _replicate_corrections(self, corr):
        """Rank 0's `_loop_corrections` on every rank (None on every rank
        when rank 0 has none): two broadcasts, a header of (go, E, K, newest
        stamp) and then, on go, the corrections packed in f64."""
        ax = self.mesh.axis
        head = torch.zeros(4, dtype=torch.float64, device=self.device)
        if corr is not None:
            head = torch.tensor([1.0, len(corr[0]), len(corr[1]), corr[3]], dtype=torch.float64,
                                device=self.device)
        go, n_ep, k, newest_stamp = ax.broadcast(head).tolist()
        if not go:
            return None
        n_ep, k = int(n_ep), int(k)
        if corr is not None:
            body = np.concatenate([corr[0].ravel(), corr[1].ravel(), corr[2].ravel()])
            body = torch.as_tensor(body, dtype=torch.float64, device=self.device)
        else:
            body = torch.zeros(n_ep + 12 * k, dtype=torch.float64, device=self.device)
        body = ax.broadcast(body).cpu().numpy()
        return (body[:n_ep].astype(np.int64), body[n_ep: n_ep + 9 * k].reshape(k, 3, 3),
                body[n_ep + 9 * k:].reshape(k, 3), newest_stamp)

    def map_cloud(self) -> np.ndarray:
        """Every point stored in the arena, (N, 3) f32 on the host; a sharded
        arena's shards are gathered in rank order (a collective)."""
        cloud = export.map_to_cloud(self.map)
        if self.n_map_shards == 1:
            return cloud
        local = torch.as_tensor(cloud).to(self.device)
        return self.mesh.map_axis.all_gather_ragged(local).cpu().numpy()

    def finish(self, out_dir: Optional[str] = None):
        """End-of-run outputs: drain the loop back end, then write
        `tum.txt`, `loop_tum.txt` (the loop-corrected keyframes, when the
        back end ran) and `map.pcd` to out_dir (when given; on rank 0 only,
        every rank gathering the map cloud). Returns the corrected keyframe
        trajectory (rots, trans), or None."""
        corrected = None
        if self.loop_backend is not None:
            self.loop_backend.finish()
            corrected = self.loop_backend.corrected_trajectory()
        if out_dir is not None:
            cloud = self.map_cloud()
        if out_dir is not None and self.rank == 0:
            os.makedirs(out_dir, exist_ok=True)
            export.write_tum(os.path.join(out_dir, "tum.txt"), self.trajectory)
            if corrected is not None and len(corrected[1]):
                rots, trans = corrected
                stamps = self.loop_backend.graph.stamps
                quats = so3.rot_to_quat(torch.as_tensor(np.asarray(rots), dtype=torch.float32)).numpy()
                traj = [
                    (stamps[i] if i < len(stamps) else float(i), trans[i], quats[i])
                    for i in range(len(trans))
                ]
                export.write_tum(os.path.join(out_dir, "loop_tum.txt"), traj)
            export.write_pcd(os.path.join(out_dir, "map.pcd"), cloud)
        return corrected

    @property
    def acc_scale(self) -> float:
        return self.initializer.acc_scale if self.initializer.done else 1.0
