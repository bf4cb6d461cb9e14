"""Multi-device execution of the LIVO step (port of
fastlivo_tpu/parallel/sharded.py).

The JAX package runs one controller over a `Mesh` and `jax.shard_map`s the
step; here every rank is a process of a torch.distributed group that runs
the same step on its share, with the collectives of `parallel.axis`. Two
modes, as in JAX:

**Points-sharded, replicated map** (map_sharded False): each rank
undistorts its slice of the raw scan; the undistorted scan is gathered and
downsampled identically everywhere; each rank takes its slice of the
downsampled scan for the kNN, plane-fit and Jacobian work, and the
innovation (6x6 + 6) is summed over the ranks before the replicated 18x18
solve. Every rank inserts the whole gathered scan, so the replicas stay
identical.

**Sharded map arena** (map_sharded True): the arena is hash-partitioned by
voxel ownership (`maps.voxel_map.owner_of`); `map_cfg.capacity` is the
per-rank capacity. The downsampled scan is replicated, per-shard lookups
merge with collectives, and inserts are shard-local.

A 2-D mesh (`make_mesh_2d`, a `DeviceMesh` of ("hosts", "points")) shards
the arena over "points" and the queries over "hosts" (map_sharded only).

"Compiling" a step here binds the axis roles; the returned callables take
the arguments of the JAX ones, with this rank's slice of the scan
(`shard_scan`) and this rank's shard of the arena (`make_sharded_map`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import pipeline as pl_mod
from fastlivo_tpu_torch.parallel.axis import Axis, map_axis_of

POINTS_AXIS = "points"
HOSTS_AXIS = "hosts"


class Mesh:
    """The port's mesh: `axis` spans every rank of the mesh (the axis the
    raw scan shards over; joined on a 2-D mesh), `map_axis` is its
    innermost axis (the one a sharded arena partitions over);
    `device_mesh` is the 2-D mesh's `DeviceMesh`."""

    def __init__(self, axis: Axis, device_mesh=None):
        self.axis = axis
        self.map_axis = map_axis_of(axis)
        self.device_mesh = device_mesh


def _world_size(what: str) -> int:
    if not dist.is_initialized():
        raise ValueError(f"{what} needs an initialised torch.distributed process group "
                         "(parallel.initialize_distributed, or torchrun)")
    return dist.get_world_size()


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over every rank of the process group (the points axis).
    `n_devices`, when given, must be the group's size."""
    world = _world_size("make_mesh")
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process group of that size; "
                         f"the group has {world} ranks")
    return Mesh(Axis(None, POINTS_AXIS))


def make_mesh_2d(n_hosts: int, n_chips: int) -> Mesh:
    """2-D (hosts x chips) mesh: a `DeviceMesh` whose rank r sits at
    (r // n_chips, r % n_chips). The arena shards over the inner "points"
    axis, the queries and the innovation sum over the outer "hosts" axis."""
    from torch.distributed.device_mesh import init_device_mesh

    world = _world_size("make_mesh_2d")
    if n_hosts * n_chips != world:
        raise ValueError(f"a {n_hosts} x {n_chips} mesh needs {n_hosts * n_chips} ranks; "
                         f"the group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (n_hosts, n_chips), mesh_dim_names=(HOSTS_AXIS, POINTS_AXIS))
    hosts = Axis(dm.get_group(HOSTS_AXIS), HOSTS_AXIS)
    chips = Axis(dm.get_group(POINTS_AXIS), POINTS_AXIS)
    return Mesh(Axis.joined(hosts, chips), device_mesh=dm)


def shard_scan(scan: pl_mod.ScanInput, mesh: Mesh) -> pl_mod.ScanInput:
    """This rank's contiguous slice of the scan's points (pts, t_offs,
    mask); the IMU window and the scalars stay whole."""
    n = scan.pts.shape[0]
    size, idx = mesh.axis.size, mesh.axis.index
    if n % size:
        raise ValueError(f"{n} raw points do not split over {size} ranks: pad the scan budget")
    per = n // size
    part = slice(idx * per, (idx + 1) * per)
    return scan._replace(pts=scan.pts[part], t_offs=scan.t_offs[part], mask=scan.mask[part])


def make_sharded_map(map_cfg: vm.VoxelMapConfig, mesh: Mesh, dtype=torch.float32,
                     device=None) -> vm.VoxelHashMap:
    """This rank's empty shard of a map-sharded arena: `map_cfg.capacity`
    slots (the global arena holds capacity x shards, shard-major)."""
    del mesh  # every shard has the local capacity
    return vm.make_map(map_cfg, dtype, device)


def make_sharded_lio_step(mesh: Mesh, cfg: pl_mod.StepConfig):
    """The per-scan step over `mesh`: `step(state, map, scan, rot_il, t_il,
    extra_hth=None, extra_hty=None)` with this rank's scan slice, returning
    what `pipeline.lio_scan_step` returns. The optional extras (replicated
    (18, 18) and (18,), the GNSS block) are added after the innovation sum,
    so they count once."""
    if mesh.axis.parts and not cfg.map_sharded:
        raise ValueError("multi-axis meshes require cfg.map_sharded=True")
    axis = mesh.axis

    def step(state, m, scan, rot_il, t_il, extra_hth=None, extra_hty=None):
        return pl_mod.lio_scan_step(state, m, scan, rot_il, t_il, cfg, extra_hth=extra_hth,
                                    extra_hty=extra_hty, axis_name=axis)
    return step


def make_sharded_bootstrap(mesh: Mesh, cfg: pl_mod.StepConfig):
    """First-scan map init over `mesh`: `boot(map, scan, state, rot_il,
    t_il)` with this rank's scan slice."""
    axis = mesh.axis

    def boot(m, scan, state, rot_il, t_il):
        return pl_mod.bootstrap_map(m, scan, state, rot_il, t_il, cfg, axis_name=axis)
    return boot


def make_sharded_reanchor(mesh: Mesh, cfg: pl_mod.StepConfig, chunk: int = 65536):
    """Loop-corrected re-anchoring of a sharded arena: `re(map,
    seg_of_epoch, rots, trans)`, the corrections replicated. Each
    transformed chunk is gathered and inserted shard-locally, so an
    ownership change drops no point."""
    if not cfg.map_sharded:
        raise ValueError("make_sharded_reanchor requires cfg.map_sharded=True")
    axis = mesh.map_axis

    def re(m, seg_of_epoch, rots, trans):
        return vm.reanchor(m, cfg.map_cfg, seg_of_epoch, rots, trans, chunk=chunk, axis=axis)
    return re
