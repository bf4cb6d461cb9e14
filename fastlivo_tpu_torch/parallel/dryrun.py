"""Multi-device dry run (the counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`): one short pass through every
multi-device path, on the ranks of the current torch.distributed world.

    torchrun --nproc-per-node W -m fastlivo_tpu_torch.parallel.dryrun [--device cpu]

1. the sharded arena at 2^16 slots per rank (surfel): bootstrap, then one
   map-sharded step;
2. at W >= 4 (even), the same over a 2-D (2 x W/2) mesh;
3. points-sharded: the innovation summed over the ranks, the map
   replicated;
4. the LivoPipeline path: parallel.n_devices = W with map_sharded, a
   bootstrap and one update through `process_scan`;
5. the photometric VIO update, replicated on every rank: a rendered frame
   populates the visual map, the update on a second rendered view selects
   patches (n_selected > 0) and pulls the perturbed prior toward the truth.

Rank 0 prints one line with the results; any failed check raises. The
ranks run on the GPUs (NCCL, one rank per GPU) unless `--device cpu`
(gloo).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from fastlivo_tpu_torch import parallel
from fastlivo_tpu_torch.maps import visual_map as vmap_mod
from fastlivo_tpu_torch.maps import voxel_map as vm
from fastlivo_tpu_torch.models import lio as lio_mod
from fastlivo_tpu_torch.models import pipeline as pl_mod
from fastlivo_tpu_torch.models import vio as vio_mod
from fastlivo_tpu_torch.models.imu import ImuWindow
from fastlivo_tpu_torch.state import NavState


def make_inputs(n_pts, imu_m, device):
    """A floor-and-wall scan at rest with a matching IMU window, and a prior
    state (the JAX dry run's inputs)."""
    rng = np.random.default_rng(0)
    half = n_pts // 2
    floor = np.stack([rng.uniform(-4, 4, half), rng.uniform(-4, 4, half), np.full(half, -1.2)], 1)
    wall = np.stack(
        [np.full(n_pts - half, 3.5), rng.uniform(-4, 4, n_pts - half), rng.uniform(-1, 3, n_pts - half)], 1
    )

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    scan = pl_mod.ScanInput(
        pts=t(np.concatenate([floor, wall])),
        t_offs=t(np.sort(rng.uniform(0, 0.1, n_pts))),
        mask=torch.ones(n_pts, dtype=torch.bool, device=device),
        imu=ImuWindow(
            stamps=t(np.linspace(0, 0.1, imu_m)),
            gyr=t(np.tile([0.0, 0.0, 0.1], (imu_m, 1))),
            acc=t(np.tile([0.05, 0.0, 9.81], (imu_m, 1))),
            mask=torch.ones(imu_m, dtype=torch.bool, device=device),
        ),
        t_end=t(0.1), acc_scale=t(1.0),
    )
    state = NavState.identity(device=device)._replace(cov=torch.eye(18, device=device) * 1e-4)
    return state, scan


def _finite(x, what):
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"non-finite {what}")


def sharded_arena(world, device, i3, z3):
    """Modes 1 and 1b: map-sharded surfel steps on a 1-D and a 2-D mesh."""
    cfg = pl_mod.StepConfig(
        map_cfg=vm.VoxelMapConfig(resolution=0.25, capacity=1 << 16, max_points=8, nearby_type=18),
        lio_cfg=lio_mod.LioConfig(measurement_model="surfel"),
        ds_capacity=2048, imu_window=8, map_sharded=True,
    )
    state, scan = make_inputs(max(4096 // world, 1) * world, 8, device)
    out = {}
    meshes = [("1d", parallel.make_mesh(world))]
    if world >= 4 and world % 2 == 0:
        meshes.append(("2d", parallel.make_mesh_2d(2, world // 2)))
    for name, mesh in meshes:
        m = parallel.make_sharded_map(cfg.map_cfg, mesh, device=device)
        part = parallel.shard_scan(scan, mesh)
        boot = parallel.make_sharded_bootstrap(mesh, cfg)
        for _ in range(4):  # mature the surfel moments past min_points
            m = boot(m, part, state, i3, z3)
        s, m, info, _, _ = parallel.make_sharded_lio_step(mesh, cfg)(state, m, part, i3, z3)
        _finite(s.pos, f"state ({name} mesh)")
        occ = int(mesh.map_axis.psum(vm.num_occupied(m)))
        if occ <= 0:
            raise AssertionError(f"the sharded arena stored nothing ({name} mesh)")
        out[name] = dict(occupied=occ, n_eff=int(info.n_effective))
    return out


def points_sharded(world, device, i3, z3):
    """Mode 2: points sharded, innovation summed, map replicated."""
    cfg = pl_mod.StepConfig(
        map_cfg=vm.VoxelMapConfig(resolution=0.5, capacity=1 << 12, max_points=8, nearby_type=6,
                                  probe_depth=4),
        ds_capacity=64 * world, imu_window=8,
    )
    mesh = parallel.make_mesh(world)
    state, scan = make_inputs(128 * world, 8, device)
    m = pl_mod.bootstrap_map(vm.make_map(cfg.map_cfg, device=device), scan, state, i3, z3, cfg)
    s, m, info, _, _ = parallel.make_sharded_lio_step(mesh, cfg)(
        state, m, parallel.shard_scan(scan, mesh), i3, z3
    )
    _finite(s.pos, "state after the points-sharded step")
    return dict(n_eff=int(info.n_effective), map_points=int(vm.num_points(m)))


def pipeline_path(world, device):
    """Mode 3: LivoPipeline builds its mesh from cfg.parallel."""
    from fastlivo_tpu_torch.utils.config import load_config

    cfg = load_config(None, {
        "vio.img_enable": False, "lio.max_points": 1024, "lio.init_time": 0.0,
        "map.capacity": 1 << 12, "map.resolution": 0.25, "imu.imu_int_frame": 8,
        "parallel.n_devices": world, "parallel.map_sharded": True,
    })
    pipe = pl_mod.LivoPipeline(cfg, device=device)
    pipe.initializer.done = True
    _, scan = make_inputs(2048, 8, device)
    if pipe.process_scan(scan, 0.0) is not None:
        raise AssertionError("the first scan must only bootstrap the map")
    info = pipe.process_scan(scan, 0.1)
    if info is None:
        raise AssertionError("no update ran")
    _finite(pipe.state.pos, "pipeline state")
    occ = int(pipe.mesh.map_axis.psum(vm.num_occupied(pipe.map)))
    if occ <= 0:
        raise AssertionError("the pipeline's sharded arena stored nothing")
    return dict(occupied=occ, n_eff=int(info.n_effective), shards=pipe.n_map_shards)


def vio_replicated(device, i3, z3):
    """Mode 4: the photometric update on rendered frames, every rank alike."""
    from fastlivo_tpu_torch.io import render
    from fastlivo_tpu_torch.ops import image as img_ops
    from fastlivo_tpu_torch.ops.camera import Pinhole

    cam = Pinhole(width=320, height=256, fx=200.0, fy=200.0, cx=160.0, cy=128.0)
    vm_cfg = vmap_mod.VisualMapConfig(capacity=1024, max_obs=2)
    vio_cfg = vio_mod.VioConfig()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731

    # Frame 1 at the origin looking along +y (z up); rcw = R_wc^T.
    rot1 = t([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])
    pos1 = torch.zeros(3, device=device)
    rcw1, pcw1 = rot1.T, -(rot1.T @ pos1)
    img1 = render.render_room(cam, rcw1, pcw1)
    rng = np.random.default_rng(3)
    nf = 256
    floor = np.stack([rng.uniform(-4, 4, nf), rng.uniform(0, 8, nf), np.full(nf, -1.5)], 1)
    wall = np.stack([rng.uniform(-4, 4, nf), np.full(nf, 10.0), rng.uniform(-1, 3, nf)], 1)
    vpts = t(np.concatenate([floor, wall]))
    p_c1 = vpts @ rcw1.T + pcw1
    uv1 = cam.project(p_c1)
    vok = (p_c1[:, 2] > 0.5) & cam.in_frame(uv1, border=48)
    vmap = vmap_mod.add_points(
        vmap_mod.make_visual_map(vm_cfg, device=device), vm_cfg, vpts,
        img_ops.shi_tomasi_at(img1, uv1), vio_mod.stored_patch_pyramid(img1, uv1, vm_cfg),
        uv1, rcw1, pcw1, vok,
    )

    # Frame 2: the true pose moved, the prior a little off it.
    dr = np.array([[1.0, -0.02, 0.0], [0.02, 1.0, 0.0], [0.0, 0.0, 1.0]])
    u, _, vt = np.linalg.svd(dr)
    rot2 = rot1 @ t(u @ vt)
    pos2 = pos1 + t([0.08, 0.05, 0.02])
    rcw2, pcw2 = rot2.T, -(rot2.T @ pos2)
    img2 = render.render_room(cam, rcw2, pcw2)
    prior = NavState.identity(device=device)._replace(
        rot=rot2, pos=pos2 + t([0.02, -0.015, 0.01]), cov=torch.eye(18, device=device) * 1e-2,
    )
    post, _, info = vio_mod.vio_update(prior, vmap, img2, vpts, vok, cam, i3, z3, vm_cfg, vio_cfg)
    _finite(post.pos, "VIO state")
    n_sel = int(info.n_selected)
    if n_sel <= 0:
        raise AssertionError("the VIO update selected no candidates")
    err_prior = float(torch.linalg.vector_norm(prior.pos - pos2))
    err_post = float(torch.linalg.vector_norm(post.pos - pos2))
    if not err_post < err_prior:
        raise AssertionError(f"VIO did not pull toward the truth: {err_prior} -> {err_post}")
    return dict(n_selected=n_sel, err_prior_cm=err_prior * 100, err_post_cm=err_post * 100)


def dryrun(device) -> dict:
    """Every multi-device path once on this world's ranks; their results."""
    world = dist.get_world_size()
    i3 = torch.eye(3, device=device)
    z3 = torch.zeros(3, device=device)
    return dict(
        world=world, backend=dist.get_backend(),
        sharded_arena=sharded_arena(world, device, i3, z3),
        points_sharded=points_sharded(world, device, i3, z3),
        pipeline=pipeline_path(world, device),
        vio=vio_replicated(device, i3, z3),
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-device dry run on the torchrun world.")
    ap.add_argument("--device", default="cuda", help="cuda (the default; cuda:LOCAL_RANK) or cpu")
    args = ap.parse_args(argv)
    device_arg = None if args.device == "cuda" else args.device
    if not parallel.initialize_distributed(device=device_arg):
        raise SystemExit("run under torchrun: no WORLD_SIZE in the environment")
    try:
        from fastlivo_tpu_torch import device as _device

        out = dryrun(_device.resolve(device_arg))
        if dist.get_rank() == 0:
            print(f"dryrun({out['world']} ranks, {out['backend']}): OK {out}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
