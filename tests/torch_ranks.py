"""Rank processes for the port's multi-rank tests: gloo worlds on the CPU.

This module imports no jax: `World` spawns each rank as a fresh process
that imports only torch, numpy, the port and `chip_smoke` (no jax either). A world meets through a
FileStore in its work directory (no TCP port, so concurrent test workers
never collide), runs a list of jobs in order on every rank, and writes each
rank's results (numpy) or its traceback there. The parent starts a world,
computes its JAX references meanwhile, and collects the ranks' results.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

JOBS = {}


def job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _rank_main(rank, world, workdir, jobs):
    torch.set_num_threads(1)
    results = []
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
            rank=rank, world_size=world, timeout=timedelta(seconds=120),
        )
        for name, kwargs in jobs:
            results.append(JOBS[name](**kwargs))
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """`world` gloo ranks running `jobs` ([(job name, kwargs)], in order)."""

    def __init__(self, world: int, workdir, jobs):
        self.workdir = str(workdir)
        os.makedirs(self.workdir, exist_ok=True)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, world, self.workdir, jobs), daemon=True)
            for r in range(world)
        ]
        for p in self.procs:
            p.start()

    def results(self, timeout: float = 300.0):
        """Every rank's job results (a list in job order), in rank order;
        raises with the ranks' tracebacks when one failed or the world
        outlived `timeout`."""
        deadline = time.monotonic() + timeout
        for p in self.procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.workdir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errors.append(f"rank {r}: exit code {p.exitcode}")
        if hung or errors:
            raise AssertionError(f"ranks {hung} still running after {timeout} s\n" * bool(hung)
                                 + "\n".join(errors))
        out = []
        for r in range(len(self.procs)):
            with open(os.path.join(self.workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


# ---------------------------------------------------------------------------
# Jobs. Inputs arrive as numpy (and the port's config dataclasses); results
# leave as numpy.
# ---------------------------------------------------------------------------


def _np(tup):
    return {k: v.detach().cpu().numpy() for k, v in tup._asdict().items()}


def _scan(d):
    from fastlivo_tpu_torch.models.imu import ImuWindow
    from fastlivo_tpu_torch.models.pipeline import ScanInput

    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    return ScanInput(
        pts=t(d["pts"]), t_offs=t(d["t_offs"]), mask=t(d["mask"]),
        imu=ImuWindow(**{k: t(v) for k, v in d["imu"].items()}),
        t_end=t(d["t_end"]), acc_scale=t(d["acc_scale"]),
    )


def _state(d):
    from fastlivo_tpu_torch import convert

    return convert.nav_state_from_numpy(d, "cpu")


_I3 = lambda: torch.eye(3)  # noqa: E731
_Z3 = lambda: torch.zeros(3)  # noqa: E731


@job
def bootstrap_shards(scan, state, cfg):
    """Bootstrap a map-sharded arena from one scan; this rank's shard."""
    from fastlivo_tpu_torch import parallel

    mesh = parallel.make_mesh()
    m = parallel.make_sharded_map(cfg.map_cfg, mesh, device="cpu")
    m = parallel.make_sharded_bootstrap(mesh, cfg)(
        m, parallel.shard_scan(_scan(scan), mesh), _state(state), _I3(), _Z3()
    )
    return _np(m)


@job
def step_run(scans, state, cfg, n_hosts=1):
    """Bootstrap on scans[0], then one sharded step per later scan. Per
    step: the summary and the world cloud; the map after bootstrap and at
    the end; the collectives run."""
    from fastlivo_tpu_torch import parallel

    world = dist.get_world_size()
    mesh = parallel.make_mesh_2d(n_hosts, world // n_hosts) if n_hosts > 1 else parallel.make_mesh(world)
    m = parallel.make_sharded_map(cfg.map_cfg, mesh, device="cpu")
    st = _state(state)
    m = parallel.make_sharded_bootstrap(mesh, cfg)(
        m, parallel.shard_scan(_scan(scans[0]), mesh), st, _I3(), _Z3()
    )
    boot = _np(m)
    step = parallel.make_sharded_lio_step(mesh, cfg)
    steps = []
    for sc in scans[1:]:
        st, m, info, (wc, wm), summary = step(st, m, parallel.shard_scan(_scan(sc), mesh), _I3(), _Z3())
        steps.append(dict(summary=summary.numpy(), n_eff=int(info.n_effective), cloud=wc.numpy()))
    return dict(boot=boot, map=_np(m), state=_np(st), steps=steps, collectives=dict(mesh.axis.counts))


@job
def insert_and_lookup(map_pts, map_mask, queries, map_cfg, k, max_dist2, min_points, planarity_max):
    """Insert replicated points into this rank's shard, then the merged
    surfel lookup and kNN of replicated queries."""
    from fastlivo_tpu_torch import parallel
    from fastlivo_tpu_torch.maps import voxel_map as vm

    ax = parallel.make_mesh().map_axis
    m = vm.sharded_insert(vm.make_map(map_cfg, device="cpu"), torch.as_tensor(map_pts),
                          torch.as_tensor(map_mask), map_cfg, ax)
    q = torch.as_tensor(queries)
    surf = vm.sharded_surfel_lookup(m, q, map_cfg, ax, min_points, planarity_max)
    nbr, d2, valid = vm.sharded_knn(m, q, map_cfg, ax, k=k, max_dist2=max_dist2)
    return dict(map=_np(m), surf=_np(surf), nbr=nbr.numpy(), d2=d2.numpy(), valid=valid.numpy())


@job
def nan_padding_insert(map_pts, map_mask, pts, mask, map_cfg):
    """A sharded insert whose masked padding lanes hold NaN."""
    from fastlivo_tpu_torch import parallel
    from fastlivo_tpu_torch.maps import voxel_map as vm

    ax = parallel.make_mesh().map_axis
    m = vm.sharded_insert(vm.make_map(map_cfg, device="cpu"), torch.as_tensor(map_pts),
                          torch.as_tensor(map_mask), map_cfg, ax)
    m = vm.sharded_insert(m, torch.as_tensor(pts), torch.as_tensor(mask), map_cfg, ax)
    return _np(m)


@job
def global_mesh_slice(scan):
    """`make_global_mesh` and `host_local_slice` on this rank: the axis's
    index and size, the slice's bounds, and whether `shard_scan` over the
    global mesh took exactly that slice of the points."""
    from fastlivo_tpu_torch import parallel

    mesh = parallel.make_global_mesh()
    sc = _scan(scan)
    part = parallel.host_local_slice(sc.pts.shape[0])
    mine = parallel.shard_scan(sc, mesh)
    return dict(index=mesh.axis.index, size=mesh.axis.size, start=part.start, stop=part.stop,
                same=bool(torch.equal(mine.pts, sc.pts[part]) and torch.equal(mine.mask, sc.mask[part])))


@job
def reanchor_run(pts, mask, map_cfg, step_cfg, rot, trans, chunk):
    """Insert replicated points into this rank's shard, then re-anchor the
    sharded arena with one rigid correction."""
    from fastlivo_tpu_torch import parallel
    from fastlivo_tpu_torch.maps import voxel_map as vm

    mesh = parallel.make_mesh()
    m = vm.sharded_insert(vm.make_map(map_cfg, device="cpu"), torch.as_tensor(pts),
                          torch.as_tensor(mask), map_cfg, mesh.map_axis)
    before = _np(m)
    m = parallel.make_sharded_reanchor(mesh, step_cfg, chunk=chunk)(
        m, torch.zeros((1024,), dtype=torch.int32), torch.as_tensor(rot)[None],
        torch.as_tensor(trans)[None],
    )
    return dict(before=before, after=_np(m))


@job
def run_log_job(log, overrides, out_dir=None, checkpoint_every=None, checkpoint_path=None,
                resume_from=None, mismatch_overrides=None, reanchor_shift=None, via_main=False):
    """`run.run_log` on this rank (the pipeline builds its mesh from the
    world); the trajectory rows and the pipeline's shard count. With
    `mismatch_overrides`, a pipeline of that config then loads
    `checkpoint_path` and the error message is returned. With
    `reanchor_shift` (and the loop back end on), then
    `chip_smoke.reanchor_with_rank0_loop`'s results under "reanchor".
    `via_main` runs the CLI's entry `run.main` instead (overrides as
    `--set`), and records whether the world's group survived it."""
    from fastlivo_tpu_torch import run
    from fastlivo_tpu_torch.models.pipeline import LivoPipeline
    from fastlivo_tpu_torch.utils import checkpoint as ckpt
    from fastlivo_tpu_torch.utils.config import load_config

    if via_main:
        argv = ["--log-path", log, "--device", "cpu", *(f"--set={k}={v!r}" for k, v in overrides.items())]
        pipe = run.main(argv + (["--resume", resume_from] if resume_from else []))
    else:
        pipe = run.run_log(log, load_config(None, overrides), out_dir=out_dir, progress=False,
                           checkpoint_every=checkpoint_every, checkpoint_path=checkpoint_path,
                           resume_from=resume_from, device="cpu")
    out = dict(group_kept=dist.is_initialized(),
        t=np.asarray([x[0] for x in pipe.trajectory]),
        pos=np.stack([x[1] for x in pipe.trajectory]),
        n_map_shards=pipe.n_map_shards, rank=pipe.rank,
        occupied=int(pipe.map.occupied.sum()), map_points=len(pipe.map_cloud()),
    )
    if mismatch_overrides is not None:
        bad = LivoPipeline(load_config(None, mismatch_overrides), device="cpu")
        try:
            ckpt.load_pipeline(checkpoint_path, bad)
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
    if reanchor_shift is not None:
        import chip_smoke

        out["reanchor"] = chip_smoke.reanchor_with_rank0_loop(pipe, reanchor_shift)
    return out
