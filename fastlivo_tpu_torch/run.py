"""CLI entry point: run the LIVO pipeline over a measurement log (port of
fastlivo_tpu/run.py).

    python -m fastlivo_tpu_torch.run --config configs/avia_livo.yaml \
        --log sequence.flvo --out Log/ [--device cpu]

The runner streams the log through the measurement synchronizer and the
pipeline on one device (the GPU unless `--device cpu`), prints per-stage
timing and the program's counters per scan at the end (`utils.timing`),
and writes tum.txt, map.pcd and time_log.csv to --out. `--profile DIR`
switches the program's tracer on with profiler ranges: DIR/trace.json (a
torch.profiler chrome trace) then carries the program's spans beside the
device's kernels, and the closing report adds the span table.

Multi-device: one process per rank under torchrun, every rank reading the
log and rank 0 writing the outputs,

    torchrun --nproc-per-node W -m fastlivo_tpu_torch.run --config C \
        --log-path L --out O --set parallel.n_devices=W [--set parallel.map_sharded=True]

(`--log-path` is `--log`'s other name: torchrun's own parser reads `--log`
as an ambiguous abbreviation of its `--log-dir`/`--logs-specs` in some
torch versions, and refuses the command line.)

NCCL on the GPUs (one rank per GPU, rank r on cuda:LOCAL_RANK); with
`--device cpu` gloo CPU ranks. `--dist-backend gloo --device cuda:0` puts
every rank on one GPU.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import os
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fastlivo_tpu_torch.io import features, logio
from fastlivo_tpu_torch.io.sensors import ImageFrame, ImuSample, LidarScan
from fastlivo_tpu_torch.io.sync import LidarMeasureGroup, MeasurementSynchronizer, WindowBuilder
from fastlivo_tpu_torch.models.pipeline import LivoPipeline, ScanInput
from fastlivo_tpu_torch.parallel.distributed import initialize_distributed
from fastlivo_tpu_torch.utils import checkpoint as ckpt
from fastlivo_tpu_torch.utils import timing
from fastlivo_tpu_torch.utils.config import load_config
from fastlivo_tpu_torch.utils.timing import StageTimer

_IDENTITY9 = (1, 0, 0, 0, 1, 0, 0, 0, 1)


def replay(
    log_path: str, cfg, pipe: LivoPipeline, timer: StageTimer
) -> Iterator[Optional[Tuple[LidarMeasureGroup, ScanInput, float]]]:
    """The log's measurement groups in order, each with its fixed-shape
    input (NumPy leaves, acc_scale taken from `pipe` when the group is
    built) and its absolute update time. After the groups that each record
    completes it yields None: the runner stops only there. With
    `preprocess.feature_extract_en`, each scan keeps only its plane and edge
    points (`io.features.classify_features`, the reference's LOAM-style
    give_feature mode) when more than 100 of them survive."""
    sync = MeasurementSynchronizer(
        img_enabled=cfg.vio.img_enable,
        img_delta_time=cfg.vio.delta_time,
        imu_acc_scale=cfg.imu.acc_scale_factor,
        imu_axis_remap=None if tuple(cfg.imu.axis_remap) == _IDENTITY9 else cfg.imu.axis_remap,
    )
    builder = WindowBuilder(n_pts=cfg.lio.max_points * 2, imu_window=cfg.imu.imu_int_frame)
    stream = logio.read_log(
        log_path,
        blind=cfg.preprocess.blind,
        max_range=cfg.preprocess.max_range,
        point_filter_num=cfg.preprocess.point_filter_num,
    )
    for rec in stream:
        if isinstance(rec, ImuSample):
            sync.push_imu(rec)
        elif isinstance(rec, LidarScan):
            if cfg.preprocess.feature_extract_en:
                with timer.stage("features"):
                    plane, edge = features.classify_features(rec)
                keep = plane | edge
                if keep.sum() > 100:
                    rec = LidarScan(
                        stamp=rec.stamp, pts=rec.pts[keep], t_offs_ms=rec.t_offs_ms[keep],
                        intensity=None if rec.intensity is None else rec.intensity[keep],
                    )
            sync.push_lidar(rec)
        elif isinstance(rec, ImageFrame):
            sync.push_image(rec)
        while True:
            with timer.stage("sync"):
                group = sync.next_group()
            if group is None:
                break
            with timer.stage("window_build"):
                scan_input, t_abs = builder.build(group)
                scan_input = scan_input._replace(acc_scale=np.float32(pipe.acc_scale))
            yield group, scan_input, t_abs
        yield None


def run_log(
    log_path: str,
    cfg,
    out_dir: Optional[str] = None,
    max_scans: Optional[int] = None,
    checkpoint_every: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    resume_from: Optional[str] = None,
    progress: bool = True,
    profile_dir: Optional[str] = None,
    dump_states: Optional[str] = None,
    device=None,
) -> LivoPipeline:
    """Programmatic runner; `device=None` means the GPU. Returns the
    pipeline after the run. With `resume_from`, every group before the
    checkpoint only advances the synchronizer; `max_scans` stops after the
    record that completes that many scan-end groups."""
    if out_dir is not None:
        cfg.runtime.out_dir = out_dir

    pipe = LivoPipeline(cfg, device=device)
    progress = progress and pipe.rank == 0  # one rank reports
    skip_scans = 0
    if resume_from is not None:
        skip_scans = int(ckpt.load_pipeline(resume_from, pipe).get("n_scans", 0))
        if progress:
            print(f"resumed from {resume_from} at scan {skip_scans}")
    timer = StageTimer(pipe.device)
    pipe.timer = timer

    n_scans = 0
    t_start = time.perf_counter()
    counts0 = timing.counters()
    with contextlib.ExitStack() as stack:
        if profile_dir is not None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if pipe.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
            timing.enable(ranges=True)
            stack.callback(timing.disable)
        for item in replay(log_path, cfg, pipe, timer):
            if item is None:
                if max_scans is not None and n_scans >= max_scans:
                    break
                continue
            group, scan_input, t_abs = item
            if n_scans < skip_scans:
                # Resumed: groups before the checkpoint only advance the
                # stream; only scan-end groups count, as in the checkpoint.
                n_scans += group.is_lidar_end
                continue
            if not group.is_lidar_end:
                with timer.stage("vio_step"):
                    pipe.process_image(scan_input, group.measures[-1].img.img, t_abs)
                continue
            with timer.stage("lio_step"):
                info = pipe.process_scan(scan_input, t_abs)
            timer.tick(t_abs)
            n_scans += 1
            if dump_states is not None and info is not None:
                st = pipe.state
                row = np.concatenate(
                    [[t_abs]] + [x.cpu().numpy() for x in (st.pos, st.vel, st.bg, st.ba, st.grav)]
                )
                with open(dump_states, "a") as f:
                    f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
            if progress and info is not None and n_scans % 50 == 0:
                pos = pipe.trajectory[-1][1]
                print(
                    f"[{n_scans:5d}] t={t_abs:.2f} pos=({pos[0]:+7.2f},{pos[1]:+7.2f},"
                    f"{pos[2]:+7.2f}) n_eff={pipe.n_effective[-1]}"
                )
            if checkpoint_every and checkpoint_path and n_scans % checkpoint_every == 0:
                ckpt.save_pipeline(checkpoint_path, pipe, meta={"n_scans": n_scans})
    trace = None
    if profile_dir is not None:
        trace = timing.drain()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    wall = time.perf_counter() - t_start
    if progress:
        print(
            f"processed {n_scans} scans in {wall:.1f}s "
            f"({wall / max(n_scans, 1) * 1e3:.1f} ms/scan incl. host) on {pipe.device}"
        )
        print(timer.report())
        print(timing.report(trace, timing.counter_delta(timing.counters(), counts0), n_scans))
    pipe.finish(out_dir)
    if out_dir is not None and pipe.rank == 0:
        timer.write_csv(os.path.join(out_dir, "time_log.csv"))
    return pipe


def _literal(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--log", "--log-path", dest="log", required=True, help="FLVO measurement log")
    parser.add_argument("--config", default=None, help="reference-format YAML")
    parser.add_argument("--out", default=None, help="output directory")
    parser.add_argument("--max-scans", type=int, default=None)
    parser.add_argument("--checkpoint", default=None, help="checkpoint file to write")
    parser.add_argument("--checkpoint-every", type=int, default=None, help="scans between checkpoints")
    parser.add_argument("--resume", default=None, help="checkpoint to resume from")
    parser.add_argument("--profile", default=None, help="write a torch.profiler chrome trace to DIR/trace.json")
    parser.add_argument("--dump-states", default=None, help="append full state rows here")
    parser.add_argument(
        "--set", action="append", default=[], help="override, e.g. --set vio.img_enable=0"
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the pipeline runs: cuda (the default; cuda:LOCAL_RANK under torchrun; it "
             "raises when there is no GPU), cuda:N, or cpu",
    )
    parser.add_argument(
        "--dist-backend", default=None, choices=("nccl", "gloo"),
        help="torch.distributed backend under torchrun (default: nccl on the GPU, gloo on the CPU)",
    )
    args = parser.parse_args(argv)

    overrides = {}
    for s in args.set:
        k, v = s.split("=", 1)
        overrides[k] = _literal(v)
    cfg = load_config(args.config, overrides)
    device = None if args.device == "cuda" else args.device
    had_group = dist.is_initialized()  # a caller's own group stays up
    grouped = initialize_distributed(backend=args.dist_backend, device=device) and not had_group
    try:
        return run_log(
            args.log,
            cfg,
            out_dir=args.out,
            max_scans=args.max_scans,
            checkpoint_every=args.checkpoint_every,
            checkpoint_path=args.checkpoint,
            resume_from=args.resume,
            profile_dir=args.profile,
            dump_states=args.dump_states,
            device=device,
        )
    finally:
        if grouped:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
