"""Before/after measurements of the fused patch sampler on one GPU.

    python tools/patch_sample_ab.py run --tree DIR --out FILE
    python tools/patch_sample_ab.py variants --out FILE
    python tools/patch_sample_ab.py micro --out FILE
    python tools/patch_sample_ab.py compare FILE [FILE ...]

`run` imports `chip_smoke` and `fastlivo_tpu_torch` from the repository
tree DIR (default: this checkout; a `git archive` of another commit
unpacked elsewhere for a before/after), then writes to FILE:

- the CUDA wrapper's host cost per call by stage (time.perf_counter_ns,
  `chip_smoke.PS_SPLIT_ITERS` calls per stage) at N = 208 for every form;
  for a tree whose wrapper predates the staged launch path
  (`ops/patch_sample._validate` missing) the stages are that wrapper's own
  (`_check`, three `torch.empty`, four ctypes arrays, the Stream object,
  the 16-argument ctypes call), repeated here line for line;
- that tree's phase 1 (`chip_smoke.phase_patch_sample`): bitwise checks
  and graphed / eager times of every form;
- 20 flagship LIVO pairs after 3 warm-up pairs (phase 2's sequence): the
  pair, LIO and VIO times, `patch_sample` launches, and every pair's
  summaries and post-pair state as exact floats.

`variants` builds `tools/patch_sample_staged.cu` (one warp per item, its
pixels staged in shared memory by cp.async) as it is and with
-DPATCH_SAMPLE_DIRECT_TAPS (the same warp reading its taps straight from
L1/L2), checks both and the shipped kernel bitwise against the plain
version, and times the three (CUDA-graph replay, in turns there and back)
at every form and N of phase 1.

`micro` times the pieces a wrapper call is built from (the ways to
allocate the outputs, the stream query, the checks, the ctypes call with
and without its launch) at N = 208.

`compare` checks that the runs' LIVO summaries and states are equal bit
for bit and prints their times side by side. Every result names the GPU
(`nvidia-smi` name and power limit).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time


def _import_tree(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import chip_smoke
    from fastlivo_tpu_torch.ops import patch_sample as ps

    return chip_smoke, ps


def _host_ns(fn, iters, warmup=100):
    """Host ns per call of `fn` in a loop (time.perf_counter_ns)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter_ns()
    for _ in range(iters):
        fn()
    return (time.perf_counter_ns() - t0) / iters


def _host_split_before(cs, ps, case, iters=2000):
    """The stages of the wrapper before the staged launch path, repeated
    line for line, each timed alone (ns per call)."""
    import torch

    levels, centers, strides = case["levels"], case["centers"][0], case["strides"]
    patch, sset = case["patch"], case["stride_set"]
    gu = None
    if case["grads"]:
        lvl = int(case["name"][-1])
        gu = strides.to(torch.float32) * (2.0**lvl)
    n, n_lv = centers.shape[0], len(levels)
    grads = gu is not None

    def outputs():
        val = torch.empty((n, n_lv * patch * patch), dtype=torch.float32, device=centers.device)
        return val, torch.empty_like(val) if grads else None, torch.empty_like(val) if grads else None

    def arguments():
        return (
            (ctypes.c_uint64 * n_lv)(*[img.data_ptr() for img in levels]),
            (ctypes.c_int * n_lv)(*[img.shape[0] for img in levels]),
            (ctypes.c_int * n_lv)(*[img.shape[1] for img in levels]),
            (ctypes.c_int * len(sset))(*sset),
        )

    val, du, dv = outputs()
    imgs, hps, wps, ss = arguments()
    stream = torch.cuda.current_stream(centers.device).cuda_stream
    fn = ps._kernel_fn()

    def launch():
        return fn(
            imgs, hps, wps, n_lv, centers.data_ptr(), None if strides is None else strides.data_ptr(),
            gu.data_ptr() if grads else None, n, patch, cs.PS_PAD, ss, len(sset),
            val.data_ptr(), du.data_ptr() if grads else None, dv.data_ptr() if grads else None, stream,
        )

    stages = dict(
        checks=lambda: ps._check(levels, centers, strides, patch, sset, gu),
        outputs=outputs,
        arguments=arguments,
        stream=lambda: torch.cuda.current_stream(centers.device).cuda_stream,
        ctypes_launch=launch,
        call=case["kernel"],
        loop=lambda: None,
    )
    split = {name: _host_ns(f, iters) for name, f in stages.items()}
    torch.cuda.synchronize()
    return split


def host_split(cs, ps, device):
    cam, pyr = cs.patch_sample_frame(device)
    out = {}
    for case in cs.patch_sample_cases(pyr, cam, 208):
        if hasattr(ps, "_validate"):
            out[case["name"]] = cs.patch_sample_host_split(case)
        else:
            out[case["name"]] = _host_split_before(cs, ps, case)
    return out


def livo_pairs(cs, device, n_warm=3, n_timed=20):
    """Phase 2's sequence: summaries and states of every pair, exact."""
    import numpy as np
    import torch

    run = cs.LivoRun(cs.flagship_config(), cs.Scene(n_raw=81920, imu_m=32, seed=0), device)
    warm = run.make_inputs(n_warm)
    timed_in = run.make_inputs(n_timed)
    states = []

    def pair(inp, timed):
        rec = run.pair(inp, timed=timed)
        states.append(torch.cat([t.reshape(-1) for t in run.state]).clone())
        return rec

    records = [pair(inp, False) for inp in warm]
    torch.cuda.synchronize()
    cs.reset_launches()
    timed = [pair(inp, True) for inp in timed_in]
    torch.cuda.synchronize()
    launches = cs.read_launches()
    records = cs.finish(records + timed)
    cs.check_records(records)
    lio = [r["lio_ms"] for r in timed]
    vio = [r["vio_ms"] for r in timed]
    return dict(
        pair_ms=float(np.median(np.add(lio, vio))), lio_ms=float(np.median(lio)),
        vio_ms=float(np.median(vio)), pair_ms_all=[a + b for a, b in zip(lio, vio)],
        launches=launches, frames=len(timed),
        summaries=[[r["lio"].tolist(), r["vio"].tolist()] for r in records],
        states=[s.double().cpu().tolist() for s in states],
    )


def cmd_run(args):
    import torch

    cs, ps = _import_tree(args.tree)
    device = torch.device("cuda")
    ident = cs.gpu_identity()
    from fastlivo_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    res = dict(gpu=ident, tree=os.path.abspath(args.tree), build_s=time.perf_counter() - t0)
    res["host_ns"] = host_split(cs, ps, device)
    phase1 = cs.phase_patch_sample(device)
    res["phase1"] = phase1[0] if isinstance(phase1, tuple) else phase1
    res["livo"] = livo_pairs(cs, device)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(json.dumps(dict(gpu=ident, tree=res["tree"], host_ns=res["host_ns"],
                          pair_ms=res["livo"]["pair_ms"], vio_ms=res["livo"]["vio_ms"],
                          launches=res["livo"]["launches"])), flush=True)


TOOLS = os.path.dirname(os.path.abspath(__file__))


def build_variant(cuda_build, out_dir, source, defines=()):
    """tools/`source` (a kernel with the shipped C entry point) built with
    the kernels' nvcc flags and `defines`, loaded and bound."""
    from fastlivo_tpu_torch.ops import patch_sample as ps

    stem = os.path.splitext(source)[0] + "".join(defines).replace("-D", "_")
    out = os.path.join(out_dir, f"lib{stem}.so")
    cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", *defines, "-o", out,
           os.path.join(TOOLS, source)]
    res = subprocess.run(cmd, check=True, capture_output=True, text=True)
    print(stem, [ln for ln in res.stderr.splitlines() if "registers" in ln], flush=True)
    return ps.bind(ctypes.CDLL(out))


def cmd_variants(args):
    import tempfile

    import torch

    cs, ps = _import_tree(args.tree)
    from fastlivo_tpu_torch.ops import cuda_build
    from fastlivo_tpu_torch.ops.camera import Pinhole

    device = torch.device("cuda")
    ident = cs.gpu_identity()
    tmp = tempfile.mkdtemp(prefix="patch_sample_variants_")
    fns = dict(
        shipped=ps._kernel_fn(),
        warp_staged=build_variant(cuda_build, tmp, "patch_sample_staged.cu"),
        warp_direct=build_variant(cuda_build, tmp, "patch_sample_staged.cu", ("-DPATCH_SAMPLE_DIRECT_TAPS",)),
    )
    order = list(fns) + list(fns)[::-1]
    frames = [cs.patch_sample_frame(device)] * len(cs.PS_NS) + [
        cs.patch_sample_frame(device, Pinhole(*cs.GNSS_CAMERA))]
    rows = []
    try:
        for (cam, pyr), n in zip(frames, cs.PS_NS + [cs.PS_WIDE_N]):
            for case in cs.patch_sample_cases(pyr, cam, n):
                want = case["plain"]()
                want = want if isinstance(want, tuple) else (want,)
                row = dict(case=case["name"], n=n, levels=[list(i.shape) for i in case["levels"]])
                for name in order:
                    ps._FN = fns[name]
                    got = case["kernel"]()
                    got = got if isinstance(got, tuple) else (got,)
                    torch.cuda.synchronize()
                    if not all(cs.same_bits(a, b) for a, b in zip(got, want)):
                        raise AssertionError(f"{name} {case['name']} n={n}: not bitwise equal")
                    row.setdefault(f"{name}_us", []).append(cs.graph_time_ms(case["kernel"]) * 1e3)
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        ps._FN = fns["shipped"]
    with open(args.out, "w") as f:
        json.dump(dict(gpu=ident, rows=rows), f)
    print(json.dumps(dict(gpu=ident, variants=len(rows))), flush=True)


def cmd_micro(args):
    """Host ns per call of the pieces a wrapper call is built from, at
    N = 208 (update form, level 0): the ways to allocate the outputs, the
    stream query, the checks, the arguments, and the ctypes call with
    N = 0 (the entry point returns before any CUDA call) and with N = 208
    (one launch)."""
    import torch

    cs, ps = _import_tree(args.tree)
    device = torch.device("cuda")
    ident = cs.gpu_identity()
    cam, pyr = cs.patch_sample_frame(device)
    case = next(c for c in cs.patch_sample_cases(pyr, cam, 208) if c["name"] == "update_L0")
    c, s, gu = case["centers"][0], case["strides"], case["grad_units"]
    params = ps._validate(case["levels"], c, s, 8, case["stride_set"], gu, cs.PS_PAD)
    out, _ = ps._outputs(c, 208, 1, 8, True)
    args_full = ps._arguments(case["levels"], c, s, gu, 208, params, out)
    args_zero = list(args_full)
    args_zero[7] = 0  # n
    fn, stream = ps._kernel_fn(), ps._stream(c)
    pieces = dict(
        loop=lambda: None,
        empty=lambda: torch.empty((208, 64), dtype=torch.float32, device=c.device),
        new_empty=lambda: c.new_empty((208, 64)),
        unbind=lambda: out.unbind(0),
        outputs_unbind=lambda: c.new_empty((3, 208, 64)).unbind(0),
        outputs_split=lambda: c.new_empty((3 * 208, 64)).split(208),
        outputs_three=lambda: (c.new_empty((208, 64)), c.new_empty((208, 64)), c.new_empty((208, 64))),
        stream=lambda: ps._stream(c),
        stream_object=lambda: torch.cuda.current_stream(c.device).cuda_stream,
        validate=lambda: ps._validate(case["levels"], c, s, 8, case["stride_set"], gu, cs.PS_PAD),
        arguments=lambda: ps._arguments(case["levels"], c, s, gu, 208, params, out),
        ctypes_n0=lambda: fn(*args_zero, stream),
        ctypes_launch=lambda: fn(*args_full, stream),
        call=case["kernel"],
    )
    res = {name: _host_ns(f, 5000) for name, f in pieces.items()}
    torch.cuda.synchronize()
    with open(args.out, "w") as f:
        json.dump(dict(gpu=ident, host_ns=res), f)
    print(json.dumps(dict(gpu=ident, host_ns=res)), flush=True)


def cmd_compare(args):
    runs = []
    for path in args.files:
        with open(path) as f:
            runs.append(json.load(f))
    ref = runs[0]["livo"]
    for path, r in zip(args.files, runs):
        lv = r["livo"]
        same = lv["summaries"] == ref["summaries"] and lv["states"] == ref["states"]
        print(json.dumps(dict(run=path, gpu=r["gpu"], tree=r["tree"], bitwise_equal_to_first=same,
                              pair_ms=lv["pair_ms"], lio_ms=lv["lio_ms"], vio_ms=lv["vio_ms"],
                              patch_sample_per_frame=lv["launches"]["patch_sample"] / lv["frames"])))
        if not same:
            raise SystemExit(f"{path}: LIVO summaries or states differ from {args.files[0]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "variants", "micro"):
        p = sub.add_parser(name)
        p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        p.add_argument("--out", required=True)
    p = sub.add_parser("compare")
    p.add_argument("files", nargs="+")
    args = ap.parse_args(argv)
    if args.cmd != "compare":
        import torch

        if not torch.cuda.is_available():
            print("patch_sample_ab: no CUDA device available", file=sys.stderr)
            return 2
    dict(run=cmd_run, variants=cmd_variants, micro=cmd_micro, compare=cmd_compare)[args.cmd](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
