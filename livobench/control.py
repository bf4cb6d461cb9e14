"""The readings that the check's limits are set from, on the card.

    python3 livobench/control.py --workload <cell> --seeds 11 12 13 ... --seconds 8 [--out F]

For each seed, one run of the cell as the benchmark runs it (set-up and a
window of `--seconds`), then each of the configuration's checks on the
states it kept: the sound reading, the program held to the plain
reference as the benchmark's runs hold it. Then the control, which has to
fail, checked by the same checks in the same way: the nearest precision
below the configuration's in the program's place. Below float64 that is
the program's own float32 path, run on the same seed; below float32 (TF32
off) the program has no path of its own, and it is the reference with
TF32 matmuls (`check.tf32_arith`). A float64 configuration also reads the
TF32 reference in the program's place (`tf32`).
Prints one JSON line per seed: {"seed", "sound": {number: gap},
"control": {number: gap}[, "tf32": {number: gap}]}. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def _run(cell, seed, seconds, device, precision, overrides, traffic):
    """One run of the program at `precision`: (reference config, pool,
    the cell's checks with what they kept)."""
    import torch

    from livobench import check, harness, pool as pool_mod

    tree = cell.config_file["config"]
    rcfg = harness.reference_config(tree, overrides)
    checks = check.Checks(cell.config_file, rcfg,
                          harness.window_times(seed, seconds, int(traffic["check"]["samples"])), cell.checks_dir)
    pool = pool_mod.build_pool(traffic, rcfg, seed, device)
    rep = harness.Replay(harness.program_config(tree, overrides), device, precision)
    harness._setup_replay(rep, pool, checks, pool.setup_laps)
    harness.run_window(rep, pool, checks, seconds, False, torch.device(device).type == "cuda")
    checks.after_window(rep.pipe)
    del rep
    gc.collect()
    return rcfg, pool, checks


def readings(cell, seed: int, seconds: float, device: str, overrides=None, traffic=None, log=None) -> dict:
    """{"sound": gaps, "control": gaps} of `cell` on one seed, and for a
    float64 configuration "tf32": gaps. The control of a float64
    configuration is the program's own float32 path, run and checked
    like the program; that of a float32 one is the reference with TF32
    matmuls, put in the program's place."""
    from livobench import check

    overrides = overrides or {}
    traffic = traffic or cell.traffic
    tree = cell.config_file["config"]
    rcfg, pool, checks = _run(cell, seed, seconds, device, cell.precision, overrides, traffic)
    out = {"sound": checks.gaps(rcfg, tree, pool, device, log=log),
           "control": checks.gaps(rcfg, tree, pool, device, check.tf32_arith())}
    if cell.precision == "float64":
        out["tf32"] = out["control"]
        rcfg, pool, checks = _run(cell, seed, seconds, device, "float32", overrides, traffic)
        out["control"] = checks.gaps(rcfg, tree, pool, device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    from livobench import harness

    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.Cell(harness.load_json(harness.ROOT / "BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed, args.seconds, "cuda",
                       log=lambda m: print(f"seed {seed}: {m}", file=sys.stderr, flush=True))
        line = json.dumps({"workload": cell.name, "seed": seed, **got, "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [root] + [q for q in sys.path if os.path.abspath(q or ".") not in (here, root)]
    sys.exit(main())
