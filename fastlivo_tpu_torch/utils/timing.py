"""Per-stage timing and per-scan run logging (a copy of
fastlivo_tpu/utils/timing.py, with device time on the GPU).

`stage` times a block on the host clock. On a CUDA pipeline it also
records a CUDA event pair around the block, read only when a summary is
asked for, so the device time of each stage is kept without an extra sync.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch


class StageTimer:
    def __init__(self, device: torch.device | None = None):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self._events: Dict[str, list] = defaultdict(list)
        self._cuda = device is not None and torch.device(device).type == "cuda"
        self._rows: List[Dict[str, float]] = []
        self._current: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if self._cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if self._cuda:
                ev[1].record()
                self._events[name].append(ev)
            self.samples[name].append(dt)
            self._current[name] = self._current.get(name, 0.0) + dt

    def device_ms(self, name: str) -> List[float]:
        """CUDA-event time of every `name` stage (empty off the GPU)."""
        if not self._events.get(name):
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events[name]]

    def tick(self, stamp: float):
        """Close one per-scan row."""
        row = {"stamp": stamp, **self._current}
        self._rows.append(row)
        self._current = {}

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = {
                "n": len(a),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(a.max() * 1e3),
            }
            dev = self.device_ms(k)
            if dev:
                out[k]["device_p50_ms"] = float(np.percentile(dev, 50))
        return out

    def write_csv(self, path: str):
        keys = ["stamp"] + sorted({k for r in self._rows for k in r if k != "stamp"})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self._rows:
                f.write(",".join(f"{r.get(k, 0.0):.6f}" for k in keys) + "\n")

    def report(self) -> str:
        lines = [f"{'stage':24s} {'n':>6s} {'mean':>9s} {'p50':>9s} {'p95':>9s} {'max':>9s}"]
        for k, s in sorted(self.summary().items()):
            lines.append(
                f"{k:24s} {s['n']:6d} {s['mean_ms']:8.2f}m {s['p50_ms']:8.2f}m "
                f"{s['p95_ms']:8.2f}m {s['max_ms']:8.2f}m"
            )
        return "\n".join(lines)
