"""What a traced run reads from torch.profiler and torch's sync debug mode.

`Profile` runs the profiler over a few whole scan cycles of the window.
Recording the device alone (`host=False`), it slows the host little, and
gives:

- `busy_s`: the union of the device's kernel, copy and set intervals;
- `window_s`: the host-clock length of the profiled cycles, from a device
  synchronize before the first to one after the last;
- `kernels`: device kernels launched (copies and sets left out);
- `device_ops`: the ten device operations that took most time, [name, s].

Recording host operations too (`host=True`), with the harness's spans
(`livobench.push`, `.sync`, `.build`, `.lio`, `.vio`) as profiler ranges,
it gives what needs the host's events, over cycles that it slows:

- `knn_device_s`: the device time of the kernels launched inside the
  port's `voxel_map.knn` range;
- `idle_gaps`: the device's idle time by what the host was doing, the ten
  largest [label, s], a label being the harness span and the innermost
  host operation at the gap's middle (`python` when no operation was
  open).

`merge` puts the two together: the device's numbers from the first, the
host's (`knn_device_s`, `knn_scans`, `idle_gaps`, and its own window as
`host_window_s` beside `host_scans`) from the second.

`SyncCount` counts host synchronizations with torch's sync debug mode: a
lower bound, as it sees neither waits on events nor ctypes calls.
"""

from __future__ import annotations

import time
import warnings
from collections import defaultdict

SPAN_PREFIX = "livobench."
TOP = 10


def _device_events(events):
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        if e.name.startswith(SPAN_PREFIX) or e.name == "voxel_map.knn":
            continue  # a range's device-side copy, not work
        out.append(e)
    return out


def _union(intervals):
    """Merged (start, end) of the given intervals, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Profile:
    def __init__(self, cuda: bool, host: bool):
        self.cuda = cuda
        self.host = host
        self._prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CPU] if self.host or not self.cuda else []) + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        if self.cuda:
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def span(self, name: str):
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)

    def stop(self, scans: int, frames: int) -> dict:
        import torch
        from torch.autograd import DeviceType

        if self.cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        dev = _device_events(events)
        busy = _union([(e.time_range.start, e.time_range.end) for e in dev])
        kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
        knn_us = sum(
            getattr(e, "device_time_total", 0.0)
            for e in events if e.name == "voxel_map.knn" and e.device_type == DeviceType.CPU
        )
        by_name = defaultdict(float)
        for e in dev:
            by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
        top_ops = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
        rec = {
            "scans": scans,
            "frames": frames,
            "window_s": window_s,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernels": len(kernels),
            "knn_device_s": knn_us * 1e-6,
            "device_ops": [[name[:120], s] for name, s in top_ops],
            "idle_gaps": self._idle_gaps(events, busy) if self.host else [],
        }
        self._prof = None
        return rec

    @staticmethod
    def _idle_gaps(events, busy):
        """Idle device time between busy intervals, by the host's span and
        innermost operation at each gap's middle."""
        from torch.autograd import DeviceType

        if len(busy) < 2:
            return []
        host = [e for e in events if e.device_type == DeviceType.CPU]
        threads = {e.thread for e in host if e.name.startswith(SPAN_PREFIX)}
        host = [e for e in host if e.thread in threads]
        spans = sorted((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):])
                       for e in host if e.name.startswith(SPAN_PREFIX))
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in host if not e.name.startswith(SPAN_PREFIX))
        mids = [0.5 * (b0 + a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]
        span_at, op_at = _innermost(spans, mids), _innermost(ops, mids)
        totals = defaultdict(float)
        for (_, b0), (a1, _), sp, op in zip(busy, busy[1:], span_at, op_at):
            totals[f"{sp or 'outside'}:{op or 'python'}"] += (a1 - b0) * 1e-6
        return [[k[:120], v] for k, v in sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:TOP]]


def merge(device: dict, host: dict | None) -> dict:
    """The device-only profile's numbers, with the host profile's."""
    rec = dict(device)
    rec.update({"knn_device_s": 0.0, "knn_scans": 0, "idle_gaps": [], "host_window_s": None, "host_scans": 0})
    if host is not None:
        rec.update({"knn_device_s": host["knn_device_s"], "knn_scans": host["scans"],
                    "idle_gaps": host["idle_gaps"], "host_window_s": host["window_s"],
                    "host_scans": host["scans"]})
    return rec


def _innermost(ranges, times):
    """For each of the sorted `times`, the name of the innermost of the
    nested (start, end, name) ranges open then (None if none): a sweep
    with a stack of open ranges."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] <= ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


class SyncCount:
    """Host synchronizations, counted by torch's sync debug mode (one
    warning per synchronizing call)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda

    def start(self):
        import torch

        self._caught = warnings.catch_warnings(record=True)
        self._list = self._caught.__enter__()
        warnings.simplefilter("always")
        if self.cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self, scans: int) -> dict:
        import torch

        if self.cuda:
            torch.cuda.set_sync_debug_mode("default")
        self._caught.__exit__(None, None, None)
        n = sum("synchroniz" in str(w.message) for w in self._list)
        return {"scans": scans, "syncs": n, "counted": self.cuda}
