"""The port's tracer, and per-stage timing for the runner (`StageTimer`, a
copy of fastlivo_tpu/utils/timing.py's, with device time on the GPU).

Spans. `span(name)` is a context manager around one phase of the program;
names are stable and dotted (`lio.eskf.search`). Off, the default, it
returns a shared no-op context after one flag check: no clock reading and
no allocation. `enable()` switches it on: each span then records
(name, parent span, update id, t0_ns, t1_ns) from `time.perf_counter_ns()`
into a buffer of `capacity` rows allocated by `enable`; when the buffer is
full, a span adds one to `dropped` and the buffer does not grow. Whoever
switched the tracer on drains it (`drain`). With `enable(ranges=True)`, or
`set_ranges(True)` while it is on, each span also opens a
`torch.profiler.record_function` range of its name, so the program's
phases sit on the device trace's clock. A span never
synchronizes the device: its duration is host time, the dispatch of its
work plus any host read inside it. Spans are recorded on the thread that
switched the tracer on; the loop back end's worker thread records none.

The update id of a span is the pipeline's ordinal of the LIO or VIO update
it belongs to: the span that opens an update names it
(`span("pipeline.process_scan", update=n)`) and every span inside inherits
it; spans outside an update carry -1.

Counters. `count(name, n)` is a plain integer add and always on.
`sync_point(site)` counts one host synchronization that the program itself
asks for, under `sync.<site>`. `counters()` returns a snapshot; a reader
takes the difference of two. A kernel wrapper counts its launch with
`count_launch`: a launch recorded into a CUDA graph runs only when the
graph replays, so it goes to the tally of the capture its thread holds
open (`graph_counts`), which the graph's owner counts at each replay.

`self_ns` gives each span's self time (its duration less the union of its
children's intervals); `report` prints the span table and the counters.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from array import array
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

CAPACITY = 1 << 16  # span rows of `enable`'s buffer by default


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the same drain, -1 for none
    update: int  # the pipeline's update ordinal, -1 outside an update
    t0_ns: int
    t1_ns: int


class Trace(NamedTuple):
    spans: List[Span]
    dropped: int  # spans not recorded because the buffer was full


class _State:
    """The tracer's switch, its buffer and the open spans of the thread
    that switched it on."""

    def __init__(self):
        self.on = False
        self.ranges = False
        self.owner = None
        self.gen = 0  # drains so far: a span opened before a drain closes into nothing
        self.alloc(0)

    def alloc(self, capacity: int):
        self.cap = capacity
        self.names: List[Optional[str]] = [None] * capacity
        self.parent = array("q", bytes(8 * capacity))
        self.update = array("q", bytes(8 * capacity))
        self.t0 = array("q", bytes(8 * capacity))
        self.t1 = array("q", bytes(8 * capacity))
        self.n = 0
        self.dropped = 0
        self.stack: List[int] = []
        self.current = -1


_S = _State()
_NULL = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = defaultdict(int)


class _Open:
    """One recording span (the tracer is on)."""

    __slots__ = ("name", "update", "ranged", "slot", "gen", "prev", "rf")

    def __init__(self, name: str, update: Optional[int], ranged: bool):
        self.name = name
        self.update = update
        self.ranged = ranged

    def __enter__(self):
        s = _S
        self.rf = None
        if self.ranged or s.ranges:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.gen, self.prev, self.slot = s.gen, s.current, -1
        if threading.get_ident() != s.owner:
            return self
        if self.update is not None:
            s.current = self.update
        if s.n >= s.cap:
            s.dropped += 1
            return self
        i = self.slot = s.n
        s.n += 1
        s.names[i] = self.name
        s.parent[i] = s.stack[-1] if s.stack else -1
        s.update[i] = s.current
        s.stack.append(i)
        s.t0[i] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        s = _S
        if self.gen == s.gen and threading.get_ident() == s.owner:
            if self.slot >= 0:
                s.t1[self.slot] = t1
                s.stack.pop()
            s.current = self.prev
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, update: Optional[int] = None, ranged: bool = False):
    """A context manager timing one phase of the program (see the module
    note). `update` opens the pipeline's update of that ordinal. `ranged`
    opens a profiler range of the name even with the tracer off (a range a
    reader finds by name in any profile)."""
    if not _S.on:
        return torch.profiler.record_function(name) if ranged else _NULL
    return _Open(name, update, ranged)


def traced(name: str, ranged: bool = False):
    """Decorator: the whole call is one `span(name, ranged=ranged)`."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not (_S.on or ranged):
                return fn(*args, **kwargs)
            with span(name, ranged=ranged):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def enable(ranges: bool = False, capacity: int = CAPACITY):
    """Switch the spans on for the calling thread, with an empty buffer of
    `capacity` rows (and profiler ranges with `ranges`)."""
    _S.gen += 1
    _S.alloc(capacity)
    _S.owner = threading.get_ident()
    _S.ranges = ranges
    _S.on = True


def set_ranges(on: bool):
    """Switch the profiler ranges of the spans on or off, the spans and
    their buffer staying as they are (for a few profiled cycles inside a
    longer traced stretch)."""
    _S.ranges = on


def disable():
    """Switch the spans (and their ranges) off; the buffer stays to drain."""
    _S.on = False
    _S.ranges = False


def drain() -> Trace:
    """The closed spans recorded since `enable` or the last drain, and the
    dropped count; the buffer starts over. Spans still open are left out
    (their children's `parent` then reads -1) and record nothing."""
    s = _S
    keep = [i for i in range(s.n) if s.t1[i]]
    index = {i: k for k, i in enumerate(keep)}
    spans = [Span(s.names[i], index.get(s.parent[i], -1), s.update[i], s.t0[i], s.t1[i]) for i in keep]
    dropped = s.dropped
    s.gen += 1
    s.n, s.dropped, s.stack = 0, 0, []
    for i in keep:
        s.t1[i] = 0
    return Trace(spans, dropped)


def count(name: str, n: int = 1):
    """Add n to the counter `name` (always on)."""
    _COUNTERS[name] += n


_GRAPH = threading.local()  # .tally: the open `graph_counts` of this thread


def count_launch(name: str):
    """Count one kernel launch under `name` where it runs: now, or, when
    the current stream is capturing a CUDA graph, at each replay (it is
    added to this thread's open `graph_counts`; a capture without one
    counts its launches nowhere)."""
    if torch.cuda.is_current_stream_capturing():
        tally = getattr(_GRAPH, "tally", None)
        if tally is not None:
            tally[name] += 1
    else:
        _COUNTERS[name] += 1


@contextlib.contextmanager
def graph_counts():
    """Collect the launches that this thread records into a CUDA graph
    while open (`count_launch`): yields a dict of counter name -> launches
    that the graph's owner adds with `count` at each replay."""
    prev = getattr(_GRAPH, "tally", None)
    _GRAPH.tally = tally = defaultdict(int)
    try:
        yield tally
    finally:
        _GRAPH.tally = prev


def sync_point(site: str, n: int = 1):
    """Count n host synchronizations the program asks for at `site`."""
    _COUNTERS["sync." + site] += n


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_COUNTERS)


def counter_delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """What each counter added between two snapshots."""
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def self_ns(spans: Sequence[Span]) -> List[int]:
    """Each span's self time: its duration less the union of its direct
    children's intervals (clipped to it)."""
    kids: Dict[int, list] = defaultdict(list)
    for s in spans:
        if s.parent >= 0:
            kids[s.parent].append((s.t0_ns, s.t1_ns))
    out = []
    for i, s in enumerate(spans):
        covered, end = 0, s.t0_ns
        for a, b in sorted(kids.get(i, ())):
            a, b = max(a, end), min(b, s.t1_ns)
            if b > a:
                covered += b - a
                end = b
        out.append(s.t1_ns - s.t0_ns - covered)
    return out


def report(trace: Optional[Trace] = None, delta: Optional[Dict[str, int]] = None, scans: int = 0) -> str:
    """The span table (count, p50 and self-time p50 per span, total per
    scan) and the counters per scan, as text."""
    lines = []
    per = max(scans, 1)
    if trace is not None:
        own = self_ns(trace.spans)
        by: Dict[str, list] = defaultdict(list)
        for s, o in zip(trace.spans, own):
            by[s.name].append((s.t1_ns - s.t0_ns, o))
        lines.append(f"{'span':24s} {'n':>7s} {'p50 ms':>9s} {'self p50':>9s} {'ms/scan':>9s}")
        for name in sorted(by):
            d = np.asarray(by[name], dtype=np.float64) * 1e-6
            lines.append(f"{name:24s} {len(d):7d} {np.median(d[:, 0]):9.3f} {np.median(d[:, 1]):9.3f} "
                         f"{d[:, 0].sum() / per:9.3f}")
        lines.append(f"spans dropped: {trace.dropped}")
    if delta:
        lines.append(f"{'counter':24s} {'total':>9s} {'per scan':>9s}")
        for name in sorted(delta):
            lines.append(f"{name:24s} {delta[name]:9d} {delta[name] / per:9.3f}")
    return "\n".join(lines)


class StageTimer:
    """Host-clock stages for the runner, each a tracer span too, so the
    stages and the program's spans share one table and one clock."""

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
        with span(name):
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                dt = (time.perf_counter_ns() - t0) * 1e-9
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
