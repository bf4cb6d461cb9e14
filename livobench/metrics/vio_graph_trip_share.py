"""Share of the photometric update's trips that replayed a captured CUDA
graph: the port's `vio.graph_replays` over its `vio.trips`, from the
process's start to the window's end, set-up included (program counter).
None where the port counts no trips or does not count replays."""

from livobench.program_counters import snapshot


def read(rec):
    c = snapshot()
    if not c or not c.get("vio.trips") or "vio.graph_replays" not in c:
        return None
    return c["vio.graph_replays"] / c["vio.trips"]
