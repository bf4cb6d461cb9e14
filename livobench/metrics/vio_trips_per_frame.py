"""Trips of the VIO's photometric update per frame, over every pyramid
level: the port's `vio.trips` counter over its `pipeline.vio_updates`,
from the process's start to the window's end, set-up included (program
counter). None where the port counts no frames or not this counter."""

from livobench.program_counters import snapshot


def read(rec):
    c = snapshot()
    if not c or not c.get("pipeline.vio_updates") or "vio.trips" not in c:
        return None
    return c["vio.trips"] / c["pipeline.vio_updates"]
