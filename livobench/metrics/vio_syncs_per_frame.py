"""Host synchronizations the VIO step asks for per frame, one per
photometric trip's flag read: the port's `sync.vio_flags` counter over its
`pipeline.vio_updates`, from the process's start to the window's end,
set-up included (program counter). None where the port counts no frames
or not this counter."""

from livobench.program_counters import snapshot


def read(rec):
    c = snapshot()
    if not c or not c.get("pipeline.vio_updates") or "sync.vio_flags" not in c:
        return None
    return c["sync.vio_flags"] / c["pipeline.vio_updates"]
