"""Raw sweep points per LIO update that the window builder's stride left out
(`io.sync.WindowBuilder.build` keeps at most twice `lio.max_points` of a
group's points): the port's `io.build.points_dropped` counter over its
`pipeline.lio_updates`, from the process's start to the window's end,
set-up included (program counter). None where the port keeps no such
counter."""

from livobench.program_counters import per_lio_update, snapshot

COUNTER = "io.build.points_dropped"


def read(rec):
    if COUNTER not in (snapshot() or {}):
        return None
    return per_lio_update(lambda name: name == COUNTER)
