"""Leaf voxels per LIO update that the downsample left out past its
`lio.max_points` budget (`ops.voxelize.voxel_downsample` keeps the first
ones in lexicographic voxel order): the port's
`lio.downsample.voxels_dropped` counter over its `pipeline.lio_updates`,
from the process's start to the window's end, set-up included (program
counter). None where the port keeps no such counter."""

from livobench.program_counters import per_lio_update, snapshot

COUNTER = "lio.downsample.voxels_dropped"


def read(rec):
    if COUNTER not in (snapshot() or {}):
        return None
    return per_lio_update(lambda name: name == COUNTER)
