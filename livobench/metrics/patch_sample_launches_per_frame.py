"""Launches of the fused patch sampler (`csrc/patch_sample.cu`) per frame:
the port's `patch_sample.launches` counter over its
`pipeline.vio_updates`, from the process's start to the window's end,
set-up included (program counter). None where the port counts no frames
or not this counter."""

from livobench.program_counters import snapshot


def read(rec):
    c = snapshot()
    if not c or not c.get("pipeline.vio_updates") or "patch_sample.launches" not in c:
        return None
    return c["patch_sample.launches"] / c["pipeline.vio_updates"]
