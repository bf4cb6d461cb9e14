"""The port's own counters, for the readers of `program_counter` metrics.

`fastlivo_tpu_torch.utils.timing` keeps them, always on, from the process's
start: a reader called after the window reads the set-up's updates and the
window's together. A port that keeps no such counters gives None, and its
readers return None."""


def snapshot():
    """The port's counters by name, or None where it keeps none."""
    try:
        from fastlivo_tpu_torch.utils import timing
    except ImportError:
        return None
    read = getattr(timing, "counters", None)
    return read() if callable(read) else None


def per_lio_update(names):
    """The sum of the counters `names` (a predicate on a name) per LIO
    update the port counted (`pipeline.lio_updates`), or None."""
    c = snapshot()
    if not c or not c.get("pipeline.lio_updates"):
        return None
    return sum(v for k, v in c.items() if names(k)) / c["pipeline.lio_updates"]
