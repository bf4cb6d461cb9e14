"""The median of the harness's span around `process_image` over the
window's uninstrumented frame updates (host clock)."""

from livobench.stats import quantile


def read(rec):
    q = quantile(rec["vio_step_s"], 0.5)
    return None if q is None else q * 1e3
