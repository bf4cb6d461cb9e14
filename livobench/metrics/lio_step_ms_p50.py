"""The median of the harness's span around `process_scan` over the
window's uninstrumented scan-end updates (host clock)."""

from livobench.stats import quantile


def read(rec):
    q = quantile(rec["lio_step_s"], 0.5)
    return None if q is None else q * 1e3
