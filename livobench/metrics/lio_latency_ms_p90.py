"""The 90th percentile of the scan-end updates' latency in the window:
from the push of the record that completed the group to the return of
`process_scan` with the pose on the host (host clock)."""

from livobench.stats import quantile


def read(rec):
    q = quantile(rec["lio_latency_s"], 0.9)
    return None if q is None else q * 1e3
