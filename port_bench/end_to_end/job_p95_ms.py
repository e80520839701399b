"""The 95th percentile of the time of every job completed in the window,
from its start to its outputs being ready."""

import statistics

UNIT = "ms"


def read(window):
    if len(window.job_seconds) < 2:
        return None
    q = statistics.quantiles(window.job_seconds, n=20, method="inclusive")
    return q[18] * 1e3
