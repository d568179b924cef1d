"""End to end: the 95th percentile, over every job completed in the window,
of the time from the host starting the job's first call to the job's
completion (both device-clock stamps), in ms."""

import statistics


def read(rec):
    if len(rec.latency_ms) < 20:
        return None
    return statistics.quantiles(rec.latency_ms, n=100,
                                method="inclusive")[94]
