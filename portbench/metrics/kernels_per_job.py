"""Drivers: device kernels in the profiled sub-window (copies and fills not
counted) over its jobs."""


def read(rec):
    if rec.trace is None or not rec.trace_jobs:
        return None
    return len(rec.trace.kernels) / rec.trace_jobs
