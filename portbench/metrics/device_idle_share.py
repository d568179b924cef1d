"""Device: one less the device's busy time per job (the union of device
operations in the profiled sub-window over its jobs) over the wall time per
job of the same run's jobs outside it (host clock, the profiler off), in %.
The profiler's own cost per host operation slows the host inside the
sub-window, so its wall time would count that cost as the device's idle
time wherever the host leads."""


def read(rec):
    untraced_jobs = rec.jobs - rec.trace_jobs
    if rec.trace is None or untraced_jobs <= 0 or rec.untraced_s <= 0:
        return None
    busy_per_job = rec.trace.busy / rec.trace_jobs
    return 100.0 * (1.0 - busy_per_job / (rec.untraced_s / untraced_jobs))
