"""Kernels: the job's least time at the device's published peaks (the
larger of its least bytes over the memory rate and its operations over the
FP32 rate, ``work/<family>.py``) over the device's busy time per job (the
union of device operations in the profiled sub-window), in %."""


def read(rec):
    if rec.trace is None or rec.peaks is None or rec.trace.busy <= 0:
        return None
    nbytes, flops = rec.work
    least = max(nbytes / rec.peaks["bytes_per_s"],
                flops / rec.peaks["flops_per_s"])
    return 100.0 * least * rec.trace_jobs / rec.trace.busy
