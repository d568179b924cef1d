"""Front end (``transforms.py``): the host's time inside a job's ``dwt`` and
``idwt`` calls (enqueue only), the mean over the traced run's jobs outside
the profiled sub-window, whose profiler would add its own cost per host
operation; in ms."""


def read(rec):
    if rec.trace is None or not rec.host_s_untraced:
        return None
    return 1e3 * sum(rec.host_s_untraced) / len(rec.host_s_untraced)
