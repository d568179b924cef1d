"""End to end: ``torch.cuda.max_memory_allocated()`` over the window, from
the moment the reservoir of jobs kept for the check is full, less what
that reservoir holds: the input pool, the jobs in flight and what the
library holds beside them, in GiB."""


def read(rec):
    if not rec.peak_bytes:
        return None
    return (rec.peak_bytes - rec.kept_bytes) / 2 ** 30
