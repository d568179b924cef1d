"""End to end: samples of all jobs completed in the window over the
window's seconds (host clock, first job's start to last job's end), in
Gsamples/s."""


def read(rec):
    if not rec.jobs or rec.seconds <= 0:
        return None
    return rec.jobs * rec.samples_per_job / rec.seconds / 1e9
