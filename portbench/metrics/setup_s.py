"""End to end: process start to the first timed job, in s."""


def read(rec):
    return rec.setup_s
