"""Drivers (``ops/scratch.py``): the rise of the program's counter
``scratch.ALLOCATED["bytes"]`` (the bytes the drivers' ping-pong buffers
take from the allocator) over the program-traced sub-window of
``spans.py``, over its jobs, in MiB.  None where the program has no such
counter."""

from portbench import spans


def read(rec):
    program = spans.of(rec)
    return None if program is None else program.scratch_mib
