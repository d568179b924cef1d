"""Drivers (``ops/pyramid2d.py``, ``ops/dwt3d.py``, ``ops/scratch.py``):
the self time of the program's driver spans (planning, scratch, output
allocation and views, less the launch spans below them) a job, over the
program-traced sub-window of ``spans.py``, in us.  None where the program
has no spans."""

from portbench import spans


def read(rec):
    program = spans.of(rec)
    return None if program is None else program.driver_us
