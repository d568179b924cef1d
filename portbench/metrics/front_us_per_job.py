"""Front end (``transforms.py``): the self time of the program's root spans
``dwt`` and ``idwt`` (each public call less the driver span below it) a
job, over the program-traced sub-window of ``spans.py``, in us.  None
where the program has no spans."""

from portbench import spans


def read(rec):
    program = spans.of(rec)
    return None if program is None else program.front_us
