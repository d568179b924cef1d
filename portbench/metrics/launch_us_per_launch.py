"""Launch wrappers (the ``ops/*.py`` entry points and ``ops/build.py``):
the mean duration of a launch span, from the wrapper's entry to its
return, its ``.call`` child (the call into the kernels' library)
included, over the program-traced sub-window of ``spans.py``, in us.
None where the program has no spans or no launch ran."""

from portbench import spans


def read(rec):
    program = spans.of(rec)
    return None if program is None else program.launch_us
