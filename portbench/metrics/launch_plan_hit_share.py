"""Launch wrappers (the ``ops/*.py`` entry points and ``ops/build.py``):
the share of launches whose wrapper found the launch plan of its call
signature kept, from the program's counter ``build.PLANS`` (hits over hits
and misses) over the whole run, set-up and warm-up included, in %.  None
where the program has no such counter or made no launch."""

import sys


def read(rec):
    build = sys.modules.get("wavelets_tpu_torch.ops.build")
    plans = getattr(build, "PLANS", None)
    if not plans:
        return None
    total = plans["hits"] + plans["misses"]
    return 100 * plans["hits"] / total if total else None
