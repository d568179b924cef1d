"""Drivers (``ops/pyramid2d.py``): the share of the 2-D driver's CUDA calls
that replayed the CUDA graph of their call signature, from the program's
counter ``pyramid2d.GRAPHS`` (replays over captures, replays, refused
captures and calls through the launch wrappers) over the whole run,
set-up and warm-up included, in %.  None where the program has no such
counter or made no CUDA call of the 2-D driver."""

import sys


def read(rec):
    pyramid2d = sys.modules.get("wavelets_tpu_torch.ops.pyramid2d")
    graphs = getattr(pyramid2d, "GRAPHS", None)
    if not graphs:
        return None
    total = sum(graphs.values())
    return 100 * graphs["replays"] / total if total else None
