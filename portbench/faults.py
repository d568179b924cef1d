"""Faults planted in the program's timed path, to show that the judgement
catches them.  ``calibrate.py --fault <name>`` reads them on the card at a
cell's own size, the tests at small sizes; ``run.py`` never plants one.

* ``unwritten``: the inverse level launch (B) that writes the job's final
  output returns without writing it, so the output holds whatever its
  block held before, as a launch that skips its work would leave it.
"""

from __future__ import annotations

import importlib
from contextlib import contextmanager

__all__ = ["NAMES", "planted"]

NAMES = ("unwritten",)
# the family's driver module in the program, and the index of the inverse
# level launch in its table of kernels
_DRIVERS = {"dwt2": "wavelets_tpu_torch.ops.pyramid2d",
            "dwt3": "wavelets_tpu_torch.ops.dwt3d"}
_LEVEL_INV = 1


def _unwritten(real, width: int):
    def fn(*args, out=None, **kwargs):
        if out is not None and out.shape[-1] == width:
            return out
        return real(*args, out=out, **kwargs)
    return fn


@contextmanager
def planted(cell, name: str):
    """Plant fault ``name`` in the program for ``cell`` while the block
    runs."""
    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; faults: {', '.join(NAMES)}")
    driver = importlib.import_module(_DRIVERS[cell.config["family"]])
    real = driver._KERNELS
    kernels = list(real)
    kernels[_LEVEL_INV] = _unwritten(kernels[_LEVEL_INV],
                                     cell.traffic["shape"][-1])
    driver._KERNELS = tuple(kernels)
    try:
        yield
    finally:
        driver._KERNELS = real
