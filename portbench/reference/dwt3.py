"""Plain reference of the periodic 3-D lifting DWT (the trailing three axes;
leading axes are batch), in float64."""

from __future__ import annotations

from . import lifting

NDT = 3
scheme = lifting.scheme


def dwt(x, sch, L: int):
    return lifting.dwt(x, sch, L, NDT)


def idwt(y, sch, L: int):
    return lifting.idwt(y, sch, L, NDT)


def regions(shape, L: int):
    return lifting.regions(shape, L, NDT)
