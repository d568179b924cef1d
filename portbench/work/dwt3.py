"""Least work of one 3-D lifting job: a forward and an inverse transform
of the trailing three axes."""

from __future__ import annotations

from .lifting import one_direction

NDT = 3


def job(shape, L: int, itemsize: int, sch: dict) -> tuple[float, float]:
    """(bytes, operations) of one job: both directions."""
    b, f = one_direction(shape, L, itemsize, sch, NDT)
    return 2 * b, 2 * f
