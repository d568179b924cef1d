"""Carry a wavelet carrier of ``wavelets_tpu`` across to this package.

``from_reference(wt)`` rebuilds a carrier of the JAX package (an
``OrthoFilter`` or a ``GLS``) as the port's own carrier with identical
coefficients.  It is duck-typed on the carrier's fields and imports
nothing of JAX, so both packages can be fed the very same wavelet.
"""

from __future__ import annotations

from .carriers import GLS, OrthoFilter, PERIODIC
from .schemes import LSStep

__all__ = ["from_reference"]


def from_reference(wt):
    """The port's carrier with the same coefficients as ``wt``: for a GLS
    its steps (kind, coef, shift), norm1, norm2, name and boundary; for an
    OrthoFilter its qmf, name and boundary."""
    boundary = str(getattr(wt, "boundary", PERIODIC))
    if hasattr(wt, "steps"):
        steps = tuple(LSStep(str(s.kind), tuple(float(c) for c in s.coef),
                             int(s.shift)) for s in wt.steps)
        return GLS(steps, float(wt.norm1), float(wt.norm2), str(wt.name),
                   boundary)
    if hasattr(wt, "qmf"):
        return OrthoFilter(tuple(float(c) for c in wt.qmf), str(wt.name),
                           boundary)
    raise TypeError(f"not a wavelet carrier: {type(wt).__name__}")
