"""Lifting-scheme definitions.

A general lifting scheme (GLS) is a sequence of predict/update steps plus a
final (norm1, norm2) diagonal normalization of the (scaling, detail) halves.
Step semantics (0-based, after the even/odd split s=x[::2], d=x[1::2];
half = len(s)):

  predict: s[i] += sum_k coef[k] * d[(i + k - shift) % half]
  update:  d[j] += sum_k coef[k] * s[(j + k - shift) % half]

On the forward transform the step coefficients are negated and the halves
are scaled by (norm1, norm2) afterwards; the inverse applies 1/norm first,
then the steps in reverse order with unnegated coefficients, then
re-interleaves.  This matches the reference engine's conventions
(src/Transforms/transforms_lifting.jl:13-25,323-483; tables at
src/WT/wt_main.jl:451-480).

Scheme constants are the standard published factorizations: CDF 9/7 from
Daubechies & Sweldens, "Factoring wavelet transforms into lifting steps"
(1998); Haar/db1/db2 from the same paper's examples.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["LSStep", "SCHEMES", "PREDICT", "UPDATE"]

PREDICT = "predict"
UPDATE = "update"


@dataclasses.dataclass(frozen=True)
class LSStep:
    """One lifting step: kind is 'predict' (writes the scaling half) or
    'update' (writes the detail half); coef are the taps; shift is the
    left-shift applied to the read index."""
    kind: str
    coef: Tuple[float, ...]
    shift: int

    def __post_init__(self):
        if self.kind not in (PREDICT, UPDATE):
            raise ValueError(f"bad step kind {self.kind!r}")
        object.__setattr__(self, "coef", tuple(float(c) for c in self.coef))


_C97_U1 = 1.5861343420604
_C97_P1 = 0.05298011857291494
_C97_U2 = -0.882911075531393
_C97_P2 = -0.44350685204384654

SCHEMES = {
    # Cohen–Daubechies–Feauveau 9/7 (bior4.4); 4 two-tap steps + scaling
    "cdf9/7": (
        (
            LSStep(UPDATE, (_C97_U1, _C97_U1), 0),
            LSStep(PREDICT, (_C97_P1, _C97_P1), 1),
            LSStep(UPDATE, (_C97_U2, _C97_U2), 0),
            LSStep(PREDICT, (_C97_P2, _C97_P2), 1),
        ),
        1.1496043988603355,
        0.8698644516247099,
    ),
    "haar": (
        (
            LSStep(PREDICT, (-1.0,), 0),
            LSStep(UPDATE, (0.5,), 0),
        ),
        0.7071067811865475,
        1.4142135623730951,
    ),
    "db1": (
        (
            LSStep(PREDICT, (-1.0,), 0),
            LSStep(UPDATE, (0.5,), 0),
        ),
        0.7071067811865475,
        1.4142135623730951,
    ),
    "db2": (
        (
            LSStep(PREDICT, (-1.7320508075688772,), 0),
            LSStep(UPDATE, (-0.0669872981077807, 0.4330127018922193), 1),
            LSStep(PREDICT, (1.0,), -1),
        ),
        0.5176380902050414,
        1.9318516525781364,
    ),
}
