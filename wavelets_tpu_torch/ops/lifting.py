"""Lifting-scheme DWT engine in PyTorch (GLS; periodic, zeropad, symmetric).

The torch counterpart of ``wavelets_tpu/ops/lifting.py``.  Each lifting
step writes one half reading only the other half, so a step is

    s <- s -/+ sum_k c[k] * roll(d, shift - k)     (predict)
    d <- d -/+ sum_k c[k] * roll(s, shift - k)     (update)

with a periodic roll along the last axis.  "zeropad" and "symmetric"
(half-sample reflection, ext[-j] = x[j-1], ext[n-1+j] = x[n-j]) are the
periodic roll plus an overwrite of the |shift - k| entries that wrapped;
since each step reads only the fully known other half, the inverse
re-applies the same extension and reconstructs exactly.

Forward: split even/odd, steps with negated coefficients, scale the halves
by (norm1, norm2).  Inverse: scale by the reciprocals, steps reversed with
the original coefficients, re-interleave.  It runs on the tensor's own
device; the 2-D periodic route of ``transforms.dwt`` goes to
ops/pyramid2d.py instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..wt.carriers import GLS, PERIODIC
from ..wt.factor import check_boundary_stability
from ..wt.schemes import PREDICT

__all__ = [
    "numpy_dtype", "split_last", "merge_last", "lift_steps",
    "lifting_level_fw", "lifting_level_inv",
    "dwt1d_lifting", "idwt1d_lifting", "dwt_nd_lifting", "idwt_nd_lifting",
]


def numpy_dtype(dtype: torch.dtype):
    """The NumPy dtype that ``factor.check_boundary_stability`` probes for a
    torch dtype: float64 for float64, float32 for every narrower float
    (bfloat16 has no NumPy dtype; the probe keys on the item size)."""
    return np.float64 if dtype == torch.float64 else np.float32


def split_last(x):
    """Deinterleave the last axis: (s, d) = (x[..., 0::2], x[..., 1::2])."""
    r = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return r[..., 0], r[..., 1]


def merge_last(s, d):
    """Re-interleave: the inverse of split_last."""
    n = s.shape[-1] + d.shape[-1]
    return torch.stack([s, d], dim=-1).reshape(*s.shape[:-1], n)


def _fix_edges(term, src, sh: int, boundary: str):
    """Overwrite the |sh| entries of ``term = roll(src, sh)`` that wrapped
    with the boundary-extension values (zeros, or the half-sample
    reflection of src)."""
    zero = boundary != "symmetric"
    if sh > 0:
        term[..., :sh] = 0 if zero else torch.flip(src[..., :sh], dims=(-1,))
    else:
        term[..., sh:] = 0 if zero else torch.flip(src[..., sh:], dims=(-1,))
    return term


def _step_sum(src, coef, shift: int, boundary: str = PERIODIC):
    """sum_k coef[k] * src_ext[i + k - shift] along the last axis."""
    n = src.shape[-1]
    acc = None
    for k, c in enumerate(coef):
        sh = shift - k
        term = torch.roll(src, sh, dims=-1) if sh != 0 else src
        if sh != 0 and boundary != PERIODIC:
            if abs(sh) > n:
                raise NotImplementedError(
                    f"boundary {boundary!r} needs half length >= the step "
                    f"reach |{sh}| (transform fewer levels)")
            term = _fix_edges(term, src, sh, boundary)
        term = c * term
        acc = term if acc is None else acc + term
    return acc


def lift_steps(s, d, scheme: GLS, fw: bool):
    """Apply the scheme's step sequence to the (s, d) pair."""
    steps = scheme.steps if fw else scheme.steps[::-1]
    sign = -1.0 if fw else 1.0
    bd = scheme.boundary
    for step in steps:
        if step.kind == PREDICT:
            s = s + sign * _step_sum(d, step.coef, step.shift, bd)
        else:
            d = d + sign * _step_sum(s, step.coef, step.shift, bd)
    return s, d


def lifting_level_fw(x, scheme: GLS):
    """One forward lifting level along the last axis -> (s, d)."""
    check_boundary_stability(scheme, numpy_dtype(x.dtype))
    s, d = lift_steps(*split_last(x), scheme, fw=True)
    return s * scheme.norm1, d * scheme.norm2


def lifting_level_inv(s, d, scheme: GLS):
    """One inverse lifting level along the last axis -> x."""
    check_boundary_stability(scheme, numpy_dtype(s.dtype))
    s, d = lift_steps(s * (1.0 / scheme.norm1), d * (1.0 / scheme.norm2),
                      scheme, fw=False)
    return merge_last(s, d)


def dwt1d_lifting(x, scheme: GLS, L: int):
    if L == 0:
        return x
    s = x
    details = []
    for _ in range(L):
        s, d = lifting_level_fw(s, scheme)
        details.append(d)
    return torch.cat([s] + details[::-1], dim=-1)


def idwt1d_lifting(y, scheme: GLS, L: int):
    if L == 0:
        return y
    n = y.shape[-1]
    s = y[..., : n >> L]
    for l in range(L, 0, -1):
        s = lifting_level_inv(s, y[..., n >> l: n >> (l - 1)], scheme)
    return s


def _level_along_axis(active, scheme, axis: int, fw: bool):
    moved = torch.movedim(active, axis, -1)
    if fw:
        out = torch.cat(lifting_level_fw(moved, scheme), dim=-1)
    else:
        half = moved.shape[-1] // 2
        out = lifting_level_inv(moved[..., :half], moved[..., half:], scheme)
    return torch.movedim(out, -1, axis)


def dwt_nd_lifting(x, scheme: GLS, L: int, ndt: int):
    """Separable multi-dimensional lifting DWT, with the filter engine's
    axis and level order; any per-axis size divisible by 2^L works."""
    if L == 0:
        return x
    y = x.clone()
    tshape = x.shape[-ndt:]
    for l in range(L):
        idx = (Ellipsis,) + tuple(slice(0, s >> l) for s in tshape)
        active = y[idx]
        for axis in range(-1, -ndt - 1, -1):
            active = _level_along_axis(active, scheme, axis, fw=True)
        y[idx] = active
    return y


def idwt_nd_lifting(y, scheme: GLS, L: int, ndt: int):
    if L == 0:
        return y
    x = y.clone()
    tshape = y.shape[-ndt:]
    for l in range(L, 0, -1):
        idx = (Ellipsis,) + tuple(slice(0, s >> (l - 1)) for s in tshape)
        active = x[idx]
        for axis in range(-ndt, 0):
            active = _level_along_axis(active, scheme, axis, fw=False)
        x[idx] = active
    return x
