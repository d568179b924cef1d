"""Greedy matching pursuit (Mallat 2009, p.642).

The counterpart of ``wavelets_tpu/threshold/pursuit.py`` (reference:
src/Threshold/basis_functions.jl).  The data-dependent stopping rule
(residual norm against the tolerance) is a host loop: each step reads one
norm back from the tensor's device.
"""

from __future__ import annotations

import torch

from ..transforms import _as_tensor

__all__ = ["matchingpursuit"]


def matchingpursuit(x, f, ft, tol: float, nmax: int = -1, *, device=None):
    """Sparse y with ||x - f(y)|| < tol (approximately), built greedily.

    ``f``/``ft`` are the dictionary operator and its transpose (functions of
    tensors).  ``nmax`` bounds the number of atoms (-1: len(ft(x))).  The
    atom of largest |ft(r)| is taken, the first one among equals.
    """
    if nmax < -1:
        raise ValueError(f"nmax must be >= -1, got {nmax}")
    if not tol > 0:
        raise ValueError(f"tol must be > 0, got {tol}")
    x = _as_tensor(x, device)
    y = torch.zeros_like(ft(x))
    if y.ndim != 1:
        # the flat argmax below is an index along axis 0: a rank > 1
        # dictionary output would select wrong atoms
        raise ValueError("matchingpursuit expects ft(x) to be 1-D "
                         f"(got shape {tuple(y.shape)})")
    if nmax == -1:
        nmax = y.numel()
    r, n = x, 0
    while n < nmax and torch.linalg.norm(r) > tol:
        ftr = ft(r)
        i = torch.argmax(ftr.abs())
        spat = torch.zeros_like(y)
        spat[i] = ftr[i]
        y[i] += ftr[i]
        r = r - f(spat)
        n += 1
    return y
