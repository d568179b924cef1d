"""Analytic Daubechies scaling-filter generator.

Same construction as the reference (src/WT/wt_main.jl:271-361): the
degree-(N-1) truncated binomial series is rooted via its companion matrix,
roots are mapped to the z-domain, the minimum-phase half (|z| <= 1) is kept,
and the filter is rebuilt from the root set {-1 (xN)} U {kept z-roots} by a
Vieta recurrence, then l2-normalized.  Host-side float64 NumPy; runs once at
wavelet-construction time.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["daubechies"]


def _compan(C: np.ndarray) -> np.ndarray:
    """Companion matrix of a polynomial given highest-power-first coefs."""
    n = len(C)
    A = np.zeros((n - 1, n - 1))
    if n > 1:
        A[0, :] = -C[1:] / C[0]
        A[1:, :-1] += np.eye(n - 2)
    return A


def _roots(C: np.ndarray) -> np.ndarray:
    if len(C) <= 1:
        return np.zeros(0, dtype=np.complex128)
    return np.linalg.eigvals(_compan(C))


def _vieta(R: np.ndarray) -> np.ndarray:
    """Polynomial coefficients (highest power first) from roots."""
    n = len(R)
    C = np.zeros(n + 1, dtype=np.complex128)
    C[0] = 1.0
    for k in range(n):
        Ci = C[0]
        for i in range(k + 1):
            Cig = C[i + 1]
            C[i + 1] = Cig - R[k] * Ci
            Ci = Cig
    return C


def daubechies(N: int) -> np.ndarray:
    """Return the length-2N Daubechies-N scaling filter (l2-normalized)."""
    assert N > 0
    # truncated binomial series of (1 - y)^{-N}, highest powers first
    C = np.array([math.comb(N - 1 + n, n) for n in range(N - 1, -1, -1)],
                 dtype=np.float64)

    Y = _roots(C)

    # z + 1/z = 2 - 4y  =>  z = (1 - 2y) +/- 2*sqrt(y^2 - y)
    Z = np.zeros(2 * N - 2, dtype=np.complex128)
    for i in range(N - 1):
        Yi = Y[i]
        d = 2.0 * np.sqrt(Yi * Yi - Yi)
        y2 = 1.0 - 2.0 * Yi
        Z[i] = y2 + d
        Z[i + N - 1] = y2 - d

    keep = Z[np.abs(Z) <= 1 + np.finfo(np.float64).eps]

    # filter roots: N zeros at z = -1 plus the retained minimum-phase roots
    R = np.concatenate([np.full(N, -1.0 + 0.0j), keep])
    HH = _vieta(R)
    HH = HH / np.linalg.norm(HH)
    return np.real(HH)
