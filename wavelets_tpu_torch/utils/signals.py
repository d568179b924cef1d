"""Signal helpers and test-signal generators (host-side NumPy).

Ports of the reference's Util signal helpers:
mirror/upsample/downsample   — src/Util/util_main.jl:30-55
wcount                       — src/Util/util_main.jl:59-80
makewavelet (cascade)        — src/Util/util_main.jl:351-366
testfunction (Donoho–Johnstone) — src/Util/util_main.jl:378-418

These are pure data generators and filter utilities; the traced compute
path never calls them at run time.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "mirror", "upsample", "downsample", "wcount", "circshift",
    "makewavelet", "testfunction",
]


def mirror(f: np.ndarray) -> np.ndarray:
    """Alternate the signs of the filter taps: f[i] * (-1)^i."""
    f = np.asarray(f)
    signs = np.where(np.arange(len(f)) % 2 == 0, 1.0, -1.0)
    return f * signs


def upsample(x: np.ndarray, sw: int = 0) -> np.ndarray:
    """Insert zeros between samples: y[2i + sw] = x[i] (0-based).

    Matches the reference's phase convention (its 1-based ``y[i<<1+sw-1]``
    is exactly 0-based ``y[2i + sw]``).
    """
    assert sw in (0, 1)
    x = np.asarray(x)
    n = len(x)
    y = np.zeros(2 * n, dtype=x.dtype)
    y[sw::2] = x
    return y


def downsample(x: np.ndarray, sw: int = 0) -> np.ndarray:
    """Keep every other sample starting at offset sw."""
    assert sw in (0, 1)
    x = np.asarray(x)
    assert len(x) % 2 == 0
    return x[sw::2].copy()


def wcount(x, t: float = 0.0, level: int = -1) -> int:
    """Count |coef| >= t; for 1-D packed vectors, ``level`` excludes all
    coefficients below that dyadic level (level=-1 counts everything,
    level=0 skips the single coarsest scaling coef, etc.).
    """
    x = np.asarray(x)
    if x.ndim == 1 and level >= -1:
        si = 0 if level < 0 else 2 ** level
        return int(np.sum(np.abs(x[si:]) >= t))
    return int(np.sum(np.abs(x) >= t))


def circshift(x: np.ndarray, shift) -> np.ndarray:
    """Circular shift such that y[i] = x[i - shift] (elementwise per axis).

    NumPy convenience mirror of the reference's Util.circshift!
    (src/Util/util_main.jl:83-130); for traced code use jnp.roll, which has
    identical semantics.
    """
    return np.roll(x, shift)


def makewavelet(h, N: int = 8):
    """Approximate the scaling and wavelet functions from a scaling filter.

    Cascade algorithm with N upsample-convolve iterations
    (reference: src/Util/util_main.jl:351-366).  Accepts a filter carrier
    with a ``qmf`` attribute or a plain vector.

    Returns (phi, psi, x) with ``x`` the support grid.
    """
    if hasattr(h, "qmf"):
        h = h.qmf
    h = np.asarray(h, dtype=np.float64)
    assert N >= 0
    sc = float(np.linalg.norm(h))
    hn = h * np.sqrt(2.0) / sc
    phi = hn.copy()
    psi = mirror(hn[::-1])

    for _ in range(N):
        phi = np.convolve(upsample(phi), hn)
        psi = np.convolve(upsample(psi), hn)
    if N > 0:
        phi = phi[: len(phi) - 2 ** N + 1]
        psi = psi[: len(psi) - 2 ** N + 1]
    phi *= sc / np.sqrt(2.0)
    psi *= sc / np.sqrt(2.0)
    x = np.linspace(0, len(hn) - 1, num=len(psi))
    return phi, psi, x


def testfunction(n: int, ft: str) -> np.ndarray:
    """Donoho–Johnstone test signals on [0, 1): Blocks, Bumps, HeaviSine,
    Doppler.  reference: src/Util/util_main.jl:378-418
    """
    assert n >= 1
    t = np.arange(n, dtype=np.float64) / n
    if ft == "Blocks":
        tj = np.array([0.1, 0.13, 0.15, 0.23, 0.25, 0.4, 0.44, 0.65, 0.76, 0.78, 0.81])
        hj = np.array([4, -5, 3, -4, 5, -4.2, 2.1, 4.3, -3.1, 2.1, -4.2])
        f = np.sum(hj * (1 + np.sign(t[:, None] - tj)) / 2, axis=1)
    elif ft == "Bumps":
        tj = np.array([0.1, 0.13, 0.15, 0.23, 0.25, 0.4, 0.44, 0.65, 0.76, 0.78, 0.81])
        hj = np.array([4, 5, 3, 4, 5, 4.2, 2.1, 4.3, 3.1, 5.1, 4.2])
        wj = np.array([0.005, 0.005, 0.006, 0.01, 0.01, 0.03, 0.01, 0.01, 0.005, 0.008, 0.005])
        f = np.sum(hj / (1 + np.abs((t[:, None] - tj) / wj)) ** 4, axis=1)
    elif ft == "HeaviSine":
        f = 4 * np.sin(4 * np.pi * t) - np.sign(t - 0.3) - np.sign(0.72 - t)
    elif ft == "Doppler":
        f = np.sqrt(t * (1 - t)) * np.sin(2 * np.pi * 1.05 / (t + 0.05))
    else:
        raise ValueError(f"unknown test function {ft!r}")
    return f
