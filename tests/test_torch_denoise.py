"""Noise estimation and denoising (wavelets_tpu_torch/threshold/denoise.py)
against the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU in float64: ``noisest`` within 1e-12 relative, ``denoise`` (plain and
TI) within 1e-12 of the scale, the same errors.  The median is the JAX
package's (the two middle values averaged), so the thresholds agree.
"""

from importlib import import_module

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from wavelets_tpu_torch.wt.convert import from_reference

# the modules, which the packages' denoise functions shadow as attributes
JD = import_module("wavelets_tpu.threshold.denoise")
TD = import_module("wavelets_tpu_torch.threshold.denoise")


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _image(n, seed):
    base = J.testfunction(n, "HeaviSine")
    return np.add.outer(base, base) + 0.3 * \
        np.random.default_rng(seed).standard_normal((n, n))


@pytest.mark.parametrize("shape", [(256,), (64, 64), (16, 16, 16)])
def test_noisest_matches(shape):
    ref = J.wt.wavelet(J.wt.db2)
    wt = from_reference(ref)
    x = np.random.default_rng(31).standard_normal(shape)
    for L in (1, 2):
        want = float(J.noisest(jnp.asarray(x), ref, L))
        got = float(T.noisest(torch.from_numpy(x), wt, L))
        assert abs(got - want) <= 1e-12 * abs(want)
    assert float(T.noisest(torch.from_numpy(x), None)) == pytest.approx(
        float(J.noisest(jnp.asarray(x), None)), rel=1e-12)


def test_noisest_default_wavelet_is_sym5_filter():
    x = _image(64, 32)
    assert TD.DEFAULT_WAVELET.name == JD.DEFAULT_WAVELET.name
    assert float(T.noisest(torch.from_numpy(x))) == pytest.approx(
        float(J.noisest(jnp.asarray(x))), rel=1e-12)


@pytest.mark.parametrize("n, cap", [(1000, 100), (999, 1000), (7, 3)])
def test_mad_subsampled_matches(n, cap):
    """The stride subsample above the cap, and the averaged middle values
    of an even-length median."""
    v = np.random.default_rng(33).standard_normal(n)
    want = float(JD.mad_subsampled(jnp.asarray(v), cap))
    got = float(TD.mad_subsampled(torch.from_numpy(v), cap))
    assert abs(got - want) <= 1e-12 * abs(want)


def test_median_above_the_quantile_limit_sorts():
    v = torch.arange(10.0, dtype=torch.float64)
    assert float(TD._median(v)) == 4.5
    limit = TD._QUANTILE_MAX
    TD._QUANTILE_MAX = 4
    try:
        assert float(TD._median(v)) == 4.5
        assert float(TD._median(v[:9])) == 4.0
    finally:
        TD._QUANTILE_MAX = limit


@pytest.mark.parametrize("name, kind, th", [
    ("db2", "filter", "HardTH"), ("cdf97", "lifting", "SoftTH"),
    ("db4", "filter", "SemiSoftTH")])
def test_denoise_matches(name, kind, th):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind)
    wt = from_reference(ref)
    x = _image(64, 34)
    want = J.denoise(jnp.asarray(x), ref, L=3,
                     dnt=J.VisuShrink(getattr(J, th)(), 2.0))
    got = T.denoise(torch.from_numpy(x), wt, L=3,
                    dnt=T.VisuShrink(getattr(T, th)(), 2.0))
    _close(got, want)
    _close(T.denoise(torch.from_numpy(x), wt), J.denoise(jnp.asarray(x), ref))


def test_denoise_without_wavelet_thresholds_the_input():
    x = _image(32, 35)
    _close(T.denoise(torch.from_numpy(x), None),
           J.denoise(jnp.asarray(x), None))


@pytest.mark.parametrize("shape, nspin", [((128,), (4,)), ((128,), 3),
                                          ((32, 32), (2, 3))])
def test_denoise_TI_matches(shape, nspin):
    """The TI spins in the reference's Fortran order, averaged."""
    ref = J.wt.wavelet(J.wt.cdf97, "lifting")
    wt = from_reference(ref)
    x = np.random.default_rng(36).standard_normal(shape) + 1.0
    want = J.denoise(jnp.asarray(x), ref, L=2, TI=True, nspin=nspin)
    got = T.denoise(torch.from_numpy(x), wt, L=2, TI=True, nspin=nspin)
    _close(got, want)


@pytest.mark.parametrize("shape, nspin", [((128,), 8), ((32, 32), (2, 3))])
@pytest.mark.parametrize("chunk", [1, 3, 1000])
def test_denoise_TI_spin_chunk_matches(shape, nspin, chunk):
    """spin_chunk spins at a time, on the drivers' batch axis: the JAX
    package's chunked vmap sums in another order, so 1e-10 relative."""
    ref = J.wt.wavelet(J.wt.db2)
    wt = from_reference(ref)
    x = J.testfunction(shape[0], "Bumps")
    if len(shape) == 2:
        x = np.add.outer(x, x[::-1])
    x = x + 0.1 * np.random.default_rng(37).standard_normal(shape)
    want = J.denoise(jnp.asarray(x), ref, L=3, TI=True, nspin=nspin,
                     spin_chunk=chunk)
    got = T.denoise(torch.from_numpy(x), wt, L=3, TI=True, nspin=nspin,
                    spin_chunk=chunk)
    _close(got, want, tol=1e-10)


@pytest.mark.parametrize("shape, nspin", [((128,), 8), ((32, 32), (2, 3))])
def test_denoise_TI_spin_chunk_biggest_per_spin(shape, nspin):
    """BiggestTH keeps m coefficients of each spin's transform, also when
    the spins of a chunk share one batch."""
    ref = J.wt.wavelet(J.wt.db2)
    x = np.random.default_rng(38).standard_normal(shape)
    m = x.size // 8
    want = J.denoise(jnp.asarray(x), ref, L=3, TI=True, nspin=nspin,
                     spin_chunk=3, dnt=J.VisuShrink(J.BiggestTH(), m),
                     estnoise=lambda v, wt: 1.0)
    got = T.denoise(torch.from_numpy(x), from_reference(ref), L=3, TI=True,
                    nspin=nspin, spin_chunk=3,
                    dnt=T.VisuShrink(T.BiggestTH(), m),
                    estnoise=lambda v, wt: 1.0)
    _close(got, want, tol=1e-10)


def test_spin_shifts_fortran_order():
    assert np.array_equal(TD._spin_shifts((2, 3), 2),
                          JD._spin_shifts((2, 3), 2))
    assert TD._spin_shifts((2, 3), 2)[1].tolist() == [1, 0]
    with pytest.raises(ValueError):
        TD._spin_shifts((2,), 2)


def test_denoise_refusals_and_visushrink():
    wt = T.wavelet(T.wt.db2)
    with pytest.raises(ValueError):
        T.denoise(torch.zeros((16, 32)), wt)             # not square
    with pytest.raises(ValueError):
        T.denoise(torch.zeros((16, 16)), None, TI=True)
    v = T.VisuShrink(1024)
    assert v.th == T.HardTH() and v.t == pytest.approx(
        J.VisuShrink(1024).t, rel=1e-15)
    assert T.VisuShrink.for_length(64, T.SoftTH()).th == T.SoftTH()
