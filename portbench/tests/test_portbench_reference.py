"""The benchmark's float64 reference against the JAX package's ``dwt`` /
``idwt`` on the CPU, and its own round trip.  CPU only: this file imports
JAX, which the card's machine does not have, so it holds no card test."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import wavelets_tpu as W  # noqa: E402

from portbench.reference import dwt2, dwt3  # noqa: E402

CASES = [(dwt2, (32, 64), 3), (dwt2, (3, 16, 16), 4), (dwt2, (64, 64), 6),
         (dwt3, (16, 8, 32), 2), (dwt3, (2, 8, 8, 8), 3),
         (dwt3, (16, 16, 16), 4)]


@pytest.mark.parametrize("name", ["cdf97", "haar"])
@pytest.mark.parametrize("family, shape, L", CASES)
def test_reference_matches_the_jax_package(family, shape, L, name):
    wt = W.wavelet(getattr(W.wt, name), "lifting")
    x = np.random.default_rng(sum(shape) + L).standard_normal(shape)
    want = np.array(W.dwt(x, wt, L, ndt=family.NDT))
    got = family.dwt(torch.from_numpy(x), family.scheme(name), L).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    back = np.array(W.idwt(want, wt, L, ndt=family.NDT))
    mine = family.idwt(torch.from_numpy(want), family.scheme(name),
                       L).numpy()
    assert np.abs(mine - back).max() <= 1e-12 * np.abs(back).max()


@pytest.mark.parametrize("name", ["cdf97", "haar"])
@pytest.mark.parametrize("family, shape, L", CASES)
def test_reference_round_trip(family, shape, L, name):
    x = torch.from_numpy(np.random.default_rng(L).standard_normal(shape))
    sch = family.scheme(name)
    y = family.dwt(x, sch, L)
    assert y.dtype == torch.float64
    assert (family.idwt(y, sch, L) - x).abs().max() <= 1e-12


@pytest.mark.parametrize("family, shape, L", CASES)
def test_regions_tile_the_array_once(family, shape, L):
    cover = torch.zeros(shape, dtype=torch.int64)
    for _, idx, scope in family.regions(shape, L):
        cover[idx] += 1
        inside = torch.zeros(shape, dtype=torch.bool)
        inside[scope] = True
        assert bool(inside[idx].all())
    assert bool((cover == 1).all())
    assert len(family.regions(shape, L)) == (2 ** family.NDT - 1) * L + 1
