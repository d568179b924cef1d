"""The threshold layer's operators, entropies, best-basis search and
matching pursuit (wavelets_tpu_torch/threshold/) against the JAX package.

Inputs are made with numpy from a seed and go through both packages on the
CPU in float64.  Tolerances: 1e-12 relative for values, identical trees,
the same errors.  The packet levels of the best-basis search run kernel
E's plain version here; on the card chip_smoke.py runs the search through
the kernel (phase 3f).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wavelets_tpu as J
import wavelets_tpu_torch as T
from wavelets_tpu_torch.threshold import entropy as TE
from wavelets_tpu_torch.wt.convert import from_reference

OPS = ["HardTH", "SoftTH", "SemiSoftTH", "SteinTH", "PosTH", "NegTH"]


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("op", OPS)
def test_operators_match(op):
    x = np.random.default_rng(21).standard_normal((16, 24)) * 2
    for t in (0.0, 0.7, 1.5):
        want = J.threshold(jnp.asarray(x), getattr(J, op)(), t)
        got = T.threshold(torch.from_numpy(x), getattr(T, op)(), t)
        _close(got, want)


@pytest.mark.parametrize("m", [0, 1, 7, 40, 200])
def test_biggest_keeps_the_m_largest_with_ties_by_index(m):
    """Magnitudes drawn from few values, so many tie: lax.top_k keeps the
    lower index among equals, and so does the port's stable sort."""
    rng = np.random.default_rng(22)
    x = rng.choice([-3.0, -1.0, 1.0, 2.0, 3.0], size=(8, 20))
    want = J.threshold(jnp.asarray(x), J.BiggestTH(), m)
    got = T.threshold(torch.from_numpy(x), T.BiggestTH(), m)
    assert np.array_equal(np.asarray(want), got.numpy())


def test_stein_maps_zero_to_zero():
    """At x = 0 both packages compute 1 - t^2/0: NaN where t = 0 (0/0),
    and 0 where t > 0."""
    x = np.array([0.0, 0.5, -2.0, 0.0, 1e-3])
    for t in (0.0, 0.7, 1.0):
        want = np.asarray(J.threshold(jnp.asarray(x), J.SteinTH(), t))
        got = T.threshold(torch.from_numpy(x), T.SteinTH(), t).numpy()
        assert np.array_equal(got, want, equal_nan=True), t
        assert np.isnan(got[0]) == (t == 0.0) and np.isnan(got[3]) == (t == 0)
        if t > 0:
            assert got[0] == 0 and got[3] == 0


def test_threshold_takes_a_tensor_threshold_and_keeps_dtype():
    x = torch.from_numpy(np.random.default_rng(23).standard_normal(64)) \
        .float()
    t = torch.tensor(0.5, dtype=torch.float64)
    out = T.threshold(x, T.SoftTH(), t)
    assert out.dtype == torch.float32
    _close(out, T.threshold(x, T.SoftTH(), 0.5))
    with pytest.raises(ValueError):
        T.threshold(x, object(), 0.5)


@pytest.mark.parametrize("et", ["ShannonEntropy", "LogEnergyEntropy"])
def test_coefentropy_matches(et):
    x = np.random.default_rng(24).standard_normal(128)
    x[5] = 0.0
    want = float(J.coefentropy(jnp.asarray(x), getattr(J, et)()))
    got = float(T.coefentropy(torch.from_numpy(x), getattr(T, et)()))
    assert abs(got - want) <= 1e-12 * abs(want)
    want = float(J.coefentropy(jnp.asarray(x), getattr(J, et)(), 3.0))
    got = float(T.coefentropy(torch.from_numpy(x), getattr(T, et)(), 3.0))
    assert abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("name, kind, bd", [
    ("db2", "filter", "periodic"), ("cdf97", "lifting", "periodic"),
    ("haar", "lifting", "zeropad"), ("db4", "filter", "periodic")])
def test_bestbasistree_identical(name, kind, bd):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind, bd)
    wt = from_reference(ref)
    x = np.random.default_rng(25).standard_normal(512)
    for kwargs in ({}, {"L": 4}):
        want = J.bestbasistree(jnp.asarray(x), ref, **kwargs)
        got = T.bestbasistree(torch.from_numpy(x), wt, **kwargs)
        assert got.dtype == bool and np.array_equal(want, got), kwargs
        assert T.isvalidtree(512, got)


def test_bestbasistree_given_tree_and_entropy():
    ref = J.wt.wavelet(J.wt.db2)
    wt = from_reference(ref)
    x = np.random.default_rng(26).standard_normal(256)
    tree = J.maketree(256, 5, "dwt")
    for et in ("ShannonEntropy", "LogEnergyEntropy"):
        want = J.bestbasistree(jnp.asarray(x), ref, tree=tree,
                               et=getattr(J, et)())
        got = T.bestbasistree(torch.from_numpy(x), wt, tree=tree,
                              et=getattr(T, et)())
        assert np.array_equal(want, got), et


def test_bestbasistree_refusals():
    wt = T.wavelet(T.wt.db2)
    with pytest.raises(ValueError):
        T.bestbasistree(torch.zeros((4, 4)), wt)
    with pytest.raises(ValueError):
        T.bestbasistree(torch.zeros(64), wt, L=7)
    with pytest.raises(ValueError):
        T.bestbasistree(torch.zeros(64), wt,
                        tree=np.zeros(31, dtype=bool))
    bad = np.zeros(63, dtype=bool)
    bad[1] = True                         # a child of an inactive root
    with pytest.raises(ValueError):
        T.bestbasistree(torch.zeros(64), wt, tree=bad)


def test_prune_matches_the_host_prune():
    """The prune on the entropies' device against the JAX package's host
    reference (threshold.entropy.prune_tree) on random entropies."""
    from wavelets_tpu.threshold.entropy import prune_tree
    rng = np.random.default_rng(27)
    D = 6
    levels = [rng.random(2 ** d) * 4 for d in range(D)]
    af = rng.random(2 ** (D - 1)) * 4
    tree = np.ones(2 ** D - 1, dtype=bool)
    want = prune_tree(tree, np.concatenate(levels), af, 2 ** D)
    got = TE.prune([torch.from_numpy(v) for v in levels], torch.from_numpy(af),
                   [None] * D)
    assert np.array_equal(want, got)


def _dictionary(ref, wt):
    """An orthogonal dictionary: the inverse DWT (f) and the DWT (ft)."""
    jf = (lambda y: J.idwt(y, ref, 3), lambda v: J.dwt(v, ref, 3))
    tf = (lambda y: T.idwt(y, wt, 3), lambda v: T.dwt(v, wt, 3))
    return jf, tf


@pytest.mark.parametrize("nmax", [-1, 5])
def test_matchingpursuit_matches(nmax):
    ref = J.wt.wavelet(J.wt.db2)
    wt = from_reference(ref)
    x = np.random.default_rng(28).standard_normal(64)
    (jf, jft), (tf, tft) = _dictionary(ref, wt)
    want = J.matchingpursuit(jnp.asarray(x), jf, jft, 1e-3, nmax)
    got = T.matchingpursuit(torch.from_numpy(x), tf, tft, 1e-3, nmax)
    _close(got, want)


def test_matchingpursuit_refusals():
    wt = T.wavelet(T.wt.db2)
    x = torch.zeros(16)
    with pytest.raises(ValueError):                 # rank guard
        T.matchingpursuit(x, lambda v: v.reshape(-1),
                          lambda v: v.reshape(4, 4), 1e-3, 2)
    with pytest.raises(ValueError):
        T.matchingpursuit(x, lambda v: v, lambda v: v, 0.0)
    with pytest.raises(ValueError):
        T.matchingpursuit(x, lambda v: v, lambda v: v, 1e-3, -2)
    assert torch.equal(T.matchingpursuit(
        x, lambda y: T.idwt(y, wt, 2), lambda v: T.dwt(v, wt, 2), 1e-3), x)
