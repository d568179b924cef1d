"""Public ``wpt`` / ``iwpt`` of the port against ``wavelets_tpu``'s.

The same numpy input, from a seed, goes through both packages in float64
on the CPU; the port's periodic route runs one 1-D level per tree depth
through the level kernel's plain version (ops/level1d.py), other
boundaries its torch engines.  Tolerance 1e-12 x max(1, max|ref|); sym6
round trips to its table's printed orthogonality (5e-9).
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import level1d
from wavelets_tpu_torch.wt.convert import from_reference


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One BLAS and one torch thread: the suite runs its files on parallel
    workers, and threads oversubscribed across them slow every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _carriers(name, kind, boundary="periodic"):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind, boundary)
    return ref, from_reference(ref)


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _partial_tree(n):
    """A valid tree that transforms some segments deeper than others."""
    tree = np.zeros(n - 1, dtype=bool)
    tree[[0, 1, 2, 3, 6, 14]] = True
    return tree


TREES = {
    "full": lambda n: J.maketree(n, 4, "full"),
    "dwt": lambda n: J.maketree(n, 5, "dwt"),
    "partial": _partial_tree,
}


@pytest.mark.parametrize("tree_kind", sorted(TREES))
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("db4", "filter"),
                                        ("sym6", "filter")])
def test_trees_match_the_jax_package(name, kind, tree_kind):
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(51).standard_normal(64)
    tree = TREES[tree_kind](64)
    assert J.isvalidtree(64, tree)
    want = J.wpt(x, ref, tree)
    got = T.wpt(torch.from_numpy(x), wt, tree)
    _close(got, want)
    _close(T.iwpt(got, wt, tree), J.iwpt(want, ref, tree))
    _close(T.iwpt(got, wt, tree), x, 5e-9 if name == "sym6" else 1e-12)


@pytest.mark.parametrize("L", [None, 3, 10])
def test_levels_overload_and_batch(L):
    """An integer third positional is L (default: the most the length
    allows); leading axes batch."""
    ref, wt = _carriers("cdf97", "lifting")
    x = np.random.default_rng(52).standard_normal((3, 1024))
    want = J.wpt(x, ref) if L is None else J.wpt(x, ref, L)
    got = T.wpt(x, wt, device="cpu") if L is None \
        else T.wpt(x, wt, L, device="cpu")
    _close(got, want)
    back = T.iwpt(got, wt) if L is None else T.iwpt(got, wt, L=L)
    _close(back, x)


def test_periodic_route_takes_the_level_kernel_plain_version():
    """One level launch per depth; a CPU tensor moves PLAIN_CALLS only."""
    _, wt = _carriers("db4", "filter")
    x = torch.from_numpy(np.random.default_rng(53).standard_normal(256))
    launches = dict(level1d.LAUNCHES)
    before = dict(level1d.PLAIN_CALLS)
    y = T.wpt(x, wt, 5)
    T.iwpt(y, wt, 5)
    assert level1d.LAUNCHES == launches
    assert level1d.PLAIN_CALLS["level1d_fw"] == before["level1d_fw"] + 5
    assert level1d.PLAIN_CALLS["level1d_inv"] == before["level1d_inv"] + 5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_dtypes_track_float64(dtype):
    ref, wt = _carriers("db4", "filter")
    x = np.random.default_rng(54).standard_normal(512)
    want = np.asarray(J.wpt(x, ref, 6))
    got = T.wpt(torch.from_numpy(x).to(dtype), wt, 6)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(
        want).max()


@pytest.mark.parametrize("boundary", ["zeropad", "symmetric"])
def test_non_periodic_boundaries_take_the_lifting_engine(boundary):
    ref, wt = _carriers("cdf97", "lifting", boundary)
    x = np.random.default_rng(55).standard_normal((2, 128))
    calls = dict(level1d.PLAIN_CALLS)
    got = T.wpt(torch.from_numpy(x), wt, 4)
    assert level1d.PLAIN_CALLS == calls
    _close(got, J.wpt(x, ref, 4))
    _close(T.iwpt(got, wt, 4), J.iwpt(np.asarray(J.wpt(x, ref, 4)), ref, 4))


def test_inactive_root_and_empty_tree_are_the_identity():
    ref, wt = _carriers("haar", "lifting")
    x = torch.from_numpy(np.random.default_rng(56).standard_normal(32))
    off = np.zeros(31, dtype=bool)
    assert torch.equal(T.wpt(x, wt, off), x)
    assert torch.equal(T.iwpt(x, wt, off), x)
    _close(T.wpt(x, wt, off), J.wpt(x.numpy(), ref, off))
    odd = torch.ones(7, dtype=torch.float64)      # no factor of 2
    assert torch.equal(T.wpt(odd, wt, np.zeros(0, dtype=bool)), odd)


def test_the_same_errors_as_the_jax_package():
    ref, wt = _carriers("cdf97", "lifting")
    x = np.zeros(64)
    tree = J.maketree(64, 3, "full")
    bad = tree.copy()
    bad[0] = False                                 # active child, idle root
    for wpt, carrier, kw in ((J.wpt, ref, {}), (T.wpt, wt, {"device": "cpu"}),
                             (J.iwpt, ref, {}),
                             (T.iwpt, wt, {"device": "cpu"})):
        with pytest.raises(ValueError):
            wpt(x, carrier, 3, L=4, **kw)            # conflicting L
        with pytest.raises(ValueError):
            wpt(x, carrier, tree, L=3, **kw)         # a tree and an L
        with pytest.raises(ValueError):
            wpt(x, carrier, bad, **kw)               # invalid tree
        with pytest.raises(ValueError):
            wpt(x, carrier, 7, **kw)                 # L beyond the length
