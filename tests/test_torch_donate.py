"""``donate=`` of the port's dwt/idwt/wpt/iwpt/modwt/imodwt.

The counterpart of ``tests/test_more_coverage.py``'s
``test_donate_variants_match``: ``donate=True`` (the reference's in-place
surface) gives bit for bit the result of ``donate=False``, leaves the input
as it was (the port reuses no buffer), and agrees with the JAX package's
``donate=True`` result within the dtype's class (1e-12 in float64, 1e-5 in
float32, relative to the largest coefficient).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
import wavelets_tpu_torch as T
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


TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _calls(pkg, name, wt):
    """(forward, its inverse) of entry point ``name`` with ``donate``."""
    tree = pkg.maketree(256, 3, "full")
    return {
        "dwt": (lambda v, d: pkg.dwt(v, wt, 3, donate=d),
                lambda v, d: pkg.idwt(v, wt, 3, donate=d)),
        "wpt": (lambda v, d: pkg.wpt(v, wt, tree, donate=d),
                lambda v, d: pkg.iwpt(v, wt, tree, donate=d)),
        "modwt": (lambda v, d: pkg.modwt(v, wt, 4, donate=d),
                  lambda v, d: pkg.imodwt(v, wt, donate=d)),
    }[name]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("name", ["dwt", "wpt", "modwt"])
@pytest.mark.parametrize("shape, dtype", [((256,), np.float64),
                                          ((8, 256), np.float32)])
def test_donate_matches(name, inverse, shape, dtype):
    ref = J.wt.wavelet(J.wt.db2)
    wt = from_reference(ref)
    x = np.random.default_rng(55).standard_normal(shape).astype(dtype)
    fw_t, inv_t = _calls(T, name, wt)
    fw_j, inv_j = _calls(J, name, ref)
    if inverse:
        x = np.asarray(fw_j(jnp.asarray(x), False))
        fn_t, fn_j = inv_t, inv_j
    else:
        fn_t, fn_j = fw_t, fw_j
    xt = torch.from_numpy(x.copy())
    kept = xt.clone()
    want = fn_t(xt, False)
    got = fn_t(xt, True)
    assert torch.equal(got, want)
    assert torch.equal(xt, kept)
    jax_out = np.asarray(fn_j(jnp.asarray(x), True))
    assert got.shape == jax_out.shape
    scale = max(1.0, np.abs(jax_out).max())
    assert np.abs(got.numpy() - jax_out).max() <= TOL[dtype] * scale


def test_donate_is_keyword_only():
    wt = from_reference(J.wt.wavelet(J.wt.db2))
    x = torch.zeros(16, dtype=torch.float64)
    with pytest.raises(TypeError):
        T.dwt(x, wt, 2, None, True)
