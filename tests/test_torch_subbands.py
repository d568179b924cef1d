"""Complex input, ``dwtc``/``idwtc`` and the subband API of the port
against the JAX package.

Complex input runs as two real transforms on the port's side and natively
on the JAX package's (XLA's complex formulation on the CPU); the two agree
within 1e-12 x max(1, max|ref|) for complex128 and within 1e-5 x max|ref|
for complex64 (float32 sums in another order).
"""

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


def _carriers(name, kind):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind)
    return ref, from_reference(ref)


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _complex(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


TOL = {np.complex128: 1e-12, np.complex64: 1e-5}


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("name, kind, shape, L, ndt", [
    ("cdf97", "lifting", (64, 64), 4, None),
    ("db4", "filter", (2, 32, 64), 3, 2),
    ("db4", "filter", (1024,), None, None),
    ("cdf97", "lifting", (3, 256), 5, 1),
    ("haar", "lifting", (8, 8, 16), 2, None),
])
def test_complex_dwt_idwt_match_the_jax_package(name, kind, shape, L, ndt,
                                                dtype):
    ref, wt = _carriers(name, kind)
    x = _complex(shape, dtype, 81)
    want = J.dwt(x, ref, L, ndt=ndt)
    got = T.dwt(torch.from_numpy(x), wt, L, ndt=ndt)
    assert got.dtype == torch.from_numpy(x).dtype
    _close(got, want, TOL[dtype])
    back = T.idwt(got, wt, L, ndt=ndt)
    _close(back, J.idwt(want, ref, L, ndt=ndt), TOL[dtype])
    _close(back, x, 10 * TOL[dtype])


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_wpt_matches_the_jax_package(dtype):
    ref, wt = _carriers("db4", "filter")
    x = _complex(256, dtype, 82)
    want = J.wpt(x, ref, 4)
    got = T.wpt(torch.from_numpy(x), wt, 4)
    _close(got, want, TOL[dtype])
    _close(T.iwpt(got, wt, 4), x, 10 * TOL[dtype])


def test_complex_modwt_matches_the_jax_package():
    ref, wt = _carriers("db2", "filter")
    x = _complex((2, 100), np.complex128, 83)
    want = J.modwt(x, ref, 4)
    got = T.modwt(torch.from_numpy(x), wt, 4)
    _close(got, want)
    _close(T.imodwt(got, wt), x)


def test_complex_parts_are_two_real_transforms():
    """Exactly: the real coefficients never mix the two parts."""
    _, wt = _carriers("cdf97", "lifting")
    z = torch.from_numpy(_complex((16, 16), np.complex128, 84))
    y = T.dwt(z, wt, 3)
    assert torch.equal(y.real, T.dwt(z.real.contiguous(), wt, 3))
    assert torch.equal(y.imag, T.dwt(z.imag.contiguous(), wt, 3))


@pytest.mark.parametrize("name, kind, L", [("cdf97", "lifting", None),
                                           ("db4", "filter", 2)])
def test_dwtc_idwtc_match_the_jax_package(name, kind, L):
    """Per-channel 2-D of (m, n, c): the channels ride the batch axis."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(85).standard_normal((32, 16, 3))
    want = J.dwtc(x, ref, L)
    got = T.dwtc(torch.from_numpy(x), wt, L)
    _close(got, want)
    for c in range(3):
        _close(got[..., c], T.dwt(torch.from_numpy(x[..., c].copy()), wt, L))
    back = T.idwtc(got, wt, L)
    _close(back, J.idwtc(want, ref, L))
    _close(back, x)


@pytest.mark.parametrize("shape, L, ndt", [((64, 32), 3, None),
                                           ((2, 32, 32), None, 2),
                                           ((512,), 4, None),
                                           ((3, 256), None, 1)])
def test_subbands_match_the_jax_package(shape, L, ndt):
    ref, wt = _carriers("db4", "filter")
    x = np.random.default_rng(86).standard_normal(shape)
    want = J.dwt_subbands(x, ref, L, ndt=ndt)
    got = T.dwt_subbands(torch.from_numpy(x), wt, L, ndt=ndt)
    assert got.keys() == want.keys()
    if "s" in got:
        _close(got["s"], want["s"])
        assert len(got["d"]) == len(want["d"])
        for g, w in zip(got["d"], want["d"]):
            _close(g, w)
    else:
        _close(got["ll"], want["ll"])
        assert len(got["levels"]) == len(want["levels"])
        for gl, wl in zip(got["levels"], want["levels"]):
            for g, w in zip(gl, wl):
                _close(g, w)
    _close(T.idwt_subbands(got, wt), x)
    _close(T.to_packed(got), J.to_packed(want))


def test_from_packed_gives_views_and_to_packed_inverts_it():
    y = torch.arange(64.0).reshape(8, 8)
    bands = T.from_packed(y, 2)
    assert bands["ll"].data_ptr() == y.data_ptr()
    assert bands["ll"].shape == (2, 2) and len(bands["levels"]) == 2
    assert torch.equal(T.to_packed(bands), y)
    r = torch.arange(16.0)
    b1 = T.from_packed(r, 3, ndt=1)
    assert [d.shape[-1] for d in b1["d"]] == [8, 4, 2]
    assert torch.equal(T.to_packed(b1), r)
    assert torch.equal(T.to_packed(T.from_packed(r.numpy(), 3,
                                                 device="cpu")), r)


def test_from_packed_refuses_3d_as_the_jax_package_does():
    with pytest.raises(ValueError):
        J.from_packed(np.zeros((4, 4, 4)), 1, ndt=3)
    with pytest.raises(ValueError):
        T.from_packed(torch.zeros((4, 4, 4)), 1, ndt=3)


def test_split_and_merge_last_are_exported():
    x = torch.arange(12.0).reshape(2, 6)
    s, d = T.split_last(x)
    js, jd = J.split_last(x.numpy())
    _close(s, js)
    _close(d, jd)
    assert torch.equal(T.merge_last(s, d), x)
