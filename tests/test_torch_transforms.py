"""Public ``dwt`` / ``idwt`` of the port against ``wavelets_tpu``'s.

The same numpy input, from a seed, goes through both packages in float64
on the CPU; the port's periodic 2-D and 1-D routes run their multi-level
loops (ops/pyramid2d.py, ops/dwt1d.py) with the kernels' plain versions,
every other route its torch engines.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import level1d, level2d, tail1d, tail2d
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


CASES = [
    # name, kind, shape, L, ndt
    ("cdf97", "lifting", (256, 256), None, None),
    ("cdf97", "lifting", (256, 256), 3, None),
    ("db4", "filter", (256, 256), 5, None),
    ("haar", "lifting", (128, 128), None, None),
    ("haar", "filter", (64, 64), 4, None),
    ("cdf97", "lifting", (64, 128), 4, None),
    ("db2", "lifting", (2, 64, 64), 3, 2),
    ("sym6", "filter", (2, 32, 64), 2, 2),
    ("cdf97", "lifting", (2, 2), 1, None),
    ("db4", "filter", (4, 8), 2, None),
    # the 1-D multi-level loop (ops/dwt1d.py)
    ("db4", "filter", (1024,), 5, None),
    ("cdf97", "lifting", (3, 256), 4, 1),
    ("cdf97", "lifting", (4096,), None, None),
    ("cdf97", "lifting", (4096,), 3, None),
    ("db4", "filter", (4096,), None, None),
    ("haar", "lifting", (4096,), 3, None),
    ("sym6", "filter", (4096,), None, None),
    ("cdf97", "lifting", (3, 1024), None, 1),
    ("db4", "filter", (3, 1024), 6, 1),
    ("haar", "filter", (3, 1024), None, 1),
    ("sym6", "filter", (3, 1024), 4, 1),
    ("cdf97", "lifting", (2, 3, 256), 5, 1),
    ("db4", "filter", (2, 3, 256), None, 1),
    ("cdf97", "lifting", (384,), None, None),     # 3 * 2^7
    ("db4", "filter", (3, 384), 7, 1),
    ("haar", "lifting", (2,), None, None),
    # the 3-D driver (ops/dwt3d.py)
    ("cdf97", "lifting", (16, 16, 16), 2, None),
    ("db2", "filter", (8, 16, 16), 3, 3),
]


@pytest.mark.parametrize("name, kind, shape, L, ndt", CASES)
def test_dwt_idwt_match_the_jax_package(name, kind, shape, L, ndt):
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(21).standard_normal(shape)
    want = J.dwt(x, ref, L, ndt=ndt)
    got = T.dwt(torch.from_numpy(x), wt, L, ndt=ndt)
    _close(got, want)
    _close(T.idwt(got, wt, L, ndt=ndt), J.idwt(want, ref, L, ndt=ndt))
    # sym tables are orthogonal only to their printed precision
    # (tests/test_transforms.py, _RT_TOL)
    _close(T.idwt(got, wt, L, ndt=ndt), x, 5e-9 if name == "sym6" else 1e-12)


@pytest.mark.parametrize("boundary", ["zeropad", "symmetric"])
def test_non_periodic_boundaries_take_the_lifting_engine(boundary):
    ref, wt = _carriers("cdf97", "lifting", boundary)
    x = np.random.default_rng(22).standard_normal((64, 64))
    calls = dict(level2d.PLAIN_CALLS)
    got = T.dwt(torch.from_numpy(x), wt, 3)
    assert level2d.PLAIN_CALLS == calls
    _close(got, J.dwt(x, ref, 3))
    _close(T.idwt(got, wt, 3), x)


def test_periodic_2d_takes_the_pyramid():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    before = (level2d.PLAIN_CALLS["level_fw"], tail2d.PLAIN_CALLS["tail_fw"])
    T.dwt(torch.zeros((256, 256)), wt, 8)
    after = (level2d.PLAIN_CALLS["level_fw"], tail2d.PLAIN_CALLS["tail_fw"])
    assert after == (before[0] + 1, before[1] + 1)   # 256^2 level, then tail


def test_periodic_1d_takes_the_level_and_tail_kernels():
    """A 2^15 row: one level launch (it does not fit the tail), then one
    tail launch for the other 14 levels, each through its plain version
    on a CPU tensor."""
    wt = T.wavelet(T.wt.cdf97, "lifting")

    def counts():
        return ({**level1d.LAUNCHES, **tail1d.LAUNCHES},
                {**level1d.PLAIN_CALLS, **tail1d.PLAIN_CALLS})

    launches, before = counts()
    T.idwt(T.dwt(torch.zeros(1 << 15), wt), wt)
    assert counts() == (launches, {k: v + 1 for k, v in before.items()})


def test_1d_float32_tracks_the_jax_package_float32():
    ref, wt = _carriers("db4", "filter")
    x = np.random.default_rng(24).standard_normal((3, 4096)).astype(
        np.float32)
    want = np.asarray(J.dwt(x, ref, 8, ndt=1))
    assert want.dtype == np.float32
    got = T.dwt(torch.from_numpy(x), wt, 8, ndt=1)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def test_non_tensor_input_goes_to_the_card():
    """A numpy array with no device asks for the card, and there is none
    here: refused, not run quietly on the CPU."""
    assert not torch.cuda.is_available()
    wt = T.wavelet(T.wt.haar, "lifting")
    x = np.random.default_rng(25).standard_normal((4, 8))
    for fn in (T.dwt, T.idwt):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(x, wt, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            fn([1.0, 2.0], wt, 1)
    for fn in (T.wpt, T.iwpt):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(x[0], wt, 2)
    got = T.dwt(x, wt, 1, device="cpu")
    assert got.device.type == "cpu"
    _close(got, T.dwt(torch.from_numpy(x), wt, 1))


def test_tensor_input_stays_on_its_device_unless_told():
    wt = T.wavelet(T.wt.haar, "lifting")
    x = torch.ones((4, 8), dtype=torch.float64)
    assert T.dwt(x, wt, 1).device == x.device
    assert T.dwt(x, wt, 1, device="cpu").device.type == "cpu"
    assert T.wpt(x, wt, 2, device=torch.device("cpu")).device.type == "cpu"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_dtypes_track_float64(dtype):
    ref, wt = _carriers("cdf97", "lifting")
    x = np.random.default_rng(23).standard_normal((128, 256))
    want = np.asarray(J.dwt(x, ref, 5))
    got = T.dwt(torch.from_numpy(x).to(dtype), wt, 5)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(
        want).max()
    back = T.idwt(got, wt, 5)
    assert np.abs(back.double().numpy() - x).max() <= 10 * tol * np.abs(
        x).max()


def test_integer_input_promotes_to_float64():
    ref, wt = _carriers("haar", "lifting")
    x = np.arange(64).reshape(8, 8)
    got = T.dwt(x, wt, 2, device="cpu")
    assert got.dtype == torch.float64
    _close(got, J.dwt(x, ref, 2))
    assert T.dwt(torch.ones((4, 4), dtype=torch.bool), wt, 1).dtype == \
        torch.float64


def test_the_same_errors_as_the_jax_package():
    ref, wt = _carriers("cdf97", "lifting")
    for fn in (T.dwt, T.idwt):
        with pytest.raises(ValueError):
            fn(torch.zeros((8, 8)), wt, -1)
        with pytest.raises(ValueError):
            fn(torch.zeros((12, 16)), wt, 3)      # 12 lacks a 2^3 factor
        with pytest.raises(ValueError):
            fn(torch.zeros((8, 8)), wt, ndt=3)
    with pytest.raises(ValueError):
        J.dwt(np.zeros((12, 16)), ref, 3)
    with pytest.raises(ValueError):
        T.wavelet(T.wt.batt2, "lifting")
    with pytest.raises(ValueError):
        J.wt.wavelet(J.wt.batt2, "lifting")
    # a cascade too unstable for f32 is refused on both sides
    vaid_ref, vaid = _carriers("vaid", "lifting")
    with pytest.raises(ValueError):
        J.dwt(np.zeros((16, 16), np.float32), vaid_ref, 2)
    with pytest.raises(ValueError):
        T.dwt(torch.zeros((16, 16)), vaid, 2)
    # complex input is refused where real input is, on both sides
    for fn, carrier, z in ((J.dwt, ref, np.zeros((12, 16), np.complex64)),
                           (T.dwt, wt, torch.zeros((12, 16),
                                                   dtype=torch.complex64))):
        with pytest.raises(ValueError):
            fn(z, carrier, 3)


def test_level_zero_is_the_identity():
    wt = T.wavelet(T.wt.db4, "filter")
    x = torch.randn((8, 8), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    assert torch.equal(T.dwt(x, wt, 0), x)
    assert torch.equal(T.idwt(x, wt, 0), x)
