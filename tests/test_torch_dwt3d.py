"""The 3-D DWT of the port (ops/dwt3d.py: kernel A per slab, then kernel I
along axis 0; J then B for the inverse) against the JAX package.

The public ``dwt``/``idwt`` with ``ndt=3`` run their levels through the
kernels' plain versions on a CPU tensor and are held in float64 against
``wavelets_tpu.dwt`` within 1e-12 x max(1, max|ref|); the plain route is
held in float32 against the TPU driver ``dwt3d.dwt3_pallas`` in interpret
mode, as tests/test_pallas.py runs it, within 2e-4 (that driver's own
round trip, 3 axes x 2 levels of three-pass bf16 dots).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import dwt3d as JD3

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import axis0, dwt3d, level2d
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
    ("cdf97", "lifting", (16, 16, 16), None, None),
    ("cdf97", "lifting", (8, 16, 32), 3, None),
    ("cdf97", "lifting", (32, 8, 16), 2, 3),
    ("haar", "lifting", (4, 8, 16), None, None),
    ("db2", "filter", (16, 16, 16), 4, None),
    ("db4", "filter", (8, 8, 8), None, None),
    ("db4", "filter", (16, 32, 8), 3, None),
    ("sym6", "filter", (8, 16, 16), 2, None),
    ("haar", "filter", (2, 2, 2), 1, None),
    ("db2", "lifting", (2, 2, 4), None, None),
    # leading axes batch: each volume runs through the driver
    ("cdf97", "lifting", (2, 8, 8, 16), 3, 3),
    ("db4", "filter", (3, 8, 16, 8), None, 3),
]


@pytest.mark.parametrize("name, kind, shape, L, ndt", CASES)
def test_dwt_idwt_match_the_jax_package(name, kind, shape, L, ndt):
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(61).standard_normal(shape)
    want = J.dwt(x, ref, L, ndt=ndt)
    got = T.dwt(torch.from_numpy(x), wt, L, ndt=ndt)
    _close(got, want)
    back = T.idwt(got, wt, L, ndt=ndt)
    _close(back, J.idwt(want, ref, L, ndt=ndt))
    # sym tables are orthogonal only to their printed precision
    # (tests/test_transforms.py, _RT_TOL)
    _close(back, x, 5e-9 if name == "sym6" else 1e-12)


@pytest.mark.parametrize("name, kind", [("db2", "filter"),
                                        ("cdf97", "lifting")])
def test_plain_route_matches_dwt3_pallas_f32(name, kind):
    """The TPU driver's kernels (#1-#4 per slab, #22-#25 along axis 0) at
    the JAX tests' own (32, 32, 256) L2."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(62).standard_normal((32, 32, 256)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JD3.dwt3_pallas(jnp.asarray(x), ref, 2))
        want_inv = np.asarray(JD3.idwt3_pallas(jnp.asarray(want), ref, 2))
    got = dwt3d.dwt3(torch.from_numpy(x), wt, 2)
    assert np.abs(got.numpy() - want).max() < 2e-4
    back = dwt3d.idwt3(torch.from_numpy(want.copy()), wt, 2)
    assert np.abs(back.numpy() - want_inv).max() < 2e-4
    assert np.abs(back.numpy() - x).max() < 2e-4


def _counts():
    return ({**level2d.LAUNCHES, **axis0.LAUNCHES},
            {**level2d.PLAIN_CALLS, **axis0.PLAIN_CALLS})


@pytest.mark.parametrize("L", [1, 3])
def test_route_is_two_launches_per_level(L):
    """Per level A then I forward, J then B inverse; on a CPU tensor each
    takes its plain version and no kernel is launched."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.zeros((8, 16, 8))
    launches, before = _counts()
    y = T.dwt(x, wt, L)
    mid = _counts()[1]
    T.idwt(y, wt, L)
    after_launches, after = _counts()
    assert after_launches == launches
    assert {k: mid[k] - before[k] for k in before} == {
        "level_fw": L, "level_inv": 0, "axis0_fw": L, "axis0_inv": 0,
        "axis0_fw_halo": 0, "axis0_inv_halo": 0}
    assert {k: after[k] - mid[k] for k in before} == {
        "level_fw": 0, "level_inv": L, "axis0_fw": 0, "axis0_inv": L,
        "axis0_fw_halo": 0, "axis0_inv_halo": 0}


def test_inputs_are_not_written():
    """Level 1 reads x and never writes it; the inverse reads y in place."""
    wt = T.wavelet(T.wt.db4, "filter")
    x = torch.from_numpy(np.random.default_rng(63).standard_normal(
        (8, 8, 16)))
    x0 = x.clone()
    y = dwt3d.dwt3(x, wt, 3)
    y0 = y.clone()
    dwt3d.idwt3(y, wt, 3)
    assert torch.equal(x, x0) and torch.equal(y, y0)


def test_plain_flag_runs_the_plain_versions():
    wt = T.wavelet(T.wt.haar, "lifting")
    x = torch.from_numpy(np.random.default_rng(64).standard_normal(
        (4, 4, 8)))
    assert torch.equal(dwt3d.dwt3(x, wt, 2, plain=True),
                       dwt3d.dwt3(x, wt, 2))
    assert torch.equal(dwt3d.dwt3(x, wt, 0), x)
    assert torch.equal(dwt3d.idwt3(x, wt, 0), x)


@pytest.mark.parametrize("boundary", ["zeropad", "symmetric"])
def test_non_periodic_boundaries_take_the_lifting_engine(boundary):
    ref, wt = _carriers("cdf97", "lifting", boundary)
    x = np.random.default_rng(65).standard_normal((8, 8, 8))
    calls = dict(axis0.PLAIN_CALLS)
    got = T.dwt(torch.from_numpy(x), wt, 2)
    assert axis0.PLAIN_CALLS == calls
    _close(got, J.dwt(x, ref, 2))
    _close(T.idwt(got, wt, 2), x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_dtypes_track_float64(dtype):
    """bf16 rounds twice per level (after A and after I)."""
    ref, wt = _carriers("cdf97", "lifting")
    x = np.random.default_rng(66).standard_normal((16, 16, 32))
    want = np.asarray(J.dwt(x, ref, 3))
    got = T.dwt(torch.from_numpy(x).to(dtype), wt, 3)
    assert got.dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(
        want).max()
    back = T.idwt(got, wt, 3)
    assert np.abs(back.double().numpy() - x).max() <= 10 * tol * np.abs(
        x).max()
