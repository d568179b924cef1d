"""The MODWT of the port (ops/modwt.py, ops/modwt1d.py: kernels K and M)
against the JAX package.

The public ``modwt``/``imodwt`` run their levels through the kernels'
plain versions on a CPU tensor and are held in float64 against
``wavelets_tpu.modwt`` / ``imodwt`` within 1e-12 x max(1, max|ref|); the
plain route is held in float32 against the TPU kernels
(``modwt1d.modwt_pallas`` / ``imodwt_pallas``, #36 / #37) in interpret
mode, as tests/test_pallas.py runs them, within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import modwt1d as JM

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import modwt as modwt_ops, modwt1d
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


def _carriers(name, kind="filter"):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind)
    return ref, from_reference(ref)


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name, shape", [
    ("db4", (512,)), ("db4", (1000,)), ("db4", (64,)), ("db4", (3, 1000)),
    ("db4", (2, 3, 64)), ("haar", (512,)), ("haar", (3, 1000)),
    ("sym6", (64,)), ("sym6", (2, 3, 64))])
def test_modwt_imodwt_match_the_jax_package(name, shape):
    """Every level the length allows (maxmodwttransformlevels): at N = 1000
    level 9's reach 7 * 256 wraps the row more than once."""
    ref, wt = _carriers(name)
    x = np.random.default_rng(71).standard_normal(shape)
    want = J.modwt(x, ref)
    got = T.modwt(torch.from_numpy(x), wt)
    assert got.shape == shape + (T.maxmodwttransformlevels(shape[-1]) + 1,)
    _close(got, want)
    back = T.imodwt(got, wt)
    _close(back, J.imodwt(want, ref))
    _close(back, x, 5e-9 if name == "sym6" else 1e-12)


@pytest.mark.parametrize("L", [1, 3, 6])
def test_explicit_levels_match(L):
    ref, wt = _carriers("db2")
    x = np.random.default_rng(72).standard_normal((2, 96))
    want = J.modwt(x, ref, L)
    got = T.modwt(x, wt, L, device="cpu")
    _close(got, want)
    _close(T.imodwt(got, wt), J.imodwt(want, ref))


def test_plain_matches_modwt_kernels_f32():
    """#36 / #37 at the JAX tests' own (16, 512) db4 L6."""
    ref, wt = _carriers("db4")
    x = np.random.default_rng(73).standard_normal((16, 512)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JM.modwt_pallas(jnp.asarray(x), ref, 6))
        want_inv = np.asarray(JM.imodwt_pallas(jnp.asarray(want), ref))
    got = modwt1d.modwt(torch.from_numpy(x), wt, 6)
    assert np.abs(got.numpy() - want).max() < 1e-4
    back = modwt1d.imodwt(torch.from_numpy(want.copy()), wt)
    assert np.abs(back.numpy() - want_inv).max() < 1e-4
    assert np.abs(back.numpy() - x).max() < 1e-4


def test_the_same_refusals_as_the_jax_package():
    ref, wt = _carriers("db4")
    x = np.zeros(16)
    for L in (0, -1, 5):                  # L < 1, and 2^5 > 16
        with pytest.raises(ValueError):
            J.modwt(x, ref, L)
        with pytest.raises(ValueError):
            T.modwt(x, wt, L, device="cpu")
    # a lifting scheme has no MODWT filters: refused on both sides
    gls_ref, gls = _carriers("cdf97", "lifting")
    with pytest.raises(AttributeError):
        J.modwt(x, gls_ref, 2)
    with pytest.raises(TypeError, match="OrthoFilter"):
        T.modwt(x, gls, 2, device="cpu")
    with pytest.raises(AttributeError):
        J.imodwt(np.zeros((16, 3)), gls_ref)
    with pytest.raises(TypeError, match="OrthoFilter"):
        T.imodwt(np.zeros((16, 3)), gls, device="cpu")


def test_level_zero_inverse_is_the_scaling_column():
    ref, wt = _carriers("haar")
    xw = np.random.default_rng(74).standard_normal((3, 8, 1))
    _close(T.imodwt(xw, wt, device="cpu"), J.imodwt(xw, ref))


def test_route_is_one_launch_per_level():
    """One K per level forward, one M per level inverse; on a CPU tensor
    each takes its plain version and no kernel is launched."""
    _, wt = _carriers("db4")
    x = torch.zeros((4, 64))
    launches = dict(modwt1d.LAUNCHES)
    before = dict(modwt1d.PLAIN_CALLS)
    T.imodwt(T.modwt(x, wt, 5), wt)
    assert modwt1d.LAUNCHES == launches
    assert modwt1d.PLAIN_CALLS == {k: v + 5 for k, v in before.items()}


def test_columns_are_written_in_place():
    """K writes v1 and w1 into strided columns of one array; M reads them
    back from there: the same numbers as contiguous planes."""
    _, wt = _carriers("db4")
    v = torch.from_numpy(np.random.default_rng(75).standard_normal((3, 40)))
    v1, w1 = modwt1d.modwt_fw(v, wt, 3)
    cols = torch.full((3, 40, 4), float("nan"), dtype=torch.float64)
    modwt1d.modwt_fw(v, wt, 3, cols[..., 3], cols[..., 1])
    assert torch.equal(cols[..., 3], v1) and torch.equal(cols[..., 1], w1)
    assert torch.isnan(cols[..., 0]).all() and torch.isnan(cols[..., 2]).all()
    assert torch.equal(modwt1d.modwt_inv(cols[..., 3], cols[..., 1], wt, 3),
                       modwt1d.modwt_inv(v1, w1, wt, 3))


def test_plain_version_is_the_engine_step():
    """K's plain version is ops/modwt.modwt_step, in the arithmetic type."""
    _, wt = _carriers("db2")
    v = torch.from_numpy(np.random.default_rng(76).standard_normal((2, 24)))
    g, h = modwt_ops.modwt_filter_pair(wt)
    sv, sw = modwt_ops.modwt_step(v, 4, h, g)     # reach 3 * 8 = 24 = N
    v1, w1 = modwt1d.modwt_fw(v, wt, 4)
    assert torch.equal(v1, sv) and torch.equal(w1, sw)
    vb = v.to(torch.bfloat16)
    b1, c1 = modwt1d.modwt_fw(vb, wt, 4)
    f1, e1 = modwt1d.modwt_fw(vb.float(), wt, 4)
    assert torch.equal(b1, f1.to(torch.bfloat16))
    assert torch.equal(c1, e1.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_dtypes_track_float64(dtype):
    ref, wt = _carriers("db4")
    x = np.random.default_rng(77).standard_normal((4, 256))
    want = np.asarray(J.modwt(x, ref, 5))
    got = T.modwt(torch.from_numpy(x).to(dtype), wt, 5)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(
        want).max()
    back = T.imodwt(got, wt)
    assert np.abs(back.double().numpy() - x).max() <= 10 * tol * np.abs(
        x).max()
