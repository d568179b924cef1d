"""The 1-D multi-level tail (ops/tail1d.py) against the JAX package.

The plain versions are held in float32 against the TPU pyramid kernels
(``pyramid1d.dwt1d_pyramid_b`` / ``idwt1d_pyramid_b`` for batched rows,
``dwt1d_pyramid`` / ``idwt1d_pyramid`` for one signal, in interpret mode
as tests/test_pyramid1d.py runs them; tolerance 2e-4 for the TPU's
three-pass f32 dots) and in float64 against ``wavelets_tpu.dwt`` at
1e-12 x max(1, max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import pyramid1d as JP

from wavelets_tpu_torch.ops import tail1d
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


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db2", "filter")])
def test_plain_matches_batched_pyramid_kernels_f32(name, kind):
    """#30 / #31 on (2, 2^14) rows, four levels."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(41).standard_normal((2, 1 << 14)).astype(
        np.float32)
    assert JP.plan_stages(x.shape[1], ref, 4, np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.dwt1d_pyramid_b(jnp.asarray(x), ref, 4))
        want_inv = np.asarray(JP.idwt1d_pyramid_b(jnp.asarray(want), ref, 4))
    got = tail1d.tail1d_fw_plain(torch.from_numpy(x), wt, 4).numpy()
    assert np.abs(got - want).max() < 2e-4
    got_inv = tail1d.tail1d_inv_plain(torch.from_numpy(want.copy()), wt, 4)
    assert np.abs(got_inv.numpy() - want_inv).max() < 2e-4
    assert np.abs(got_inv.numpy() - x).max() < 2e-4


def test_plain_matches_single_signal_pyramid_f32():
    """#30 / #31 on one 2^15 signal, five levels (stages, then the
    per-level tail of the JAX route)."""
    ref, wt = _carriers("db4", "filter")
    x = np.random.default_rng(42).standard_normal(1 << 15).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.dwt1d_pyramid(jnp.asarray(x), ref, 5))
        want_inv = np.asarray(JP.idwt1d_pyramid(jnp.asarray(want), ref, 5))
    got = tail1d.tail1d_fw_plain(torch.from_numpy(x)[None], wt, 5)[0]
    assert np.abs(got.numpy() - want).max() < 2e-4
    got_inv = tail1d.tail1d_inv_plain(torch.from_numpy(want.copy())[None],
                                      wt, 5)[0]
    assert np.abs(got_inv.numpy() - want_inv).max() < 2e-4


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("db4", "filter"),
                                        ("sym6", "filter")])
def test_plain_matches_dwt_f64_all_levels(name, kind):
    """Every level of (3, 2^10) rows, down to one sample."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(43).standard_normal((3, 1 << 10))
    want = np.asarray(J.dwt(x, ref, 10, ndt=1))
    got = tail1d.tail1d_fw_plain(torch.from_numpy(x), wt, 10).numpy()
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    back = tail1d.tail1d_inv_plain(torch.from_numpy(want.copy()), wt, 10)
    want_back = np.asarray(J.idwt(want, ref, 10, ndt=1))
    assert np.abs(back.numpy() - want_back).max() <= 1e-12 * max(
        1.0, np.abs(want_back).max())


@pytest.mark.parametrize("n, dtype, fits", [
    (1 << 14, torch.float32, True), (1 << 15, torch.float32, False),
    (1 << 14, torch.bfloat16, True), (1 << 15, torch.bfloat16, False),
    (1 << 13, torch.float64, True), (1 << 14, torch.float64, False),
    (2, torch.float64, True)])
def test_tail1d_fits_follows_shared_memory(n, dtype, fits):
    from wavelets_tpu_torch import wavelet, wt as W
    for wt in (wavelet(W.cdf97, "lifting"), wavelet(W.db4, "filter")):
        assert tail1d.tail1d_fits(n, wt, dtype) == fits
        assert tail1d.tail1d_fits(n, wt, dtype, inverse=True) == fits


def test_tail_writes_every_element_of_its_region():
    _, wt = _carriers("cdf97", "lifting")
    x = torch.from_numpy(np.random.default_rng(44).standard_normal((2, 64)))
    out = torch.full((2, 128), float("nan"), dtype=torch.float64)
    tail1d.tail1d_fw(x, wt, 4, out=out[:, :64])
    assert not torch.isnan(out[:, :64]).any()
    assert torch.isnan(out[:, 64:]).all()


def test_tail_input_and_output_may_alias():
    _, wt = _carriers("db4", "filter")
    x = torch.from_numpy(np.random.default_rng(45).standard_normal((2, 64)))
    want = tail1d.tail1d_fw(x, wt, 3)
    inplace = x.clone()
    tail1d.tail1d_fw(inplace, wt, 3, out=inplace)
    assert torch.equal(inplace, want)
    tail1d.tail1d_inv(inplace, wt, 3, out=inplace)
    assert (inplace - x).abs().max() <= 1e-12


def test_bf16_tail_rounds_once():
    """The intermediate scaling band stays in float32: the bfloat16 result
    is the float32 tail rounded once."""
    _, wt = _carriers("cdf97", "lifting")
    x = torch.from_numpy(np.random.default_rng(46).standard_normal(
        (2, 256))).to(torch.bfloat16)
    got = tail1d.tail1d_fw(x, wt, 6)
    assert torch.equal(got, tail1d.tail1d_fw(x.float(), wt, 6).to(
        torch.bfloat16))
