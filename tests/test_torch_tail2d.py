"""The multi-level tail (ops/tail2d.py) against the JAX package.

The plain versions are held against the TPU tail kernels
(``tail2d.tail_fw`` / ``tail_inv``, in interpret mode) in float32 and
against the JAX float64 engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops import filter_fb as JF, lifting as JL
from wavelets_tpu.ops.pallas import tail2d as JT

from wavelets_tpu_torch.ops import tail2d
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


@pytest.mark.parametrize("size, L", [(128, 1), (256, 2)])
def test_plain_matches_tail_kernels_f32(size, L):
    ref, wt = _carriers("cdf97", "lifting")
    x = np.random.default_rng(90 + L).standard_normal((size, size)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JT.tail_fw(jnp.asarray(x), ref, L))
        want_inv = np.asarray(JT.tail_inv(jnp.asarray(want), ref, L))
    xt = torch.from_numpy(x)[None]
    got = tail2d.tail_fw_plain(xt, wt, L)
    assert np.abs(got[0].numpy() - want).max() < 2e-4
    got_inv = tail2d.tail_inv_plain(torch.from_numpy(want.copy())[None], wt,
                                     L)
    assert np.abs(got_inv[0].numpy() - want_inv).max() < 2e-4
    assert np.abs(got_inv[0].numpy() - x).max() < 2e-4


def _jax_pyramid(x64, ref, L, fw=True):
    if isinstance(ref, J.GLS):
        fn = JL.dwt_nd_lifting if fw else JL.idwt_nd_lifting
        return np.asarray(fn(jnp.asarray(x64), ref, L, 2))
    h, g = JF.filter_pair(ref)
    fn = JF.dwt_nd if fw else JF.idwt_nd
    return np.asarray(fn(jnp.asarray(x64), h, g, L, 2))


@pytest.mark.parametrize("shape, L", [((2, 2), 1), ((4, 8), 2), ((8, 8), 3),
                                      ((64, 128), 6), ((96, 32), 5)])
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("db4", "filter")])
def test_plain_matches_engines_f64(name, kind, shape, L):
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(11).standard_normal(shape)
    want = _jax_pyramid(x, ref, L)
    got = tail2d.tail_fw_plain(torch.from_numpy(x)[None], wt, L)[0].numpy()
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    back = tail2d.tail_inv_plain(torch.from_numpy(want.copy())[None], wt, L)
    assert np.abs(back[0].numpy() - x).max() <= 1e-12


def test_tail_writes_every_element_of_its_region():
    ref, wt = _carriers("cdf97", "lifting")
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 32, 64)))
    out = torch.full((2, 64, 64), float("nan"), dtype=torch.float64)
    tail2d.tail_fw(x, wt, 3, out=out[:, :32, :64])
    assert not torch.isnan(out[:, :32]).any()
    assert torch.isnan(out[:, 32:]).all()


def test_tail_input_and_output_may_alias():
    _, wt = _carriers("db4", "filter")
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 16, 16)))
    want = tail2d.tail_fw(x, wt, 2)
    inplace = x.clone()
    tail2d.tail_fw(inplace, wt, 2, out=inplace)
    assert torch.equal(inplace, want)
    tail2d.tail_inv(inplace, wt, 2, out=inplace)
    assert (inplace - x).abs().max() <= 1e-12
