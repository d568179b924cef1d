"""The multi-level tail (ops/tail2d.py) against the JAX package.

The plain versions are held against the TPU tail kernels
(``tail2d.tail_fw`` / ``tail_inv``, in interpret mode) in float32 and
against the JAX float64 engines.  The launch plan of the CUDA kernels
(``tail_plan``: cluster size, rows per block, shared bytes) is checked
here on the CPU for every shape of chip_smoke.py.
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


# chip_smoke.py's SHAPES: the plan of every shape that the tail takes
_SHAPES = ((2, 2), (4, 8), (16, 16), (96, 160), (64, 128), (128, 128),
           (2048, 2048))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("B", [1, 3, 264])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("shape", _SHAPES)
def test_tail_plan(shape, dtype, B, inverse):
    _, wt = _carriers("cdf97", "lifting")
    m, n = shape
    if not tail2d.tail_fits(m, n, wt, dtype, inverse):
        # the level kernels take it: no block holds the array twice
        size = 8 if dtype == torch.float64 else 4
        assert 2 * m * n * size > 200_000
        return
    L = int(np.log2(min(m & -m, n & -n)))
    plan = tail2d.tail_plan(B, m, n, L, wt, dtype, inverse)
    P = plan.cluster
    assert P & (P - 1) == 0 and 1 <= P <= (
        tail2d.WIDE_CLUSTER if B <= tail2d.WIDE_BATCH else tail2d.MAX_CLUSTER)
    assert B * P <= tail2d.SMS or P == 1
    if B >= tail2d.SMS:
        assert P == 1
    assert plan.smem <= 232448
    assert plan.taps == 16
    assert 1 <= plan.split <= L and len(plan.rows) == L
    for l, (rows, blocks) in enumerate(plan.rows, 1):
        assert blocks == (P if l <= plan.split else 1)
        owned = sorted(r for p in range(blocks)
                       for r in range(p * rows, (p + 1) * rows))
        assert owned == list(range(m >> l))      # each row exactly once
        if blocks > 1:
            assert rows >= tail2d.MIN_ROWS


@pytest.mark.parametrize("name, kind, taps", [("haar", "lifting", 16),
                                              ("cdf97", "lifting", 16),
                                              ("db4", "filter", 16),
                                              ("coif4", "filter", 32),
                                              ("db10", "filter", 0)])
def test_tail_plan_tap_templates(name, kind, taps):
    """Tables up to 16 and 32 taps take the unrolled templates; a longer one
    the one-block kernel with wrapped taps (one block, no cluster)."""
    _, wt = _carriers(name, kind)
    for inverse in (False, True):
        plan = tail2d.tail_plan(1, 128, 128, 7, wt, torch.float32, inverse)
        assert plan.taps == taps
        assert plan.cluster == (16 if taps else 1)
        assert plan.smem <= 232448
