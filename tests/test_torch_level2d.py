"""The 2-D level (ops/level2d.py) against the JAX package.

The plain versions, which a CPU tensor takes, are held against the TPU
kernels they stand beside (``mxu2d.mxu_level_fw_quads`` and
``mxu_inv_packed``, run in interpret mode as tests/test_mxu2d.py runs
them) in float32, and against the JAX float64 engines.  The CUDA kernels
themselves are held against these plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops import filter_fb as JF, lifting as JL
from wavelets_tpu.ops.pallas import mxu2d

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import level2d
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


def _packed(quads):
    ll, lh, hl, hh = (q.numpy() for q in quads)
    return np.block([[ll, lh], [hl, hh]])


def _jax_level(x64, ref, fw=True):
    """One 2-D level in float64 through the JAX engines, packed."""
    if isinstance(ref, J.GLS):
        fn = JL.dwt_nd_lifting if fw else JL.idwt_nd_lifting
        return np.asarray(fn(jnp.asarray(x64), ref, 1, 2))
    h, g = JF.filter_pair(ref)
    fn = JF.dwt_nd if fw else JF.idwt_nd
    return np.asarray(fn(jnp.asarray(x64), h, g, 1, 2))


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_plain_matches_mxu_kernels_f32(name, kind):
    """f32 at 512x768 against the TPU kernels in interpret mode; both
    sides are within 1e-4 of f64 (tests/test_mxu2d.py), so 2e-4."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(81).standard_normal((512, 768)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = mxu2d.mxu_level_fw_quads(jnp.asarray(x), ref)
    got = level2d.level_fw_plain(torch.from_numpy(x)[None], wt)
    for g, w in zip(got, want):
        assert np.abs(g[0].numpy() - np.asarray(w)).max() < 2e-4
    # the inverse reads the quadrants in place from the packed array
    y = _packed([q[0] for q in got])
    with pltpu.force_tpu_interpret_mode():
        want_inv = np.asarray(mxu2d.mxu_inv_packed(
            jnp.asarray(y), jnp.asarray(y[:256, :384]), (512, 768), ref))
    yt = torch.from_numpy(y)[None]
    planes = (yt[:, :256, :384], *level2d.detail_planes(yt, 1))
    got_inv = level2d.level_inv_plain(*planes, wt)[0].numpy()
    assert np.abs(got_inv - want_inv).max() < 2e-4
    assert np.abs(got_inv - x).max() < 2e-4


@pytest.mark.parametrize("dma", ["1", "0"])
def test_packed_mode_matches_packed_mxu_kernels_f32(dma, monkeypatch):
    """Packed mode against mxu2d's packed first level: the DMA kernel
    (_mxu_packed_dma_kernel) and the q-axis kernel (_mxu_packed_kernel)."""
    monkeypatch.setenv("WAVELETS_TPU_PACKED_DMA", dma)
    ref, wt = _carriers("cdf97", "lifting")
    x = np.random.default_rng(82).standard_normal((256, 512)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        ll_want, y_want = mxu2d.mxu_level_fw_packed_first(jnp.asarray(x), ref)
    y = torch.full((1, 256, 512), float("nan"))
    ll = torch.empty((1, 128, 256))
    level2d.level_fw(torch.from_numpy(x)[None], wt,
                     (ll, *level2d.detail_planes(y, 1)))
    assert np.abs(ll[0].numpy() - np.asarray(ll_want)).max() < 2e-4
    details = np.asarray(y_want).copy()
    details[:128, :256] = np.nan       # LL went to its own array on both
    assert np.allclose(y[0].numpy(), details, atol=2e-4, equal_nan=True)


CASES = [("cdf97", "lifting"), ("haar", "lifting"), ("db2", "lifting"),
         ("db4", "filter"), ("sym6", "filter"), ("coif4", "filter")]
SHAPES = [(2, 2), (4, 8), (8, 8), (64, 96), (96, 160)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name, kind", CASES)
def test_plain_matches_engines_f64(name, kind, shape):
    """f64 against the JAX engines at <= 1e-12 x scale, including the tiny
    shapes where several taps alias onto one sample."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(7).standard_normal(shape)
    want = _jax_level(x, ref)
    got = _packed(q[0] for q in level2d.level_fw_plain(
        torch.from_numpy(x)[None], wt))
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())
    back = _jax_level(want, ref, fw=False)
    yt = torch.from_numpy(want.copy())[None]
    mh, nh = shape[0] // 2, shape[1] // 2
    got_inv = level2d.level_inv_plain(yt[:, :mh, :nh],
                                      *level2d.detail_planes(yt, 1), wt)
    assert np.abs(got_inv[0].numpy() - back).max() <= 1e-12 * max(
        1.0, np.abs(back).max())
    # sym and coif tables are orthogonal only to their printed precision
    # (tests/test_transforms.py, _RT_TOL)
    rt_tol = {"sym6": 5e-9, "coif4": 1e-9}.get(name, 1e-12)
    assert np.abs(got_inv[0].numpy() - x).max() <= rt_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_packed_mode_equals_quads_mode(dtype):
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 32, 48))).to(dtype)
    quads = level2d.level_fw(x, wt)
    y = torch.full((3, 64, 96), float("nan"), dtype=dtype)
    ll = torch.empty_like(quads[0])
    planes = (ll, *level2d.detail_planes(y, 2))
    level2d.level_fw(x, wt, planes)
    for p, q in zip(planes, quads):
        assert torch.equal(p, q)
    assert torch.isnan(y[:, :16, :24]).all()   # LL went to its own buffer


def test_batch_rides_the_leading_axis():
    wt = T.wavelet(T.wt.db4, "filter")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 16, 32)))
    batched = level2d.level_fw(x, wt)
    for b in range(3):
        single = level2d.level_fw(x[b:b + 1], wt)
        for s, q in zip(single, batched):
            assert torch.equal(s[0], q[b])


def test_bf16_plain_computes_in_f32_and_rounds_once():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 16, 16))).to(torch.bfloat16)
    got = level2d.level_fw(x, wt)
    want = level2d.level_fw(x.float(), wt)
    for g, w in zip(got, want):
        assert torch.equal(g, w.to(torch.bfloat16))
    back = level2d.level_inv(*got, wt)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, level2d.level_inv(
        *(g.float() for g in got), wt).to(torch.bfloat16))


def test_orientation_lh_is_row_scaling_column_detail():
    """A signal constant down the columns has no axis-0 detail: only LL
    and LH (axis-0 scaling, axis-1 detail) carry energy."""
    wt = T.wavelet(T.wt.haar, "lifting")
    row = torch.from_numpy(np.random.default_rng(8).standard_normal(16))
    x = row.expand(8, 16).contiguous()[None]
    ll, lh, hl, hh = level2d.level_fw(x, wt)
    assert lh.abs().max() > 0.1
    assert hl.abs().max() < 1e-12 and hh.abs().max() < 1e-12
