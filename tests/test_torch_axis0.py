"""The axis-0 level (ops/axis0.py, kernels I and J) against the JAX package.

The plain versions, which a CPU tensor takes, are held in float32 against
the TPU kernels they stand beside, ``axis0.axis0_level_fw`` /
``axis0_level_inv`` run in interpret mode as tests/test_mxu2d.py runs them:
the banded-matmul bodies (#22, #24) and, with WAVELETS_TPU_MXU2D=0, the
VPU roll-chain bodies (#23, #25).  In float64 they are held against the
JAX engines' level functions along axis 0.  The CUDA kernels themselves
are held against these plain versions on the card by chip_smoke.py.

Tolerances: float32 against an interpret-mode kernel 1e-4 (the MXU bodies
emulate f32 dots in three bf16 passes; their own round trip is 4e-5);
float64 1e-12 x max(1, max|ref|).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops import filter_fb as JF, lifting as JL
from wavelets_tpu.ops.pallas import axis0 as JA

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import axis0
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


def _plain(x, wt):
    """``[a; d]`` of ``x (R, C)`` along axis 0, and the inverse of that,
    through the plain versions with B = 1."""
    a, d = axis0.axis0_fw_plain(torch.from_numpy(x)[None], wt)
    back = axis0.axis0_inv_plain(a, d, wt)
    return torch.cat([a[0], d[0]]).numpy(), back[0].numpy()


@pytest.mark.parametrize("mxu", ["1", "0"])
@pytest.mark.parametrize("name, kind", [("db2", "filter"),
                                        ("cdf97", "lifting")])
def test_plain_matches_axis0_kernels_f32(name, kind, mxu, monkeypatch):
    """#22/#24 (MXU bodies) and #23/#25 (VPU bodies) at (128, 512)."""
    monkeypatch.setenv("WAVELETS_TPU_MXU2D", mxu)
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(41).standard_normal((128, 512)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA.axis0_level_fw(jnp.asarray(x), ref))
        want_inv = np.asarray(JA.axis0_level_inv(jnp.asarray(want), ref))
    got, _ = _plain(x, wt)
    assert np.abs(got - want).max() < 1e-4
    # the inverse of the kernel's own coefficients
    a, d = torch.from_numpy(want[None].copy()).split(64, dim=1)
    got_inv = axis0.axis0_inv_plain(a, d, wt)[0].numpy()
    assert np.abs(got_inv - want_inv).max() < 1e-4
    assert np.abs(got_inv - x).max() < 1e-4


def _jax_level(x64, ref):
    """One level along axis 0 in float64 through the JAX engines, packed
    ``[a; d]``, and the inverse of it."""
    xt = jnp.asarray(x64.T)
    if isinstance(ref, J.GLS):
        a, d = JL.lifting_level_fw(xt, ref)
        back = JL.lifting_level_inv(a, d, ref)
    else:
        h, g = JF.filter_pair(ref)
        a, d = JF.dwt_level(xt, h, g)
        back = JF.idwt_level(a, d, h, g)
    return (np.concatenate([np.asarray(a).T, np.asarray(d).T]),
            np.asarray(back).T)


F64_CASES = [("cdf97", "lifting"), ("haar", "lifting"), ("db4", "filter"),
             ("db2", "filter")]


@pytest.mark.parametrize("R", [2, 8, 96, 128])
@pytest.mark.parametrize("name, kind", F64_CASES)
def test_plain_matches_engines_f64(name, kind, R):
    """f64 at <= 1e-12 x scale, R = 2 and 8 included, where several taps
    alias onto one row."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(42).standard_normal((R, 5))
    want, want_inv = _jax_level(x, ref)
    got, got_inv = _plain(x, wt)
    for g, w in ((got, want), (got_inv, want_inv), (got_inv, x)):
        assert np.abs(g - w).max() <= 1e-12 * max(1.0, np.abs(w).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_strided_views_equal_contiguous(dtype):
    """A (B, R, C) view with gaps between its rows and its batch items,
    and output planes in the 3-D driver's permuted layout: the same
    numbers as contiguous arrays, and the NaN outside them untouched."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    nan = float("nan")
    base = torch.from_numpy(np.random.default_rng(43).standard_normal(
        (3, 11, 9))).to(dtype)
    x = base[:, 1:9, 2:7]                          # (3, 8, 5), strided
    a, d = axis0.axis0_fw(x.contiguous(), wt)
    out = torch.full((2, 4, 3, 6), nan, dtype=dtype)
    pa = out[0, :, :, :5].permute(1, 0, 2)         # (3, 4, 5)
    pd = out[1, :, :, 1:].permute(1, 0, 2)
    axis0.axis0_fw(x, wt, pa, pd)
    assert torch.equal(pa, a) and torch.equal(pd, d)
    assert torch.isnan(out[0, :, :, 5]).all()
    assert torch.isnan(out[1, :, :, 0]).all()
    # the inverse reads the strided planes in place into a strided view
    dest = torch.full((8, 3, 6), nan, dtype=dtype)[:, :, :5].permute(1, 0, 2)
    axis0.axis0_inv(pa, pd, wt, out=dest)
    assert torch.equal(dest, axis0.axis0_inv(a, d, wt))


def test_corner_replaces_the_leading_block():
    wt = T.wavelet(T.wt.db4, "filter")
    rng = np.random.default_rng(44)
    a = torch.from_numpy(rng.standard_normal((4, 3, 6)))
    d = torch.from_numpy(rng.standard_normal((4, 3, 6)))
    corner = torch.from_numpy(rng.standard_normal((2, 3, 3)))
    joined = a.clone()
    joined[:2, :, :3] = corner
    got = axis0.axis0_inv(a, d, wt, corner=corner)
    assert torch.equal(got, axis0.axis0_inv(joined, d, wt))
    with pytest.raises(ValueError):                  # wrong row count
        axis0.axis0_inv(a, d, wt, corner=corner[:, :2])
    with pytest.raises(ValueError):                  # wider than a
        axis0.axis0_inv(a, d, wt, corner=torch.zeros((2, 3, 7),
                                                      dtype=a.dtype))


def test_bf16_plain_computes_in_f32_and_rounds_once():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(45).standard_normal(
        (2, 16, 8))).to(torch.bfloat16)
    a, d = axis0.axis0_fw(x, wt)
    a32, d32 = axis0.axis0_fw(x.float(), wt)
    assert torch.equal(a, a32.to(torch.bfloat16))
    assert torch.equal(d, d32.to(torch.bfloat16))
    back = axis0.axis0_inv(a, d, wt)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, axis0.axis0_inv(a.float(), d.float(),
                                             wt).to(torch.bfloat16))


def test_batch_items_are_independent():
    wt = T.wavelet(T.wt.haar, "lifting")
    x = torch.from_numpy(np.random.default_rng(46).standard_normal(
        (4, 8, 3)))
    a, d = axis0.axis0_fw(x, wt)
    for b in range(4):
        ab, db = axis0.axis0_fw(x[b:b + 1], wt)
        assert torch.equal(ab[0], a[b]) and torch.equal(db[0], d[b])
