"""The 2-D level (ops/level2d.py) against the JAX package.

The plain versions, which a CPU tensor takes, are held against the TPU
kernels they stand beside (``mxu2d.mxu_level_fw_quads`` and
``mxu_inv_packed``, run in interpret mode as tests/test_mxu2d.py runs
them) and against fused2d's single-pass level, which computes the same
(``_quad_kernel``, ``_packed_kernel``, ``_inv_kernel``, the JAX package's
route under ``WAVELETS_TPU_MXU2D=0``), in float32, and against the JAX
float64 engines.  The CUDA kernels
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
from wavelets_tpu.ops.pallas import fused2d, mxu2d

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


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_a_matches_fused_level_kernels_f32(name, kind):
    """A's plain version in quads mode against fused2d's _quad_kernel and in
    packed mode against _packed_kernel (level_fw_packed_first)."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(101).standard_normal((256, 512)).astype(
        np.float32)
    assert fused2d.fused_ok(256, 512, ref, np.float32)
    assert fused2d.packed_ok(256, 512, ref, np.float32)
    with pltpu.force_tpu_interpret_mode():
        quads = fused2d.fused_level_fw_quads(jnp.asarray(x), ref)
        ll_p, y_p = (np.asarray(v) for v in
                     fused2d.level_fw_packed_first(jnp.asarray(x), ref))
    got = level2d.level_fw_plain(torch.from_numpy(x)[None], wt)
    for g, w in zip(got, quads):
        assert _rel(g[0].numpy(), w) < 2e-4
    y = torch.full((1, 256, 512), float("nan"))
    ll = torch.empty((1, 128, 256))
    level2d.level_fw(torch.from_numpy(x)[None], wt,
                     (ll, *level2d.detail_planes(y, 1)))
    assert _rel(ll[0].numpy(), ll_p) < 2e-4
    for g, w in zip(level2d.detail_planes(y, 1),
                    (y_p[:128, 256:], y_p[128:, :256], y_p[128:, 256:])):
        assert _rel(g[0].numpy(), w) < 2e-4


@pytest.mark.parametrize("name, kind", [("db2", "filter"),
                                        ("cdf97", "lifting")])
def test_b_matches_fused_inverse_kernel_f32(name, kind):
    """B's plain version, reading its planes in place from the packed
    array, against fused2d's _inv_kernel (level_inv_packed), at the
    smallest shape fused_inv_ok takes."""
    ref, wt = _carriers(name, kind)
    m, n = 64, 1024
    assert fused2d.fused_inv_ok(m, n, ref, np.float32)
    assert not fused2d.fused_inv_ok(m // 2, n, ref, np.float32)
    y = np.random.default_rng(102).standard_normal((m, n)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fused2d.level_inv_packed(
            jnp.asarray(y), jnp.asarray(y[: m // 2, : n // 2]), (m, n), ref))
    yt = torch.from_numpy(y)[None]
    got = level2d.level_inv_plain(yt[:, : m // 2, : n // 2],
                                  *level2d.detail_planes(yt, 1), wt)
    assert _rel(got[0].numpy(), want) < 2e-4


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


@pytest.mark.parametrize("name, kind, window", [
    ("haar", "lifting", 8), ("cdf97", "lifting", 8), ("db4", "filter", 8),
    ("sym6", "filter", 16), ("coif4", "filter", 16), ("db8", "filter", 16),
    ("db10", "filter", 0), ("coif8", "filter", 0)])
def test_inverse_window_and_shared_bytes(name, kind, window):
    """Kernel B's form for a wavelet: the tiled kernel's window (8 or 16
    offsets, above the synthesis bands' span) or 0, the first form, for a
    span of 16 or more; and the shared bytes of one block, within the
    card's 227 KB in every dtype."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    offs = np.concatenate([d for d, _ in level2d.synthesis_bands(wt)])
    span = int(offs.max() - offs.min())
    assert level2d.inv_window(wt) == window
    assert window == 0 or span < window
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        smem = level2d.inv_smem(wt, dtype)
        assert 0 < smem <= level2d.SMEM_LIMIT
        if window == 0:
            table = level2d.band_table(wt, True, dtype, torch.device("cpu"))
            assert smem == level2d._smem(table, 32 + span, 64)


# kernel A's form and shared bytes per wavelet (float32, bfloat16,
# float64), worked out by hand from csrc/level2d.cu.  cdf97 in float32:
# analysis offsets -4 .. 4 (span 8, window 16); a 32-row tile stages 2 *
# 32 - 1 + 8 = 71 rows of ceil((0 + 2 * 32 - 1 + 8) / 4) * 4 = 72 floats,
# padded to 76 (an odd count of 16-byte words); S and D 2 * 71 * 32 * 4 =
# 18176 bytes, two stages 2 * (71 * 76 + 64) * 4 = 43680, the table of 16
# taps 16 * 8 = 128: 61984 in all.  coif4 and db10 (spans 21 and 37) take
# the first form: 2 * (64 + span) * 32 * acc + the table.
FW_FORMS = [("cdf97", "lifting", 16, (61984, 41280, 67360)),
            ("haar", "lifting", 8, (51744, 33056, 51248)),
            ("db4", "filter", 16, (71168, 44160, 78656)),
            ("coif4", "filter", 0, (21952, 21952, 43808)),
            ("db10", "filter", 0, (26176, 26176, 52192))]


@pytest.mark.parametrize("dtype_i, dtype", list(enumerate(
    (torch.float32, torch.bfloat16, torch.float64))))
@pytest.mark.parametrize("name, kind, window, smem", FW_FORMS)
def test_forward_window_and_shared_bytes(name, kind, window, smem, dtype_i,
                                         dtype):
    """Kernel A's form for a wavelet: the tiled kernel's window (8 or 16
    offsets, above the analysis bands' span) or 0, the first form, for a
    span of 16 or more; the shared bytes of one block, within the card's
    227 KB; and the band order the tiled kernel reads off the table (the
    scaling band strictly ascending, the detail band too, or descending:
    a filter's)."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    ds, _, dd, _ = level2d.level_bands(wt)
    span = int(max(ds.max(), dd.max()) - min(ds.min(), dd.min()))
    assert level2d.fw_window(wt) == window
    assert (span < window) if window else span >= 16
    assert level2d.fw_smem(wt, dtype) == smem[dtype_i] <= level2d.SMEM_LIMIT
    assert (np.diff(ds) > 0).all()
    assert (np.diff(dd) > 0).all() or (np.diff(dd) < 0).all()

