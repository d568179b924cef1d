"""The 1-D level (ops/level1d.py) against the JAX package.

The plain versions, which a CPU tensor takes, are held in float32 against
the TPU kernels they stand beside, run in interpret mode as
tests/test_mxu2d.py and tests/test_pallas.py run them: the MXU level of
``dwt1d`` (``_mxu_level_fw`` / ``_mxu_level_inv``), its VPU form
(``_split(_steps(...))`` and ``_steps(_merge(...))``), and the folded
long-signal level of ``wide1d`` (``_level_wide_b``, VPU and MXU bodies).
In float64 they are held against the JAX engines' level functions.  The
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.

Tolerances: float32 against an interpret-mode kernel 2e-4 (the TPU
kernels emulate f32 dots in three bf16 passes, tests/test_pyramid1d.py);
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
from wavelets_tpu.ops.pallas import dwt1d as JD, wide1d as JW

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import level1d
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
    """(s, d) and the inverse of (s, d), through the plain versions."""
    s, d = level1d.level1d_fw_plain(torch.from_numpy(x), wt)
    return s.numpy(), d.numpy(), level1d.level1d_inv_plain(s, d, wt).numpy()


F32_CASES = [("cdf97", "lifting"), ("haar", "lifting"), ("db4", "filter"),
             ("sym6", "filter")]


@pytest.mark.parametrize("name, kind", F32_CASES)
def test_plain_matches_mxu_level_kernels_f32(name, kind):
    """#20 / #21: one batched level of (16, 512) rows on the MXU."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(31).standard_normal((16, 512)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        ws, wd = JD._mxu_level_fw(jnp.asarray(x), ref)
        wx = JD._mxu_level_inv(ws, wd, ref)
    s, d, xr = _plain(x, wt)
    assert np.abs(s - np.asarray(ws)).max() < 2e-4
    assert np.abs(d - np.asarray(wd)).max() < 2e-4
    assert np.abs(xr - np.asarray(wx)).max() < 2e-4
    assert np.abs(xr - x).max() < 2e-4


@pytest.mark.parametrize("name, kind", F32_CASES)
def test_plain_matches_step_split_merge_kernels_f32(name, kind):
    """#17-#19: the interleaved chain over full rows, then the
    deinterleave (forward); the interleave, then the inverse chain."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(32).standard_normal((16, 512)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        ws, wd = JD._split(JD._steps(jnp.asarray(x), ref, True))
        wx = JD._steps(JD._merge(ws, wd), ref, False)
    s, d, xr = _plain(x, wt)
    assert np.abs(s - np.asarray(ws)).max() < 2e-4
    assert np.abs(d - np.asarray(wd)).max() < 2e-4
    assert np.abs(xr - np.asarray(wx)).max() < 2e-4


@pytest.mark.parametrize("mxu", ["0", "1"])
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_plain_matches_wide_fold_kernels_f32(name, kind, mxu, monkeypatch):
    """#34 / #35 (VPU body) and #32 / #33 (MXU body, WAVELETS_TPU_WIDE_MXU=1):
    one level of two 2^14 signals through the (R, C) fold."""
    monkeypatch.setenv("WAVELETS_TPU_WIDE_MXU", mxu)
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(33).standard_normal((2, 1 << 14)).astype(
        np.float32)
    assert JW._fold(x.shape[1], ref, np.float32) is not None
    with pltpu.force_tpu_interpret_mode():
        ws, wd = JW._level_wide_b(jnp.asarray(x), ref, True)
        wx = JW._level_wide_b((ws, wd), ref, False)
    s, d, xr = _plain(x, wt)
    assert np.abs(s - np.asarray(ws)).max() < 2e-4
    assert np.abs(d - np.asarray(wd)).max() < 2e-4
    assert np.abs(xr - np.asarray(wx)).max() < 2e-4


def _jax_level(x64, ref):
    """One level in float64 through the JAX engines: (s, d), and the
    inverse of (s, d)."""
    if isinstance(ref, J.GLS):
        s, d = JL.lifting_level_fw(jnp.asarray(x64), ref)
        return s, d, JL.lifting_level_inv(s, d, ref)
    h, g = JF.filter_pair(ref)
    s, d = JF.dwt_level(jnp.asarray(x64), h, g)
    return s, d, JF.idwt_level(s, d, h, g)


@pytest.mark.parametrize("n", [2, 8, 96, 512])
@pytest.mark.parametrize("name, kind", F32_CASES)
def test_plain_matches_engines_f64(name, kind, n):
    """f64 at <= 1e-12 x scale, including n = 2 and 8 where several taps
    alias onto one sample, and n = 96 = 3 * 2^5."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(34).standard_normal((3, n))
    ws, wd, wx = (np.asarray(a) for a in _jax_level(x, ref))
    s, d, xr = _plain(x, wt)
    for got, want in ((s, ws), (d, wd), (xr, wx)):
        assert np.abs(got - want).max() <= 1e-12 * max(1.0,
                                                       np.abs(want).max())
    # sym tables are orthogonal only to their printed precision
    # (tests/test_transforms.py, _RT_TOL)
    assert np.abs(xr - x).max() <= (5e-9 if name == "sym6" else 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_packet_rows_equal_separate_planes(dtype):
    """E's outputs may be the two halves of each output row (the packet
    transform's layout) or two arrays: the same numbers either way, and F
    reads the halves in place."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (5, 48))).to(dtype)
    s, d = level1d.level1d_fw(x, wt)
    rows = torch.full((5, 48), float("nan"), dtype=dtype)
    level1d.level1d_fw(x, wt, rows[:, :24], rows[:, 24:])
    assert torch.equal(rows[:, :24], s) and torch.equal(rows[:, 24:], d)
    assert torch.equal(level1d.level1d_inv(rows[:, :24], rows[:, 24:], wt),
                       level1d.level1d_inv(s, d, wt))


def test_details_land_in_a_packed_segment():
    """d goes straight to a strided segment of a wider packed array."""
    wt = T.wavelet(T.wt.db4, "filter")
    x = torch.from_numpy(np.random.default_rng(36).standard_normal((3, 32)))
    y = torch.full((3, 64), float("nan"), dtype=torch.float64)
    s = torch.empty((3, 16), dtype=torch.float64)
    level1d.level1d_fw(x, wt, s, y[:, 16:32])
    s2, d2 = level1d.level1d_fw(x, wt)
    assert torch.equal(s, s2) and torch.equal(y[:, 16:32], d2)
    assert torch.isnan(y[:, :16]).all() and torch.isnan(y[:, 32:]).all()


def test_bf16_plain_computes_in_f32_and_rounds_once():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(37).standard_normal(
        (2, 64))).to(torch.bfloat16)
    s, d = level1d.level1d_fw(x, wt)
    s32, d32 = level1d.level1d_fw(x.float(), wt)
    assert torch.equal(s, s32.to(torch.bfloat16))
    assert torch.equal(d, d32.to(torch.bfloat16))
    back = level1d.level1d_inv(s, d, wt)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back, level1d.level1d_inv(s.float(), d.float(),
                                                 wt).to(torch.bfloat16))


def test_rows_are_independent():
    wt = T.wavelet(T.wt.haar, "lifting")
    x = torch.from_numpy(np.random.default_rng(38).standard_normal((4, 16)))
    s, d = level1d.level1d_fw(x, wt)
    for b in range(4):
        sb, db = level1d.level1d_fw(x[b:b + 1], wt)
        assert torch.equal(sb[0], s[b]) and torch.equal(db[0], d[b])


# kernel F's form and shared bytes per wavelet (float32, bfloat16,
# float64), worked out by hand from csrc/level1d.cu.  The tiled form's
# stage holds the s and d rows of a full tile (512 groups of V pairs, V =
# 8 / element bytes) plus 32 elements each and a pad of 64: cdf97 in
# float32 2 * (2 * (1024 + 32) + 64) * 4 = 17408 bytes for two stages,
# and its 16 synthesis taps 16 * 8 = 128.  db10 (span 18) takes the first
# form: 2 * (256 + 18) * acc + its 40 taps' table.
INV1D_FORMS = [("cdf97", "lifting", 8, (17536, 17024, 18624)),
               ("haar", "lifting", 8, (17440, 16928, 18480)),
               ("db4", "filter", 8, (17536, 17024, 18624)),
               ("coif4", "filter", 16, (17600, 17088, 18720)),
               ("db10", "filter", 0, (2512, 2512, 4864))]


@pytest.mark.parametrize("dtype_i, dtype", list(enumerate(
    (torch.float32, torch.bfloat16, torch.float64))))
@pytest.mark.parametrize("name, kind, window, smem", INV1D_FORMS)
def test_inverse_window_and_shared_bytes(name, kind, window, smem, dtype_i,
                                         dtype):
    """Kernel F's form for a wavelet: the tiled kernel's window (8 or 16
    offsets, above the synthesis bands' span) or 0, the first form, for a
    span of 16 or more; the shared bytes of one block, within the card's
    227 KB; and the band order the tiled kernel takes for the table's (each
    synthesis band strictly ascending)."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    bands = level1d.synthesis_bands(wt)
    offs = np.concatenate([d for d, _ in bands])
    span = int(offs.max() - offs.min())
    assert level1d.inv1d_window(wt) == window
    assert (span < window) if window else span >= 16
    assert level1d.inv1d_smem(wt, dtype) == smem[dtype_i] <= 232448
    for d, _ in bands:
        assert (np.diff(d) > 0).all()


def test_inverse_refuses_an_output_over_its_input():
    """The tiled F stages the next tile while it writes this one, so an
    output that overlaps s or d is refused, as for the forward; its
    callers (ops/dwt1d.py, ops/wpt.py, ops/rowcol2d.py,
    parallel/sharded.py) pass disjoint planes."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    y = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="overlaps"):
        level1d.level1d_inv(y[:, :4], y[:, 4:8], wt, out=y[:, 8:])
    with pytest.raises(ValueError, match="overlaps"):
        level1d.level1d_inv(y[:, :4], y[:, 4:8], wt, out=y[:, :8])
    out = torch.empty((3, 8))
    level1d.level1d_inv(y[:, :4], y[:, 4:8], wt, out=out)

