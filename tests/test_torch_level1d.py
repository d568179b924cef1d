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



# --- kernel E's forms: window, shared bytes, staging path, work items ------

def _ana(wt):
    """Smallest analysis offset, span and tap count, from the bands."""
    ds, _, dd, _ = level1d.level_bands(wt)
    offs = np.concatenate([ds, dd])
    return int(offs.min()), int(offs.max() - offs.min()), len(offs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name, kind, window", [
    ("cdf97", "lifting", 16), ("haar", "lifting", 8), ("db4", "filter", 16),
    ("coif4", "filter", 0), ("db10", "filter", 0)])
def test_forward_window_and_shared_bytes(name, kind, window, dtype):
    """Kernel E's form for a wavelet: the tiled kernel's window (8 or 16
    offsets, above the analysis bands' span; kernel A's choice for the
    same bands) or 0, the first form; and one block's shared bytes,
    worked out from the bands: the tiled form's two stages, each one row
    of a full tile (512 groups of V pairs, V = 16 bytes of the arithmetic
    type: 1024 V samples) plus 32 elements of slack and 64 of pad, in the
    storage type; the first form's window of 2 x 512 + span samples in
    the arithmetic type; the band table beside either.  And the band
    order the tiled kernel reads off the table: the scaling band
    ascending, the detail band ascending or (a filter's) descending."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    _, span, taps = _ana(wt)
    acc = 8 if dtype == torch.float64 else 4
    size = torch.empty((), dtype=dtype).element_size()
    table = taps * (acc + 4)
    assert level1d.fw1d_window(wt) == window
    assert (span < window) if window else span >= 16
    if window:
        want = 2 * (2 * 512 * (16 // acc) + 32 + 64) * size + table
    else:
        want = (2 * 512 + span) * acc + table
    assert level1d.fw1d_smem(wt, dtype) == want <= 232448
    assert level1d.fw1d_plan(torch.zeros((2, 8), dtype=dtype), wt,
                             min_pairs=0).smem == want
    first = (2 * 512 + span) * acc + table
    assert level1d.fw1d_smem(wt, dtype, tiled=False) == first
    assert level1d.fw1d_plan(torch.zeros((2, 8), dtype=dtype),
                             wt) == (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, first)
    ds, _, dd, _ = level1d.level_bands(wt)
    assert (np.diff(ds) > 0).all()
    assert (np.diff(dd) > 0).all() or (np.diff(dd) < 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_forward_staging_path(dtype):
    """E stages by 16-byte words where x's base, row stride and n are
    whole words; by 4 bytes otherwise (a row one element in, an odd row
    stride, the short rows of a deep packet depth: 2 samples are a whole
    word in float64 only)."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    e = 16 // torch.empty((), dtype=dtype).element_size()

    def plan(x):
        return level1d.fw1d_plan(x, wt, min_pairs=0)
    x = torch.zeros((3, 8 * e), dtype=dtype)
    assert plan(x).staging == 16
    assert plan(x[:, 1:1 + 4 * e]).staging == 4
    assert plan(torch.zeros((3, 8 * e + 1), dtype=dtype)[
        :, :8 * e]).staging == 4
    assert plan(torch.zeros((5, 2), dtype=dtype)).staging == (
        16 if e == 2 else 4)


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("db4", "filter"),
                                        ("db10", "filter")])
@pytest.mark.parametrize("B, n", [(1, 1 << 19), (1, (1 << 19) - 2),
                                  (1 << 18, 2), ((1 << 18) - 1, 2),
                                  (512, 1024), (511, 1024), (3, 4096),
                                  (1, 1 << 24)])
def test_forward_form_follows_the_level_size(B, n, name, kind):
    """E takes its tiled form for a span below 16 and a level of at
    least FW1D_MIN_PAIRS output pairs in all (B n/2: one long row, or
    many short ones alike), its first form below that or for a span of 16
    or more; a plan made with a bound of 0 pairs is tiled for every
    size."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    assert level1d.FW1D_MIN_PAIRS == 1 << 18
    x = torch.empty((B, n), dtype=torch.float32)
    window = level1d.fw1d_window(wt)
    tiled = bool(window) and B * (n // 2) >= 1 << 18
    assert level1d.fw1d_plan(x, wt).window == (window if tiled else 0)
    assert level1d.fw1d_plan(x, wt, min_pairs=0).window == window


def emulate_fw(x, wt):
    """numpy emulation of kernel E's tiled walk (csrc/level1d.cu) in
    float64, with the geometry of :func:`level1d.fw1d_plan`: each work item
    stages its rows' windows (the wrap applied while staging) as the
    kernel lays them out, each unit (row, V pairs) sums its taps from its
    staged row only, and every write is counted.  Returns s, d and the
    count of writes of each output pair."""
    plan = level1d.fw1d_plan(x, wt, min_pairs=0)
    assert plan.window
    B, n = x.shape
    nh = n // 2
    dmin, span, _ = _ana(wt)
    ds, cs, dd, cd = level1d.level_bands(wt)
    v = 16 // (8 if x.dtype == torch.float64 else 4)
    full = 512 * v
    assert plan.rpb * plan.ps <= 2 * full + 32          # one stage's room
    assert plan.rpb << plan.gsh <= 512                  # units of an item
    X = x.double().numpy()
    s, d = np.full((B, nh), np.nan), np.full((B, nh), np.nan)
    writes = np.zeros((B, nh), np.int64)
    pairs = np.arange(plan.tk)
    for t in range(plan.items):
        grp, tt = divmod(t, plan.tiles)
        b0, k0 = grp * plan.rpb, tt * plan.tk
        rows, cnt = min(plan.rpb, B - b0), min(plan.tk, nh - k0)
        assert cnt <= v << plan.gsh                      # groups cover it
        cb = 2 * k0 + dmin - plan.sh
        stg = X[b0:b0 + rows][:, (cb + np.arange(plan.ps)) % n]
        k = pairs[:cnt]
        for out, offs, coefs in ((s, ds, cs), (d, dd, cd)):
            idx = 2 * k[:, None] + plan.sh + (np.asarray(offs) - dmin)
            assert idx.max() < plan.ps                  # inside its row
            out[b0:b0 + rows, k0:k0 + cnt] = (stg[:, idx] * coefs).sum(-1)
        writes[b0:b0 + rows, k0:k0 + cnt] += 1
    return s, d, writes


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
@pytest.mark.parametrize("B, n", [(1 << 19, 2), (700, 2), (5, 1000),
                                  (1, 1 << 20)])
def test_forward_walk_writes_each_output_once(B, n, name, kind):
    """Kernel E's work items, emulated: every output pair written exactly
    once, from its staged row only, equal to the plain version: the deep
    packet depth of a 2^20 signal (2^19 rows of 2 samples, a span above
    n: every tap wraps), 700 rows of 2, (5, 1000) (several rows to an
    item) and one 2^20 row (cut into tiles)."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    x = torch.from_numpy(np.random.default_rng(39).standard_normal((B, n)))
    s, d, writes = emulate_fw(x.float(), wt)
    assert (writes == 1).all()
    rs, rd = level1d.level1d_fw_plain(x.float().double(), wt)
    for got, ref in ((s, rs.numpy()), (d, rd.numpy())):
        assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())
