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


# --- kernel H's staged form: window, shared bytes, staging path, walk ------

def _syn(wt):
    """The synthesis bands (S0, D0, S1, D1) and their span."""
    bands = tail1d.synthesis_bands(wt)
    offs = np.concatenate([d for d, _ in bands])
    return bands, int(offs.max() - offs.min())


# the staged form's window: the widest source's taps (cdf97: S offsets -1
# .. 2, D offsets -2 .. 2, 5 wide: 8; db4: S -3 .. 0 and D 0 .. 3: 4; sym5
# 5 wide, coif4 6: 8), 0 where the span is 16 or more (db10: 18)
INV_FORMS = [("cdf97", "lifting", 8), ("haar", "lifting", 4),
             ("db4", "filter", 4), ("sym5", "filter", 8),
             ("coif4", "filter", 8), ("db10", "filter", 0)]
DTYPES = (torch.float32, torch.bfloat16, torch.float64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name, kind, window", INV_FORMS)
def test_inverse_window_and_shared_bytes(name, kind, window, dtype):
    """Kernel H's form for a wavelet and one block's shared bytes, worked
    out from the bands: (4096, 1024) rows in the staged form, 512 items of
    V pairs (V = 4, 2 in float64) per block, so 4 rows (2 in float64), and
    (4096, 4096) rows one to a block, each staged whole in the storage
    type beside its two scaling buffers (half and a quarter of a row) in
    the arithmetic type, and the band table; the first form's two rows of
    the arithmetic type for db10; each within the card's 227 KB."""
    _, wt = _carriers(name, kind)
    (s0, _), (d0, _), (s1, _), (d1, _) = tail1d.synthesis_bands(wt)
    _, span = _syn(wt)
    ext = max(max(s0.max(), s1.max()) - min(s0.min(), s1.min()),
              max(d0.max(), d1.max()) - min(d0.min(), d1.min())) + 1
    assert tail1d.inv_window(wt) == window
    assert (span < 16 and ext <= window) if window else span >= 16
    assert window in (0, 4, 8) and (window != 8 or ext > 4)
    size = torch.empty((), dtype=dtype).element_size()
    acc = 8 if dtype == torch.float64 else 4
    table = tail1d.tap_count(wt, True) * (acc + 4)
    for n, rows in ((1024, 2 if acc == 8 else 4), (4096, 1)):
        plan = tail1d.inv_plan(torch.empty((4096, n), dtype=dtype), wt, 8)
        if window:
            pa = n // 2 + n // 4
            assert plan == (window, 16, rows, 256, 4096 // rows, n, pa,
                            rows * (n * size + pa * acc) + table)
        else:
            assert plan == (0, 0, 1, 256, 4096, n, n, 2 * n * acc + table)
        assert plan.smem <= 232448
    first = tail1d.inv_plan(torch.empty((4096, 1024), dtype=dtype), wt, 8,
                            staged=False)
    assert first.window == 0 and first.smem == 2 * 1024 * acc + table


@pytest.mark.parametrize("dtype", DTYPES)
def test_inverse_staging_path(dtype):
    """The staged H stages by 16-byte words where y's base, row stride and
    n are whole words; by 4 bytes otherwise (a view one element in, a row
    stride of an odd count, rows of 2 samples); short rows several to a
    block, with no more threads than their first level's items ask."""
    _, wt = _carriers("db4", "filter")
    e = 16 // torch.empty((), dtype=dtype).element_size()
    y = torch.zeros((5, 8 * e + 1), dtype=dtype)
    plan = tail1d.inv_plan(y[:, :8 * e], wt, 2)
    assert plan.staging == 4 and plan.rows == 5
    assert tail1d.inv_plan(y[1:, 1:1 + 4 * e], wt, 2).staging == 4
    assert tail1d.inv_plan(torch.zeros((5, 8 * e), dtype=dtype), wt,
                           2).staging == 16
    short = tail1d.inv_plan(torch.zeros((700, 2), dtype=dtype), wt, 1)
    assert short.staging == (16 if e == 2 else 4)
    assert (short.rows, short.threads, short.blocks) == (512, 256, 2)
    # (3, 96): 3 rows of 12 items of 4 pairs (24 of 2 in float64), two a
    # thread
    assert tail1d.inv_plan(torch.zeros((3, 96), dtype=dtype), wt,
                           5).threads == (64 if e == 2 else 32)


def emulate_inv(y, wt, L, values=True):
    """numpy emulation of kernel H's staged walk (csrc/tail1d.cu) in
    float64, with the geometry of :func:`tail1d.inv_plan`: each block
    stages its rows whole, and each level reads its s band from the stage
    (the first level) or the buffer the level before wrote (X after an
    even level, Y after an odd one) and its d band from the stage, V pairs
    per item, the windows wrapped on the level's length, and
    writes to the other buffer (the last level to the output); a level's
    outputs must fit their buffer.  Every output write is counted (only
    that where ``values`` is false, for the largest shapes).  Returns the
    output and the count of writes of each element."""
    plan = tail1d.inv_plan(y, wt, L)
    assert plan.window
    B, n = y.shape
    v = 2 if y.dtype == torch.float64 else 4
    (s0, c0), (d0, e0), (s1, c1), (d1, e1) = tail1d.synthesis_bands(wt)
    stage = np.full((plan.blocks * plan.rows, plan.ps), np.nan)
    stage[:B, :n] = y.double().numpy()
    xa = -(-(n // 2) // v) * v
    buf = {0: np.full((plan.blocks * plan.rows, xa), np.nan),        # X
           1: np.full((plan.blocks * plan.rows, plan.pa - xa), np.nan)}
    out = np.full((B, n), np.nan)
    writes = np.zeros((B, n), np.int64)
    for l in range(L, 0, -1):
        nh = n >> l
        per = -(-nh // v)                       # items of V pairs a row
        u = np.arange(plan.rows * per)
        assert len(u) <= 2 * plan.threads or plan.rows == 1
        r = np.repeat(u // per, v)
        k = (u % per * v)[:, None] + np.arange(v)
        keep = k.ravel() < nh
        r, k = r[keep], k.ravel()[keep]
        assert l == 1 or 2 * nh <= buf[l & 1].shape[1]
        # the same items in every block: global row b * rows + r
        rows = (np.arange(plan.blocks)[:, None] * plan.rows + r).ravel()
        pairs = np.tile(k, plan.blocks)
        ok = rows < B
        rows, pairs = rows[ok], pairs[ok]
        s = stage if l == L else buf[(l + 1) & 1]
        new = {0: np.nan, 1: np.nan}
        for p, (ds, cs_, dd, cd) in enumerate(((s0, c0, d0, e0),
                                               (s1, c1, d1, e1))
                                              if values else ()):
            new[p] = ((s[rows[:, None], (pairs[:, None] + ds) % nh] * cs_)
                      .sum(-1) + (stage[rows[:, None], nh + (pairs[:, None]
                                                              + dd) % nh]
                                  * cd).sum(-1))
        for p in (0, 1):
            if l > 1:
                buf[l & 1][rows, 2 * pairs + p] = new[p]
            else:
                out[rows, 2 * pairs + p] = new[p]
                np.add.at(writes, (rows, 2 * pairs + p), 1)
    return out, writes


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
@pytest.mark.parametrize("B, n, L", [(3, 96, 5), (5, 8, 3), (7, 64, 6),
                                     (700, 2, 1), (2, 4096, 12)])
def test_inverse_walk_equals_plain(B, n, L, name, kind):
    """Kernel H's staged walk, emulated in float64: every output written
    exactly once, equal to the plain version: short rows several to a
    block, rows of 2 (a window past
    both ends of every level) and two rows of 4096 through 12 levels (one
    to a block, several items a thread)."""
    _, wt = _carriers(name, kind)
    y = torch.from_numpy(np.random.default_rng(47).standard_normal((B, n)))
    got, writes = emulate_inv(y, wt, L)
    want = tail1d.tail1d_inv_plain(y, wt, L).numpy()
    assert (writes == 1).all()
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("B, n, L", [(4096, 4096, 8), (3, 96, 5),
                                     (1, 1 << 14, 14), (5, 8, 3)])
def test_inverse_walk_writes_each_output_once(B, n, L):
    """The staged walk's writes at the batched path's (4096, 4096), at (3,
    96), one row of 2^14 (the 2^20 db2 L20 inverse's tail; its threads take
    several items a level) and (5, 8): each output element exactly
    once."""
    _, wt = _carriers("db4", "filter")
    y = torch.zeros((B, n), dtype=torch.float32)
    assert tail1d.inv_plan(y, wt, L).window == 4
    assert (emulate_inv(y, wt, L, values=False)[1] == 1).all()


def test_tail1d_fits_keeps_its_answers():
    """tail1d_fits on a grid of lengths, wavelets, dtypes and directions:
    the staged form changes no route (2^14 samples in float32 and
    bfloat16, 2^13 in float64, for every wavelet here)."""
    from wavelets_tpu_torch import wavelet, wt as W
    wts = [wavelet(W.cdf97, "lifting"), wavelet(W.db4, "filter"),
           wavelet(W.haar, "lifting"), wavelet(W.db10, "filter")]
    for dtype, top in ((torch.float32, 14), (torch.bfloat16, 14),
                       (torch.float64, 13)):
        for k in range(1, 17):
            for wt in wts:
                for inverse in (False, True):
                    assert tail1d.tail1d_fits(1 << k, wt, dtype,
                                              inverse) == (k <= top)


# --- kernel G's staged form: window, shared bytes, staging path, walk ------

# the staged forward's window in output pairs: each analysis band's samples
# (haar 2, db2 4, db4 8: 4; cdf97's S band -4 .. 4, 9 samples: 8), 0 where
# the bands' span is 16 or more (sym5: 17, db10: 37)
FW_FORMS = [("cdf97", "lifting", 8), ("haar", "lifting", 4),
            ("db4", "filter", 4), ("db2", "filter", 4),
            ("sym5", "filter", 0), ("db10", "filter", 0)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name, kind, window", FW_FORMS)
def test_forward_window_and_shared_bytes(name, kind, window, dtype):
    """Kernel G's form for a wavelet and one block's shared bytes, worked
    out from the bands: (4096, 1024) rows in the staged form, 512 items of
    V pairs (V = 4, 2 in float64) per block, so 4 rows (2 in float64),
    and (4096, 4096) rows one to a block, each staged whole in the
    storage type beside its scaling buffer X (half a row) in the
    arithmetic type (Y, a quarter, in the stage once level 1 has read
    it), and the band table; blocks of 128 threads, four items each, as
    both launches have 132 blocks or more; the first form's two rows of
    the arithmetic type for sym5 and db10; never more than the first
    form's bytes, so tail1d_fits keeps its answers."""
    _, wt = _carriers(name, kind)
    ds, _, dd, _ = tail1d.level_bands(wt)
    span = int(max(ds.max(), dd.max()) - min(ds.min(), dd.min()))
    ext = max(int(b.max() - b.min()) + 1 for b in (ds, dd))
    assert tail1d.fw_window(wt) == window
    assert (span < 16 and ext <= 2 * window) if window else span >= 16
    assert window in (0, 4, 8) and (window != 8 or ext > 8)
    size = torch.empty((), dtype=dtype).element_size()
    acc = 8 if dtype == torch.float64 else 4
    table = tail1d.tap_count(wt, False) * (acc + 4)
    for n, rows in ((1024, 2 if acc == 8 else 4), (4096, 1)):
        x = torch.empty((4096, n), dtype=dtype)
        plan = tail1d.fw_plan(x, wt, 8)
        first = 2 * n * acc + table
        if window:
            pa = n // 2
            assert plan == (window, 16, rows, 128, 4096 // rows, n, pa,
                            rows * (n * size + pa * acc) + table)
            assert plan.smem <= rows * first
        else:
            assert plan == (0, 0, 1, 256, 4096, n, n, first)
        assert plan.smem <= 232448
    assert tail1d.fw_plan(torch.empty((4096, 1024), dtype=dtype), wt, 8,
                          staged=False).smem == 2 * 1024 * acc + table
    top = 1 << (13 if dtype == torch.float64 else 14)
    assert tail1d.tail1d_fits(top, wt, dtype)
    assert tail1d.fw_plan(torch.empty((1, top), dtype=dtype), wt,
                          14).smem <= 232448


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_staging_path(dtype):
    """The staged G stages by 16-byte words where x's base, row stride and
    n are whole words; by element otherwise (a view one element in, a row
    stride of an odd count, rows of 2 samples); short rows several to a
    block, with no more threads than their first level's items ask; 256
    threads for a launch of fewer than 132 blocks (one row of 2^14), 128
    from 132 blocks up (the same rows to a block)."""
    _, wt = _carriers("cdf97", "lifting")
    e = 16 // torch.empty((), dtype=dtype).element_size()
    x = torch.zeros((5, 8 * e + 1), dtype=dtype)
    plan = tail1d.fw_plan(x[:, :8 * e], wt, 2)
    assert plan.staging == 4 and plan.rows == 5
    assert tail1d.fw_plan(x[1:, 1:1 + 4 * e], wt, 2).staging == 4
    assert tail1d.fw_plan(torch.zeros((5, 8 * e), dtype=dtype), wt,
                          2).staging == 16
    short = tail1d.fw_plan(torch.zeros((700, 2), dtype=dtype), wt, 1)
    assert short.staging == (16 if e == 2 else 4)
    assert (short.rows, short.threads, short.blocks) == (512, 256, 2)
    assert tail1d.fw_plan(torch.zeros((3, 96), dtype=dtype), wt,
                          5).threads == (64 if e == 2 else 32)
    assert tail1d.fw_plan(torch.zeros((3, 96), dtype=dtype), wt, 5,
                          staged=False).staging == 0
    long = tail1d.fw_plan(torch.zeros((1, 1 << 13), dtype=dtype), wt, 13)
    assert (long.rows, long.threads, long.blocks) == (1, 256, 1)
    for B, threads in ((131, 256), (132, 128)):
        plan = tail1d.fw_plan(torch.zeros((B, 4096), dtype=dtype), wt, 8)
        assert (plan.rows, plan.threads, plan.blocks) == (1, threads, B)


def emulate_fw(x, wt, L, values=True):
    """numpy emulation of kernel G's staged walk (csrc/tail1d.cu) in
    float64, with the geometry of :func:`tail1d.fw_plan`: each block
    stages its rows whole, and level l reads its row from the stage (l =
    1) or the buffer level l - 1 wrote (X after an odd level, Y, in the
    row's stage, after an even one; the stage is read at level 1 only),
    V pairs per item from two windows (one per band, 2V - 2
    plus the band's width samples from 2 k0 plus its least offset),
    wrapped on the level's length; it writes its scaling band to the
    other buffer (the last level to the row's head) and its details to
    their packed offset, in words of V elements where the offset is a
    whole number of words; a level's outputs must fit their buffer.
    Every output write is counted (only that where ``values`` is false).
    Returns the output, the count of writes of each element and the
    number of word stores."""
    plan = tail1d.fw_plan(x, wt, L)
    assert plan.window
    B, n = x.shape
    v = 2 if x.dtype == torch.float64 else 4
    # Y lives in the row's stage: as many arithmetic-type elements as fit
    ya = plan.ps * x.element_size() // (8 if x.dtype == torch.float64 else 4)
    ds, cs, dd, cd = tail1d.level_bands(wt)
    bands = ((ds, cs), (dd, cd))
    for d, _ in bands:
        assert d.max() - d.min() + 1 <= 2 * plan.window
    nrows = plan.blocks * plan.rows
    stage = np.full((nrows, plan.ps), np.nan)
    stage[:B, :n] = x.double().numpy()
    assert plan.pa == -(-(n // 2) // v) * v
    buf = {0: np.full((nrows, plan.pa), np.nan),              # X
           1: np.full((nrows, ya), np.nan)}                   # Y
    out = np.full((B, n), np.nan)
    writes = np.zeros((B, n), np.int64)
    words = 0
    for l in range(1, L + 1):
        nl = n >> (l - 1)
        nh = nl // 2
        per = -(-nh // v)                       # items of V pairs a row
        u = np.arange(plan.rows * per)
        assert len(u) <= 4 * plan.threads or plan.rows == 1
        rows = (np.arange(plan.blocks)[:, None] * plan.rows
                + u // per).ravel()
        k0 = np.tile(u % per * v, plan.blocks)
        ok = rows < B
        rows, k0 = rows[ok], k0[ok]
        src = stage if l == 1 else buf[(l - 1) % 2 == 0]
        new = []
        for d, c in bands:
            # the item's window, wrapped on the level, then each pair's taps
            win = (2 * k0[:, None] + d.min()
                   + np.arange(2 * v - 2 + d.max() - d.min() + 1)) % nl
            taps = (2 * np.arange(v)[:, None] + d - d.min())  # (V, taps)
            vals = src[rows[:, None], win] if values else \
                np.zeros(win.shape)
            new.append((vals[:, taps] * c).sum(-1))           # (items, V)
        dst = buf[l % 2 == 0]
        assert l == L or nh <= dst.shape[1]
        for e in range(v):
            keep = k0 + e < nh
            r, k = rows[keep], k0[keep] + e
            out[r, nh + k] = new[1][keep, e]
            np.add.at(writes, (r, nh + k), 1)
            if l == L:
                out[r, k] = new[0][keep, e]
                np.add.at(writes, (r, k), 1)
            else:
                dst[r, k] = new[0][keep, e]
        whole = k0 + v <= nh
        if nh % v == 0:        # the details' words; s_L's at the last level
            words += int(whole.sum()) * (2 if l == L else 1)
        elif l == L:
            words += int(whole.sum())
    return out, writes, words


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
@pytest.mark.parametrize("B, n, L", [(3, 96, 5), (5, 8, 3), (7, 64, 6),
                                     (700, 2, 1), (2, 4096, 12)])
def test_forward_walk_equals_plain(B, n, L, name, kind):
    """Kernel G's staged walk, emulated in float64: every output written
    exactly once, equal to the plain version: short rows several to a
    block, rows of 2 (a window past both ends of every level) and two rows
    of 4096 through 12 levels (one to a block, several items a thread)."""
    _, wt = _carriers(name, kind)
    x = torch.from_numpy(np.random.default_rng(48).standard_normal((B, n)))
    got, writes, _ = emulate_fw(x, wt, L)
    want = tail1d.tail1d_fw_plain(x, wt, L).numpy()
    assert (writes == 1).all()
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("B, n, L", [(4096, 4096, 8), (3, 96, 5),
                                     (1, 1 << 14, 14), (5, 8, 3)])
def test_forward_walk_writes_each_output_once(B, n, L):
    """The staged walk's writes at the batched path's (4096, 4096), at (3,
    96), one row of 2^14 (the 2^20 db2 L20 forward's tail) and (5, 8):
    each output element exactly once; the batched path's outputs all go
    in 16-byte words: its details (2048 + 1024 + ... + 16 a row) and s_8
    (16), n/4 words of 4 a row."""
    _, wt = _carriers("db4", "filter")
    x = torch.zeros((B, n), dtype=torch.float32)
    assert tail1d.fw_plan(x, wt, L).window == 4
    _, writes, words = emulate_fw(x, wt, L, values=False)
    assert (writes == 1).all()
    if (B, n) == (4096, 4096):
        assert words == B * n // 4
