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


# --- kernel J's forms: window, shared bytes, staging path, work items ------

def _syn(wt):
    """Smallest synthesis offset, span and tap count, from the bands."""
    offs = np.concatenate([dl for dl, _ in axis0.synthesis_bands(wt)])
    return int(offs.min()), int(offs.max() - offs.min()), len(offs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name, kind, window", [
    ("cdf97", "lifting", 8), ("haar", "lifting", 8), ("db4", "filter", 8),
    ("coif4", "filter", 16), ("db10", "filter", 0)])
def test_inverse_window_and_shared_bytes(name, kind, window, dtype):
    """Kernel J's form for a wavelet: the tiled kernel's window (8 or 16
    offsets, above the synthesis bands' span) or 0, the first form, for a
    span of 16 or more; and one block's shared bytes, worked out from the
    bands: the tiled form's two stages, each the a and d rows of 32 output
    pairs plus the span, 32 groups of 16 bytes of the arithmetic type
    wide, in the storage type; the first form's two windows of 32 + span
    rows of 32 lanes in the arithmetic type; the band table beside
    either.  Two tiled blocks fit an SM's 227 KB."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    _, span, taps = _syn(wt)
    acc = 8 if dtype == torch.float64 else 4
    size = torch.empty((), dtype=dtype).element_size()
    table = taps * (acc + 4)
    assert axis0.inv_window(wt) == window
    assert (span < window) if window else span >= 16
    if window:
        want = 2 * 2 * (32 + span) * 32 * (16 // acc) * size + table
        assert 2 * want <= 232448
    else:
        want = 2 * (32 + span) * 32 * acc + table
    assert axis0.inv_smem(wt, dtype) == want
    x = torch.zeros((2, 4, 8), dtype=dtype)
    assert axis0.inv_plan(x, x, wt).smem == want
    for dl, _ in axis0.synthesis_bands(wt):      # the tiled kernel's order
        assert (np.diff(dl) > 0).all()


def _aligned(shape, dtype, offset=0):
    """A (B, R, C) view whose base is ``offset`` elements past a 64-byte
    aligned buffer (torch's CPU allocations are)."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_inverse_staging_path(dtype):
    """J stages by 16-byte words where C and every view it reads (a, d, a
    corner) have 16-byte bases and batch and row strides of whole words;
    by 4 bytes otherwise: a ragged C, a view one element in, the strided
    views of the 3-D driver's tests with gaps, an unaligned corner."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    e = 16 // torch.empty((), dtype=dtype).element_size()
    a = _aligned((3, 4, 4 * e), dtype)
    plan = axis0.inv_plan(a, a, wt)
    assert plan.staging == 16
    assert axis0.inv_plan(a[:, :, :-1], a[:, :, :-1], wt).staging == 4
    assert axis0.inv_plan(_aligned((3, 4, 4 * e), dtype, 1), a,
                          wt).staging == 4
    gaps = _aligned((3, 7, 4 * e + 7), dtype)[:, 1:5, 2:2 + 4 * e]
    assert axis0.inv_plan(gaps, a, wt).staging == 4
    # the 3-D driver's permuted planes: batch stride C, row stride B C
    y = _aligned((8, 3, 4 * e), dtype)
    assert axis0.inv_plan(y[:4].permute(1, 0, 2), y[4:].permute(1, 0, 2),
                          wt).staging == 16
    corner = _aligned((2, 4, 2 * e), dtype)
    assert axis0.inv_plan(a, a, wt, corner).staging == 16
    assert axis0.inv_plan(a, a, wt, corner[:, :, 1:]).staging == 4
    # a corner whose row stride is not a whole word, and one whose width
    # Cc is not (the words across Cc take the 4-byte copy; the rest stays)
    assert axis0.inv_plan(a, a, wt, _aligned((2, 4, e + 1), dtype)[
        :, :, :e]).staging == 4
    assert axis0.inv_plan(a, a, wt, _aligned((2, 4, 2 * e), dtype)[
        :, :, :2 * e - 1]).staging == 16


def emulate_inv(a, d, wt, corner=None, halos=None):
    """numpy emulation of kernel J's tiled walk (csrc/axis0.cu) in float64,
    with the geometry of :func:`axis0.inv_plan`: each work item stages the
    window rows of a and d of its strip and batch items as the kernel
    lays them out (the periodic wrap, the halo views, the corner by
    columns), each unit (output pair, batch item, V columns) sums its
    taps from the staged rows only, and every write is counted.  Returns
    the result and the count of writes of each output."""
    plan = axis0.inv_plan(a, d, wt, corner, halos)
    assert plan.window
    B, Rh, C = a.shape
    smin, span, _ = _syn(wt)
    bands = axis0.synthesis_bands(wt)
    v = 16 // (8 if a.dtype == torch.float64 else 4)
    groups = 32
    assert plan.tr in (8, 16, 32)
    A, D = a.double().numpy(), d.double().numpy()
    H = [h.double().numpy() for h in halos] if halos else None
    K = corner.double().numpy() if corner is not None else None
    out = np.full((B, 2 * Rh, C), np.nan)
    writes = np.zeros((B, 2 * Rh, C), np.int64)
    bpb = 1 << plan.bsh
    assert plan.cw * bpb <= plan.ps * bpb <= groups * v     # a strip's room
    for t in range(plan.items):
        rest, ct = divmod(t, plan.ctiles)
        c0, k0 = ct * plan.cw, (rest % plan.rtiles) * plan.tr
        b0 = (rest // plan.rtiles) << plan.bsh
        tr = min(plan.tr, Rh - k0)
        rows, nb, cwl = tr + span, min(bpb, B - b0), min(plan.cw, C - c0)
        stg = np.full((rows, 2, bpb, plan.ps), np.nan)
        for i in range(rows):
            q = k0 + smin + i
            for src, P in ((0, A), (1, D)):
                for bl in range(nb):
                    b = b0 + bl
                    if H is not None and q < 0:
                        row = H[2 * src][b, H[2 * src].shape[1] + q]
                    elif H is not None and q >= Rh:
                        row = H[2 * src + 1][b, q - Rh]
                    else:
                        row = P[b, q % Rh].copy()
                        if src == 0 and K is not None and b < K.shape[0]:
                            row[:K.shape[2]] = K[b, q % Rh]
                    stg[i, src, bl, :cwl] = row[c0:c0 + cwl]
        for r in range(tr):
            for bl in range(nb):
                for j0 in range(0, min(cwl, v << plan.gsh), v):
                    cols = np.arange(j0, min(j0 + v, cwl))
                    for p in (0, 1):
                        acc = np.zeros(len(cols))
                        for src in (0, 1):
                            for dl, c in zip(*bands[2 * p + src]):
                                acc = acc + c * stg[r + dl - smin, src, bl,
                                                    cols]
                        out[b0 + bl, 2 * (k0 + r) + p, c0 + cols] = acc
                        writes[b0 + bl, 2 * (k0 + r) + p, c0 + cols] += 1
    return out, writes


_WALKS = [("narrow C", (5, 4, 3)), ("Rh = 1", (3, 1, 40)),
          ("ragged strip", (2, 37, 150)), ("batch groups", (9, 3, 10))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case, shape", _WALKS)
def test_inverse_walk_writes_each_output_once(case, shape, dtype):
    """Kernel J's work items and units, emulated: every output written
    exactly once, from staged rows only, equal to the plain version; the
    narrow level (several batch items to a strip), Rh = 1 (every tap
    wraps onto one row), a strip cut at a ragged C and batch groups of
    unequal fill."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    rng = np.random.default_rng(47)
    a = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    d = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    out, writes = emulate_inv(a, d, wt)
    assert (writes == 1).all()
    ref = axis0.axis0_inv_plain(a.double(), d.double(), wt).numpy()
    assert np.abs(out - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name, kind", [("db4", "filter"),
                                        ("coif4", "filter")])
def test_inverse_walk_on_the_3d_drivers_views_with_a_corner(name, kind):
    """The 3-D inverse's call (ops/dwt3d.py): a and d the two halves of a
    sub-cube viewed as (B = m, Rh = d/2, C = n), the leading (Bc, Rh, Cc)
    block of a read from the deeper level's result; emulated over 8- and
    16-offset windows, against the plain version with the same corner."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    rng = np.random.default_rng(48)
    y = torch.from_numpy(rng.standard_normal((8, 12, 20)))
    a, d = y[:4].permute(1, 0, 2), y[4:].permute(1, 0, 2)   # (12, 4, 20)
    deeper = torch.from_numpy(rng.standard_normal((4, 6, 10)))
    corner = deeper.permute(1, 0, 2)                         # (6, 4, 10)
    assert axis0.inv_plan(a, d, wt, corner).staging == 16
    out, writes = emulate_inv(a, d, wt, corner)
    assert (writes == 1).all()
    ref = axis0.axis0_inv_plain(a, d, wt, corner=corner).numpy()
    assert np.abs(out - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


# --- kernel I's forms: window, shared bytes, staging path, work items ------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name, kind, window", [
    ("haar", "lifting", 8), ("db2", "filter", 8), ("cdf97", "lifting", 16),
    ("db4", "filter", 16), ("coif4", "filter", 0), ("db10", "filter", 0)])
def test_forward_window_and_shared_bytes(name, kind, window, dtype):
    """Kernel I's form for a wavelet: the tiled kernel's window (8 or 16
    offsets, above the analysis bands' span) or 0, the first form, for a
    span of 16 or more; and one block's shared bytes, worked out from the
    bands: the tiled form's two stages, each the 2 x 32 - 1 + span rows of
    x that 32 output pairs read, 32 groups of 16 bytes of the arithmetic
    type wide, in the storage type; the first form's window of 2 x 32 +
    span rows of 32 lanes in the arithmetic type; the band table beside
    either.  Two tiled blocks fit an SM's 227 KB.  A level below the
    size bound takes the first form."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    ds, _, dd, _ = axis0.level_bands(wt)
    offs = np.concatenate([ds, dd])
    span, taps = int(offs.max() - offs.min()), len(offs)
    acc = 8 if dtype == torch.float64 else 4
    size = torch.empty((), dtype=dtype).element_size()
    table = taps * (acc + 4)
    first = (2 * 32 + span) * 32 * acc + table
    assert axis0.fw_window(wt) == window
    assert (span < window) if window else span >= 16
    if window:
        want = 2 * (2 * 32 - 1 + span) * 32 * (16 // acc) * size + table
        assert 2 * want <= 232448
    else:
        want = first
    assert axis0.fw_smem(wt, dtype) == want
    x = torch.zeros((2, 8, 16), dtype=dtype)
    a = torch.zeros((2, 4, 16), dtype=dtype)
    assert axis0.fw_plan(x, a, a, wt, min_pairs=0).smem == want
    assert axis0.fw_plan(x, a, a, wt, min_pairs=0).window == window
    small = axis0.fw_plan(x, a, a, wt, min_pairs=2 * 4 * 16 + 1)
    assert small.window == 0 and small.smem == first
    assert axis0.fw_plan(x, a, a, wt) == small     # below FW_A0_MIN_PAIRS
    big = torch.zeros((1, 2, axis0.FW_A0_MIN_PAIRS), dtype=dtype)
    assert axis0.fw_plan(big, big[:, :1], big[:, :1], wt).window == window
    # the tiled kernel's order: the scaling band ascending, the detail
    # band ascending (lifting) or descending (filter), never mixed
    assert (np.diff(ds) > 0).all()
    steps = np.sign(np.diff(dd))
    assert len(set(steps)) <= 1 and (kind == "filter") == (steps[0] < 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_forward_staging_path(dtype):
    """I stages by 16-byte words where C and x have 16-byte bases and batch
    and row strides of whole words; by 4 bytes otherwise: C cut by one
    element, x one element in, x with gaps of no whole word.  The output
    planes are checked apart for word stores (V columns): the 3-D
    driver's permuted views take them where their widths are whole words,
    a plane one element in does not."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    e = 16 // torch.empty((), dtype=dtype).element_size()
    def plan_of(x, a, d):
        return axis0.fw_plan(x, a, d, wt, min_pairs=0)

    x = _aligned((3, 8, 4 * e), dtype)
    a = _aligned((3, 4, 4 * e), dtype)
    plan = plan_of(x, a, a)
    assert (plan.staging, plan.wide_a, plan.wide_d) == (16, True, True)
    cut = x[:, :, :-1]
    assert plan_of(cut, a[:, :, :-1], a[:, :, :-1]).staging == 4
    assert plan_of(_aligned((3, 8, 4 * e), dtype, 1), a, a).staging == 4
    gaps = _aligned((3, 11, 4 * e + 7), dtype)[:, 1:9, 2:2 + 4 * e]
    assert plan_of(gaps, a, a).staging == 4
    # the 3-D driver (ops/dwt3d.py): x the scratch as (B = m, R = d, C =
    # n), a and d the halves of a larger packed volume, same layout
    s = _aligned((8, 6, 4 * e), dtype)
    y = _aligned((16, 6, 4 * e + 8), dtype)
    pa, pd = y[:4, :, :4 * e].permute(1, 0, 2), y[4:8, :, :4 * e].permute(
        1, 0, 2)
    plan = plan_of(s.permute(1, 0, 2), pa, pd)
    assert (plan.staging, plan.wide_a, plan.wide_d) == (16, True, True)
    one_in = _aligned((3, 4, 4 * e), dtype, 1)
    plan = plan_of(x, a, one_in)
    assert (plan.staging, plan.wide_a, plan.wide_d) == (16, True, False)


def emulate_fw(x, wt, halos=None):
    """numpy emulation of kernel I's tiled walk (csrc/axis0.cu) in float64,
    with the geometry of :func:`axis0.fw_plan`: each work item stages the
    2 tr - 1 + span rows of x of its strip and batch items as the kernel
    lays them out (the periodic wrap, the halo views above and below),
    each unit (output pair, batch item, V columns) sums each band's taps
    from the staged rows only, one product per tap in table order (a
    filter's detail band descending), and every write is counted.
    Returns a, d and the count of writes of each output of either."""
    B, R, C = x.shape
    Rh = R // 2
    out = torch.empty((B, Rh, C), dtype=x.dtype)
    plan = axis0.fw_plan(x, out, out, wt, halos, min_pairs=0)
    assert plan.window
    ds, cs, dd, cd = axis0.level_bands(wt)
    offs = np.concatenate([ds, dd])
    dmin, span = int(offs.min()), int(offs.max() - offs.min())
    v = 16 // (8 if x.dtype == torch.float64 else 4)
    groups = 32
    assert plan.tr in (8, 16, 32)
    X = x.double().numpy()
    H = [h.double().numpy() for h in halos] if halos else None
    outs = np.full((2, B, Rh, C), np.nan)
    writes = np.zeros((2, B, Rh, C), np.int64)
    bpb = 1 << plan.bsh
    assert plan.cw * bpb <= plan.ps * bpb <= groups * v     # a strip's room
    for t in range(plan.items):
        rest, ct = divmod(t, plan.ctiles)
        c0, k0 = ct * plan.cw, (rest % plan.rtiles) * plan.tr
        b0 = (rest // plan.rtiles) << plan.bsh
        tr = min(plan.tr, Rh - k0)
        rows, nb, cwl = 2 * tr - 1 + span, min(bpb, B - b0), min(plan.cw,
                                                                 C - c0)
        assert rows <= 2 * 32 - 1 + span                  # a stage's room
        stg = np.full((rows, bpb, plan.ps), np.nan)
        for i in range(rows):
            r = 2 * k0 + dmin + i
            for bl in range(nb):
                b = b0 + bl
                if H is not None and r < 0:
                    row = H[0][b, H[0].shape[1] + r]
                elif H is not None and r >= R:
                    row = H[1][b, r - R]
                else:
                    row = X[b, r % R]
                stg[i, bl, :cwl] = row[c0:c0 + cwl]
        for r in range(tr):
            for bl in range(nb):
                for j0 in range(0, min(cwl, v << plan.gsh), v):
                    cols = np.arange(j0, min(j0 + v, cwl))
                    for p, (dl, cl) in enumerate(((ds, cs), (dd, cd))):
                        acc = np.zeros(len(cols))
                        for o, c in zip(dl, cl):
                            acc = acc + c * stg[2 * r + o - dmin, bl, cols]
                        outs[p, b0 + bl, k0 + r, c0 + cols] = acc
                        writes[p, b0 + bl, k0 + r, c0 + cols] += 1
    return outs[0], outs[1], writes


# (case, x shape, JT_SPREAD): a spread of 1 keeps several batch items to a
# strip at a size the emulation runs quickly
_FW_WALKS = [("narrow C, batch items to a strip", (5, 8, 3), 1),
             ("R = 2", (3, 2, 40), None),
             ("ragged strip, small items", (2, 74, 150), None),
             ("batch groups of unequal fill", (9, 6, 10), 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
@pytest.mark.parametrize("case, shape, spread", _FW_WALKS)
def test_forward_walk_writes_each_output_once(case, shape, spread, name,
                                              kind, dtype, monkeypatch):
    """Kernel I's work items and units, emulated: every output written
    exactly once, from staged rows only, equal to the plain version; the
    narrow level (several batch items to a strip, the 3-D driver's deep
    levels), R = 2 (the whole window wraps onto two rows), a strip cut at
    a ragged C with a small level's items (8 output pairs) and batch
    groups of unequal fill."""
    if spread is not None:
        monkeypatch.setattr(axis0, "_JT_SPREAD", spread)
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    x = torch.from_numpy(np.random.default_rng(49).standard_normal(
        shape)).to(dtype)
    plan = axis0.fw_plan(x, x[:, ::2], x[:, ::2], wt, min_pairs=0)
    if spread is not None:
        assert plan.bsh > 0 and shape[0] % (1 << plan.bsh)
    a, d, writes = emulate_fw(x, wt)
    assert (writes == 1).all()
    ra, rd = axis0.axis0_fw_plain(x.double(), wt)
    for got, ref in ((a, ra.numpy()), (d, rd.numpy())):
        assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name, kind", [("haar", "lifting"),
                                        ("db4", "filter")])
def test_forward_walk_on_the_3d_drivers_views(name, kind):
    """The 3-D forward's call (ops/dwt3d.py): x the scratch of a sub-cube
    viewed as (B = m, R = d, C = n), a and d the two halves of the packed
    output's leading block in the same layout; planned on the 16-byte
    staging path with word stores into both planes, emulated over 8- and
    16-offset windows, against the plain version writing those views."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    rng = np.random.default_rng(50)
    s = torch.from_numpy(rng.standard_normal((12, 4, 20)))
    x = s.permute(1, 0, 2)                                   # (4, 12, 20)
    y = torch.full((16, 8, 24), float("nan"), dtype=torch.float64)
    pa, pd = (y[:6, :4, :20].permute(1, 0, 2),
              y[6:12, :4, :20].permute(1, 0, 2))             # (4, 6, 20)
    plan = axis0.fw_plan(x, pa, pd, wt, min_pairs=0)
    assert (plan.staging, plan.wide_a, plan.wide_d) == (16, True, True)
    a, d, writes = emulate_fw(x, wt)
    assert (writes == 1).all()
    axis0.axis0_fw_plain(x, wt, pa, pd)
    for got, ref in ((a, pa.numpy()), (d, pd.numpy())):
        assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())
    assert torch.isnan(y[12:]).all() and torch.isnan(y[:, 4:]).all()
