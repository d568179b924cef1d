"""Kernel N's plain version (ops/stage2d.py) and the stage route against
the JAX package's fused two-level stage (``stage2d._stage2_kernel``).

The JAX side runs its TPU kernels in interpret mode with
``WAVELETS_TPU_MXU_LS2=1``, as tests/test_mxu2d.py runs them; its f32 dots
are split-bf16 emulations within about 1e-5 of f32, so the port's plain
version, which a CPU tensor takes, must agree within 2e-4 relative (the
class of the split-dot TPU kernels).  In bfloat16 both round every level's
outputs, the JAX side with one-pass bf16 dots: 2^-5 relative.  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py (phase kernelsstage).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import (filter2d as JF2, lifting2d as JL2,
                                     stage2d as JS)

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import level2d, pyramid2d, stage2d, tail2d
from wavelets_tpu_torch.wt.convert import from_reference

SHAPE = (256, 512)
WAVELETS = [("cdf97", "lifting"), ("db4", "filter")]
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -5}


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


def _input(dtype):
    x = np.random.default_rng(95).standard_normal(SHAPE).astype(np.float32)
    return x if dtype == "float32" else np.array(
        jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_stage():
    """The JAX package's outputs, computed once per case and shared:
    ``("dwt", name, kind, L, dtype)`` the packed dwt2 with the stage on,
    ``("stage", name, kind, last)`` stage2_fw itself (f32)."""
    memo = {}

    def get(key):
        if key not in memo:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("WAVELETS_TPU_MXU_LS2", "1")
                ref, _ = _carriers(key[1], key[2])
                with pltpu.force_tpu_interpret_mode():
                    if key[0] == "dwt":
                        L, dt = key[3], key[4]
                        xx = jnp.asarray(_input(dt), dt)
                        assert JS.stage2_ok(*SHAPE, ref, xx.dtype)
                        fn = JL2.dwt2_lifting if key[2] == "lifting" \
                            else JF2.dwt2_filter
                        memo[key] = np.asarray(fn(xx, ref, L), np.float64)
                    else:
                        last = key[3]
                        res = JS.stage2_fw(jnp.asarray(_input("float32")),
                                           None, SHAPE, ref, last=last)
                        memo[key] = ((np.asarray(res),) if last else
                                     (np.asarray(res[1]), np.asarray(res[0])))
        return memo[key]
    return get


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("name, kind", WAVELETS)
def test_stage_route_matches_jax_stage(name, kind, L, dtype, jax_stage):
    """pyramid2d's stage route (N's plain version, then C for L = 3) against
    the JAX packed driver with the stage on."""
    _, wt = _carriers(name, kind)
    want = jax_stage(("dwt", name, kind, L, dtype))
    x = torch.from_numpy(_input(dtype)).to(getattr(torch, dtype))[None]
    before = dict(stage2d.PLAIN_CALLS)
    got = pyramid2d.dwt2(x, wt, L, route="stage")[0].double().numpy()
    assert stage2d.PLAIN_CALLS["stage2_fw"] == before["stage2_fw"] + 1
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("name, kind", WAVELETS)
def test_plain_matches_stage2_kernel_f32(name, kind, last, jax_stage):
    """stage2_fw_plain against stage2d.stage2_fw: with ``last`` LL2 goes
    into the packed array's corner, else to its own array."""
    _, wt = _carriers(name, kind)
    m, n = SHAPE
    want = jax_stage(("stage", name, kind, last))
    y = torch.full((1, m, n), float("nan"))
    ll2 = y[:, : m >> 2, : n >> 2] if last else torch.empty((1, m >> 2,
                                                             n >> 2))
    outs = (ll2, *level2d.detail_planes(y, 1), *level2d.detail_planes(y, 2))
    stage2d.stage2_fw_plain(torch.from_numpy(_input("float32"))[None], wt,
                            outs)
    ywant = want[0].copy()
    if not last:
        assert _rel(ll2[0].numpy(), want[1]) <= TOL["float32"]
        ywant[: m >> 2, : n >> 2] = np.nan     # LL2 went to its own array
    got = y[0].double().numpy()
    mask = ~np.isnan(ywant)
    assert np.array_equal(np.isnan(got), ~mask)
    scale = np.abs(ywant[mask]).max()
    assert np.abs(got[mask] - ywant[mask]).max() <= TOL["float32"] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("coif4", "filter")])
def test_plain_equals_two_level_launches(name, kind, dtype):
    """N's plain version is two plain level launches of A, LL1 stored in
    the storage type in between: bit for bit, batch and ragged shapes."""
    _, wt = _carriers(name, kind)
    x = torch.from_numpy(np.random.default_rng(96).standard_normal(
        (2, 36, 20))).to(dtype)
    got = stage2d.stage2_fw_plain(x, wt)
    ll1, *d1 = level2d.level_fw_plain(x, wt)
    ll2, *d2 = level2d.level_fw_plain(ll1, wt)
    for g, w in zip(got, (ll2, *d1, *d2)):
        assert torch.equal(g, w)


# --- the bfloat16 two-level plain version sums as kernel A does -----------

def _round_f32(q):
    """The float32 nearest the rational q, ties to even."""
    f = np.float32(float(q))
    near = (np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf)))
    return min(near, key=lambda v: (abs(Fraction(float(v)) - q),
                                    int(np.array(v).view(np.uint32)) & 1))


def _pass_a(v, wt, axis, count):
    """One pass of kernel A along ``axis`` of the float32 array ``v``:
    each band's taps in table order, one exact fma each (the coefficient
    rounded to float32 as the band table holds it).  ``count[0]`` gains
    one for each fma whose float64 emulation (the exact product plus the
    sum in float64, rounded to float32) differs: a double rounding."""
    ds, cs, dd, cd = level2d.level_bands(wt)
    v = np.moveaxis(v, axis, -1)
    n = v.shape[-1]
    outs = []
    for deltas, coefs in ((ds, cs), (dd, cd)):
        c32 = [np.float32(c) for c in coefs]
        o = np.zeros(v.shape[:-1] + (n // 2,), np.float32)
        for idx in np.ndindex(*v.shape[:-1]):
            for k in range(n // 2):
                acc = np.float32(0)
                for dl, c in zip(deltas, c32):
                    x = v[idx + ((2 * k + int(dl)) % n,)]
                    exact = _round_f32(Fraction(float(c)) * Fraction(float(x))
                                       + Fraction(float(acc)))
                    count[0] += exact != np.float32(
                        np.float64(c) * np.float64(x) + np.float64(acc))
                    acc = exact
                o[idx + (k,)] = acc
        outs.append(np.moveaxis(o, -1, axis))
    return outs


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _two_a_launches(x, wt):
    """Two launches of kernel A on the bfloat16 image ``x (m, n)``, in
    exact arithmetic: each level's row pass, then its column pass on the
    two float32 bands, the outputs rounded to bfloat16 (LL1 before level
    2 reads it).  Returns (LL2, LH1, HL1, HH1, LH2, HL2, HH2) and the
    double roundings met."""
    count = [0]

    def level(v):
        a, d = _pass_a(v, wt, -1, count)
        ll, hl = _pass_a(a, wt, -2, count)
        lh, hh = _pass_a(d, wt, -2, count)
        return [_bf16(p) for p in (ll, lh, hl, hh)]

    ll1, *d1 = level(x.float().numpy())
    ll2, *d2 = level(ll1.float().numpy())
    return (ll2, *d1, *d2), count[0]


def _rel_planes(got, want):
    """chip_smoke.py's phase-2f measure: the largest over the planes of
    max |got - want| / max |want|."""
    return max((g.double() - w.double()).abs().max().item()
               / (w.double().abs().max().item() or 1.0)
               for g, w in zip(got, want))


# (wavelet, kind, shape, seed): haar 4 x 4 draws 185 and 99, on which the
# sum of rounded products missed 2^-7 against two A launches (by 0.119 and
# 7.87e-3), then fresh draws
BF16_DRAWS = [("haar", "lifting", (4, 4), 185), ("haar", "lifting", (4, 4), 99),
              ("haar", "lifting", (4, 4), 1101),
              ("haar", "lifting", (8, 4), 1102),
              ("cdf97", "lifting", (8, 8), 1103),
              ("db4", "filter", (8, 8), 1104)]


@pytest.mark.parametrize("name, kind, shape, seed", BF16_DRAWS)
def test_bf16_two_levels_sum_as_kernel_a(name, kind, shape, seed):
    """N's bfloat16 plain version against two launches of kernel A worked
    out exactly (one fma per tap in table order, the row pass, then the
    column pass): bit for bit, so LL1 rounds to bfloat16 from A's float32
    sum, and so within chip_smoke.py's 2^-7 at once; the chain of two
    level_fw_plain calls is the same.  No double rounding of the float64
    fma emulation occurs on these draws (counted).  The former plain
    version, a sum of rounded products, missed 2^-7 on the recorded
    draws."""
    _, wt = _carriers(name, kind)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).to(torch.bfloat16)
    want, ties = _two_a_launches(x, wt)
    assert ties == 0
    got = [p[0] for p in stage2d.stage2_fw_plain(x[None], wt)]
    ll1, *d1 = level2d.level_fw_plain(x[None], wt)
    ll2, *d2 = level2d.level_fw_plain(ll1, wt)
    for g, c, w in zip(got, (ll2, *d1, *d2), want):
        assert torch.equal(g, c[0]) and torch.equal(g, w)
    assert _rel_planes(got, want) <= 2.0 ** -7
    f32 = x.float()[None]
    o1, *e1 = level2d.quads_fw(f32, wt)
    o2, *e2 = level2d.quads_fw(o1.to(torch.bfloat16).float(), wt)
    old = [p[0].to(torch.bfloat16) for p in (o2, *e1, *e2)]
    if seed in (185, 99):
        assert _rel_planes(old, want) > 2.0 ** -7


@pytest.mark.parametrize("name, kind", [("haar", "lifting"),
                                        ("haar", "filter")])
def test_bf16_plain_against_jax_stage(name, kind):
    """The same bfloat16 image through the JAX package's stage2_fw (in
    interpret mode, the smallest shape its tiles take), N's plain version
    and two level_fw_plain calls: the port's two agree bit for bit, the
    JAX package within 2^-5 relative per plane.  The JAX kernel rounds
    more: its row-pass planes and LL1 are cast to the storage type before
    the column pass and level 2 (wavelets_tpu/ops/pallas/stage2d.py), and
    its dots run in bfloat16; kernel A and the plain version keep the row
    pass in float32."""
    ref, wt = _carriers(name, kind)
    m, n = SHAPE
    x = np.array(jnp.asarray(np.random.default_rng(185).standard_normal(
        SHAPE), jnp.bfloat16).astype(jnp.float32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WAVELETS_TPU_MXU_LS2", "1")
        with pltpu.force_tpu_interpret_mode():
            ll2, y = JS.stage2_fw(jnp.asarray(x, jnp.bfloat16), None, SHAPE,
                                  ref, last=False)
    y = np.asarray(y.astype(jnp.float32), np.float64)
    want = (np.asarray(ll2.astype(jnp.float32), np.float64),
            y[: m // 2, n // 2:], y[m // 2:, : n // 2], y[m // 2:, n // 2:],
            y[: m // 4, n // 4: n // 2], y[m // 4: m // 2, : n // 4],
            y[m // 4: m // 2, n // 4: n // 2])
    xt = torch.from_numpy(x).to(torch.bfloat16)[None]
    got = stage2d.stage2_fw_plain(xt, wt)
    ll1, *d1 = level2d.level_fw_plain(xt, wt)
    two = level2d.level_fw_plain(ll1, wt)
    for g, c in zip(got, (two[0], *d1, *two[1:])):
        assert torch.equal(g, c)
    for g, w in zip(got, want):
        assert _rel(g[0].double().numpy(), w) <= TOL["bfloat16"]


def test_stage_route_gate():
    """N runs for one image with both first levels as level launches; a
    batch, a single level or a deeper first tail runs A per level."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    f32 = torch.float32
    assert pyramid2d.stage_ok(1, 256, 512, 2, wt, f32)
    assert not pyramid2d.stage_ok(2, 256, 512, 2, wt, f32)    # a batch
    assert not pyramid2d.stage_ok(1, 256, 512, 1, wt, f32)    # one level
    assert not pyramid2d.stage_ok(1, 128, 256, 3, wt, f32)    # k = 1
    assert pyramid2d.kernel_levels(128, 256, 3, wt, f32, False) == 1
    batt = T.wavelet(T.wt.batt6)
    assert stage2d.stage_tile(batt, f32) is None
    assert not pyramid2d.stage_ok(1, 1024, 1024, 3, batt, f32)


@pytest.mark.parametrize("name, kind, dtype, tile", [
    ("cdf97", "lifting", torch.float32, 32),
    ("cdf97", "lifting", torch.bfloat16, 32),
    ("cdf97", "lifting", torch.float64, 16),
    ("coif4", "filter", torch.float32, 16),
    ("batt4", "filter", torch.float32, None)])
def test_stage_tile_follows_shared_memory(name, kind, dtype, tile):
    _, wt = _carriers(name, kind)
    assert stage2d.stage_tile(wt, dtype) == tile
    if tile is not None:
        assert stage2d.smem_bytes(wt, dtype, tile) <= level2d.SMEM_LIMIT
        if tile < stage2d.TILES[0]:
            assert stage2d.smem_bytes(wt, dtype, 2 * tile) > \
                level2d.SMEM_LIMIT


@pytest.mark.parametrize("L, calls", [
    (2, {"stage2_fw": 1, "level_fw": 0, "tail_fw": 0}),
    (3, {"stage2_fw": 1, "level_fw": 1, "tail_fw": 0}),
    (5, {"stage2_fw": 1, "level_fw": 1, "tail_fw": 1})])
def test_stage_route_launch_table(L, calls):
    """At 1024 x 512 f32 levels 1-3 are level launches (128 x 64 fits the
    tail): N takes levels 1-2, A level 3, C the rest."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(97).standard_normal(
        (1, 1024, 512)).astype(np.float32))
    for d in (stage2d.PLAIN_CALLS, level2d.PLAIN_CALLS, tail2d.PLAIN_CALLS):
        for k in d:
            d[k] = 0
    y = pyramid2d.dwt2(x, wt, L, route="stage")
    got = {"stage2_fw": stage2d.PLAIN_CALLS["stage2_fw"],
           "level_fw": level2d.PLAIN_CALLS["level_fw"],
           "tail_fw": tail2d.PLAIN_CALLS["tail_fw"]}
    assert got == calls
    assert torch.equal(y, pyramid2d.dwt2(x, wt, L))


def test_stage_wrapper_checks_its_inputs():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError):
        stage2d.stage2_fw(torch.zeros((1, 16, 18)), wt)        # n % 4
    with pytest.raises(ValueError):
        stage2d.stage2_fw(x, wt, stage2d.stage2_fw(x, wt)[:6])  # six planes
    outs = list(stage2d.stage2_fw(x, wt))
    outs[1] = torch.zeros((1, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        stage2d.stage2_fw(x, wt, outs)                          # dtype
    y = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError):                             # overlap
        stage2d.stage2_fw(y, wt, (y[:, :4, :4], *level2d.detail_planes(y, 1),
                                  *level2d.detail_planes(y, 2)))
    with pytest.raises(ValueError):
        pyramid2d.dwt2(x, wt, 2, route="fused")
    with pytest.raises(ValueError):
        pyramid2d.idwt2(x, wt, 2, route="stage")


# --- kernel N's strip form: window, shared bytes, staging path, walk -------

def _ana(wt):
    """Smallest analysis offset and span, from the bands."""
    ds, _, dd, _ = level2d.level_bands(wt)
    offs = np.concatenate([ds, dd])
    return int(offs.min()), int(offs.max() - offs.min())


# the strip form's geometry worked out by hand from csrc/stage2d.cu for
# cdf97 (offsets -4 .. 4: lo -4, hi 4) in float32 (V = 4): the LL1 window
# row holds 512 bytes at most, 128 samples, so q2 = (128 + 1 - 4 - 4) / 2
# rounded down to a multiple of 4 = 60, w1 = 2 * 60 - 1 + 8 = 127 rounded
# up to 16 = 128; an x row of 2 * 128 - 1 + 8 = 263 samples staged in 264,
# 66 16-byte words, made odd: 268; rings of 8 + 8 - 1 = 15 and 4 - 1 + 4 +
# 4 = 11 rows; 2 * 15 * 128 + 4 * 128 + 2 * 11 * 60 = 5672 words of 4
# bytes, three stages of 8 rows of 268, the 16 taps' table: 22688 + 25728
# + 128 = 48544 bytes
STRIP_FORMS = [
    ("cdf97", "lifting", 16, (60, 128, 48544), (60, 128, 35872),
     (28, 64, 49024)),
    ("haar", "lifting", 8, (64, 128, 37280), (64, 128, 24608),
     (32, 64, 37296)),
    ("db4", "filter", 16, (56, 128, 56320), (56, 128, 42880),
     (24, 64, 56128)),
    ("sym5", "filter", 0, None, None, None),
    ("coif4", "filter", 0, None, None, None),
    ("db10", "filter", 0, None, None, None)]
DTYPES = (torch.float32, torch.bfloat16, torch.float64)


@pytest.mark.parametrize("dtype_i, dtype", list(enumerate(DTYPES)))
@pytest.mark.parametrize("name, kind, window, f32, bf16, f64", STRIP_FORMS)
def test_strip_window_and_shared_bytes(name, kind, window, f32, bf16, f64,
                                       dtype_i, dtype):
    """Kernel N's form for a wavelet: the strip form's window (8 or 16
    offsets, above the analysis span; kernel A's for the same bands) or 0,
    the first form, for a span of 16 or more, with stage_tile's tile and
    shared bytes; the strip's level-2 columns, LL1 window and shared bytes
    per dtype (well inside the card's 227 KB), and the rings as deep as
    the taps of a step reach."""
    _, wt = _carriers(name, kind)
    dmin, span = _ana(wt)
    x = torch.empty((1, 1024, 1024), dtype=dtype)
    plan = stage2d.stage_plan(x, wt)
    assert stage2d.stage_window(wt) == window == level2d.fw_window(wt)
    assert (span < window) if window else span >= 16
    if not window:
        tile = stage2d.stage_tile(wt, dtype)
        assert plan == (0, tile) + (0,) * 16 + (
            stage2d.smem_bytes(wt, dtype, tile),)
        return
    q2, w1, smem = (f32, bf16, f64)[dtype_i]
    assert (plan.q2, plan.w1, plan.smem) == (q2, w1, smem)
    assert 4 * plan.smem <= level2d.SMEM_LIMIT      # four blocks an SM
    v = 2 if dtype == torch.float64 else 4
    assert plan.w1 % (4 * v) == 0 and plan.q2 % 4 == 0
    assert 2 * plan.q2 - 1 + plan.hi - plan.lov <= plan.w1
    # an LL1 window row of 512 bytes at most, and not with 4 more columns
    acc = 16 // v
    assert plan.w1 * acc <= 512 < (2 * plan.q2 + 7 + plan.hi - plan.lov) * acc
    assert plan.r1 == 8 + span - 1 and plan.r2 == 3 + plan.hi - dmin
    # the staged window holds every tap of the last LL1 column
    assert plan.sh + 2 * (plan.w1 - 1) + span < plan.ps
    assert stage2d.stage_plan(x, wt, strips=False).window == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_strip_staging_path(dtype):
    """The strip form stages by 16-byte words where x's base, strides and
    n are whole words; by 4 bytes otherwise (a view one column in, a row
    stride of an odd count, n = 4 in bfloat16)."""
    _, wt = _carriers("cdf97", "lifting")
    e = 16 // torch.empty((), dtype=dtype).element_size()
    x = torch.zeros((2, 16, 8 * e), dtype=dtype)
    assert stage2d.stage_plan(x, wt).staging == 16
    assert stage2d.stage_plan(x[:, :, 4:4 + 4 * e] if e > 4 else
                              x[:, :, 2:2 + 4 * e], wt).staging == (
        16 if e == 2 else 4)
    odd = torch.zeros((2, 16, 8 * e + 4), dtype=dtype)[:, :, :8 * e]
    assert stage2d.stage_plan(odd, wt).staging == (16 if e <= 4 else 4)
    assert stage2d.stage_plan(torch.zeros((1, 4, 4), dtype=dtype),
                              wt).staging == (4 if e == 8 else 16)
    # the stores: V-element words into planes whose bases and strides allow
    y = torch.zeros((1, 16, 8 * e), dtype=dtype)
    outs = (torch.zeros((1, 4, 2 * e), dtype=dtype),
            *level2d.detail_planes(y, 1), *level2d.detail_planes(y, 2))
    assert stage2d.stage_plan(x[:1], wt, outs).vmask == 0b1111111


def _strip_items(plan, B, m4):
    """The strip walk's work items as csrc/stage2d.cu (StripItem) decodes
    them: (b, strip, r2s, r2e, r20, steps)."""
    for t in range(plan.items):
        b, rem = divmod(t, plan.segs * plan.strips)
        sg, st = divmod(rem, plan.strips)
        r2s = sg * plan.seg
        r2e = min(r2s + plan.seg, m4)
        yield (b, st, r2s, r2e, r2s - 2 * plan.warm,
               plan.warm + -(-(r2e - r2s) // 2))


def emulate_strips(x, wt):
    """numpy emulation of kernel N's strip walk (csrc/stage2d.cu) in
    float64, with the geometry of :func:`stage2d.stage_plan`: each work
    item walks its segment step by step, staging its x rows (the wrap
    applied while staging) into the step's buffer, the row passes into
    rings at the kernel's slots, LL1 rows and level-2 rows from the
    kernel's ring rows (a ring row the walk has not filled is NaN); every
    output write is counted.  Returns the seven planes (NaN where
    unwritten) and their write counts."""
    plan = stage2d.stage_plan(x, wt)
    assert plan.window
    B, m, n = x.shape
    m4, n4, RS, XR = m // 4, n // 4, 2, 8
    dmin, span = _ana(wt)
    ds, cs, dd, cd = level2d.level_bands(wt)
    ks, kd = ds - dmin, dd - dmin
    shapes = [(B, m4, n4)] + [(B, m // 2, n // 2)] * 3 + [(B, m4, n4)] * 3
    outs = [np.full(s, np.nan) for s in shapes]
    writes = [np.zeros(s, np.int32) for s in shapes]
    X = x.double().numpy()
    j, q = np.arange(plan.w1), np.arange(plan.q2)
    for b, st, r2s, r2e, r20, steps in _strip_items(plan, B, m4):
        c2 = st * plan.q2
        cols = (4 * c2 + 2 * plan.lov + dmin - plan.sh + np.arange(plan.ps)) % n
        c1 = 2 * c2 + plan.lov + j                      # LL1 columns
        own_c = (j >= -plan.lov) & (j < 2 * plan.q2 - plan.lov) & (c1 < n // 2)
        cc = c2 + q                                     # level-2 columns
        S1, D1 = np.full((2, plan.r1, plan.w1), np.nan)
        S2, D2 = np.full((2, plan.r2, plan.q2), np.nan)
        h1 = h2 = 0
        for s in range(steps):
            rho = r20 + RS * s
            xr0 = 4 * rho + 2 * plan.hi + dmin + span - 3
            stg = X[b][(xr0 + np.arange(XR)) % m][:, cols]
            idx = plan.sh + 2 * j[:, None]
            assert (idx + span).max() < plan.ps         # inside the stage
            slots = (h1 + np.arange(XR)) % plan.r1
            S1[slots] = (stg[:, idx + ks] * cs).sum(-1)
            D1[slots] = (stg[:, idx + kd] * cd).sum(-1)
            L1 = np.empty((2 * RS, plan.w1))
            for uu in range(2 * RS):
                w = 2 * rho + plan.hi - 1 + uu
                rs_, rd_ = ((h1 + 2 * uu + XR + k) % plan.r1 for k in (ks, kd))
                L1[uu] = cs @ S1[rs_]
                own = own_c & (2 * r2s <= w) & (w < 2 * r2e)
                if not own.any():
                    continue
                for p, (kk, src) in enumerate(((cs, D1[rs_]), (cd, S1[rd_]),
                                               (cd, D1[rd_])), 1):
                    outs[p][b, w, c1[own]] = (kk @ src)[own]
                    writes[p][b, w, c1[own]] += 1
            idx = (dmin - plan.lov) + 2 * q[:, None]
            assert (idx + span).max() < plan.w1         # inside LL1's row
            slots = (h2 + np.arange(2 * RS)) % plan.r2
            S2[slots] = (L1[:, idx + ks] * cs).sum(-1)
            D2[slots] = (L1[:, idx + kd] * cd).sum(-1)
            for v2 in range(RS):
                r2 = rho + v2
                if not r2s <= r2 < r2e:
                    continue
                ok = cc < n4
                rs_, rd_ = ((h2 + 2 * v2 + 2 * RS + k) % plan.r2 for k in (ks, kd))
                for p, (kk, src) in zip((0, 4, 5, 6), (
                        (cs, S2[rs_]), (cs, D2[rs_]), (cd, S2[rd_]),
                        (cd, D2[rd_]))):
                    outs[p][b, r2, cc[ok]] = (kk @ src)[ok]
                    writes[p][b, r2, cc[ok]] += 1
            h1, h2 = (h1 + XR) % plan.r1, (h2 + 2 * RS) % plan.r2
    return outs, writes


def strip_writes(x, wt):
    """The strip walk's writes, counted per item as the kernel's steps make
    them, in factorised form for the largest shapes: an item writes the
    same columns in every row it writes, so a plane's count is the count of
    (image, row, strip) times the strip's column set.  Returns, for level 1
    and level 2, the (B, rows, strips) counts and the (strips, cols) sets."""
    plan = stage2d.stage_plan(x, wt)
    B, m, n = x.shape
    m4, n4 = m // 4, n // 4
    j, q = np.arange(plan.w1), np.arange(plan.q2)
    rows1 = np.zeros((B, m // 2, plan.strips), np.int32)
    rows2 = np.zeros((B, m4, plan.strips), np.int32)
    cols1 = np.zeros((plan.strips, n // 2), np.int32)
    cols2 = np.zeros((plan.strips, n4), np.int32)
    for st in range(plan.strips):
        c1 = 2 * st * plan.q2 + plan.lov + j
        own = (j >= -plan.lov) & (j < 2 * plan.q2 - plan.lov) & (c1 < n // 2)
        cols1[st, c1[own]] += 1
        cc = st * plan.q2 + q
        cols2[st, cc[cc < n4]] += 1
    for b, st, r2s, r2e, r20, steps in _strip_items(plan, B, m4):
        rho = r20 + 2 * np.arange(steps)
        w = (2 * rho[:, None] + plan.hi - 1 + np.arange(4)).ravel()
        np.add.at(rows1, (b, w[(2 * r2s <= w) & (w < 2 * r2e)], st), 1)
        r2 = (rho[:, None] + np.arange(2)).ravel()
        np.add.at(rows2, (b, r2[(r2s <= r2) & (r2 < r2e)], st), 1)
    return (rows1, cols1), (rows2, cols2)


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("db4", "filter")])
@pytest.mark.parametrize("shape", [(1, 96, 160), (2, 36, 20), (1, 4, 4),
                                   (1, 8, 1544)])
def test_strip_walk_equals_plain(shape, name, kind):
    """Kernel N's strip walk, emulated in float64: every output written
    exactly once, from the staged rows and the rings only, equal to the
    plain version: one image, a batch of ragged images, 4 x 4 (every tap
    wraps) and a wide strip row."""
    _, wt = _carriers(name, kind)
    x = torch.from_numpy(np.random.default_rng(98).standard_normal(shape))
    outs, writes = emulate_strips(x, wt)
    for got, want, count in zip(outs, stage2d.stage2_fw_plain(x, wt),
                                writes):
        assert (count == 1).all()
        assert np.abs(got - want.numpy()).max() <= 1e-12 * max(
            1.0, np.abs(want.numpy()).max())


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
@pytest.mark.parametrize("shape", [(1, 16384, 16384), (1, 1000, 1544),
                                   (1, 96, 160), (1, 4, 4)])
def test_strip_walk_writes_each_output_once(shape, name, kind):
    """The strip walk's writes at the main path's 16384^2, the ragged 1000
    x 1544 of chip_smoke's phase 2f, 96 x 160 and 4 x 4: the strips' own
    columns cover each column once, and each (row, strip) is written once,
    so each element of the seven planes is written exactly once; and the
    grid covers the card's 132 SMs wherever the image has that many
    level-2 row pairs of strips."""
    _, wt = _carriers(name, kind)
    x = torch.empty(shape, dtype=torch.float32)
    for rows, cols in strip_writes(x, wt):
        assert (cols.sum(0) == 1).all() and (rows == 1).all()
    plan = stage2d.stage_plan(x, wt)
    assert plan.items >= min(132, shape[1] // 8 * plan.strips)


def test_stage_gate_keeps_its_answers():
    """stage_ok's answers on a grid of shapes, wavelets and dtypes: the
    strip form changes no route (the gate still asks stage_tile, the first
    form's tile, and kernel_levels)."""
    f32, f64, bf16 = torch.float32, torch.float64, torch.bfloat16
    cdf, db4 = (_carriers(*c)[1] for c in WAVELETS)
    batt = T.wavelet(T.wt.batt4)
    got = {(B, m, n, L, w.name, str(dt)[6:]): pyramid2d.stage_ok(
        B, m, n, L, w, dt)
        for B in (1, 2) for m, n in ((256, 512), (512, 512), (1000, 1544),
                                     (16384, 16384), (128, 256), (96, 160))
        for L in (1, 2, 3) for w in (cdf, db4, batt)
        for dt in (f32, f64, bf16)}
    yes = {k for k, v in got.items() if v}
    assert all(k[0] == 1 and k[3] >= 2 and k[4] != batt.name for k in yes)
    assert (1, 16384, 16384, 2, cdf.name, "float32") in yes
    assert (1, 1000, 1544, 3, db4.name, "bfloat16") in yes
    assert (1, 256, 512, 2, cdf.name, "float64") in yes
    assert not any(k[1:3] in ((128, 256), (96, 160)) for k in yes)
    assert len(yes) == 48
