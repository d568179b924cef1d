"""The one-pass 3-D level (ops/level3d.py, csrc/level3d.cu) and the 3-D
driver's route through it (ops/dwt3d.py), on the CPU.

A wavelet whose bands reach only inside the sample pair (haar, as a filter
and as a lifting scheme) runs one launch a level; every other wavelet keeps
the two launches of A+I / J+B.  The plain versions equal the plain chain
bit for bit in float64 and float32.  A numpy emulation of the kernels'
walk (their work items, their choice of the 16- or 4-byte path, the words
each thread reads and writes) runs over the views the driver hands them,
meta tensors at 512^3, and finds every output element written once and
every input element read once.  The public ``dwt``/``idwt`` stay within
1e-12 of the JAX package in float64.
"""

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import wavelets_tpu as J

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import axis0, build, dwt3d, level2d, level3d, \
    scratch
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
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind, "periodic")
    return ref, from_reference(ref)


HAAR = [("haar", "lifting"), ("haar", "filter")]
DTYPES = (torch.float64, torch.float32, torch.bfloat16)


def _x(shape, dtype, seed=71):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape)).to(dtype)


def _bits(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


# --- routing -----------------------------------------------------------------

def _calls():
    return {**level2d.PLAIN_CALLS, **axis0.PLAIN_CALLS,
            **level3d.PLAIN_CALLS}


def _rise(before):
    return {k: v - before[k] for k, v in _calls().items() if v != before[k]}


@pytest.mark.parametrize("name, kind", HAAR)
@pytest.mark.parametrize("L", [1, 2, 3])
def test_haar_takes_one_launch_a_level(name, kind, L):
    _, wt = _carriers(name, kind)
    assert level3d.pair_reach(wt)
    x = _x((16, 8, 32), torch.float32)
    before = _calls()
    y = T.dwt(x, wt, L)
    assert _rise(before) == {"level3_fw": L}
    before = _calls()
    T.idwt(y, wt, L)
    assert _rise(before) == {"level3_inv": L}


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db2", "filter"), ("db2", "lifting"),
                                        ("db4", "filter")])
def test_wider_wavelets_keep_the_two_launches(name, kind):
    _, wt = _carriers(name, kind)
    assert not level3d.pair_reach(wt)
    x = _x((8, 16, 8), torch.float32)
    before = _calls()
    y = T.dwt(x, wt, 2)
    assert _rise(before) == {"level_fw": 2, "axis0_fw": 2}
    before = _calls()
    T.idwt(y, wt, 2)
    assert _rise(before) == {"level_inv": 2, "axis0_inv": 2}


def test_a_batch_of_volumes_runs_each_volume_one_pass():
    _, wt = _carriers("haar", "lifting")
    x = _x((3, 8, 8, 16), torch.float64)
    before = _calls()
    y = T.dwt(x, wt, 2, ndt=3)
    assert _rise(before) == {"level3_fw": 6}
    back = T.idwt(y, wt, 2, ndt=3)
    assert (back - x).abs().max() <= 1e-12


def test_a_wider_wavelet_is_refused_by_the_level():
    _, wt = _carriers("db2", "filter")
    x = _x((4, 4, 4), torch.float32)
    with pytest.raises(ValueError, match="sample pair"):
        level3d.level3_fw(x, wt)
    with pytest.raises(ValueError, match="sample pair"):
        level3d.level3_inv(x, wt)


# --- plain versions ----------------------------------------------------------

SHAPES = [((2, 2, 2), 1), ((8, 16, 8), 3), ((16, 8, 64), 3), ((4, 8, 16), 2)]


@pytest.mark.parametrize("name, kind", HAAR)
@pytest.mark.parametrize("shape, L", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_equals_the_plain_chain(name, kind, shape, L, dtype):
    """Bit for bit in float64 and float32; in bfloat16 within 2^-7 of the
    largest coefficient (the kernels' bf16 tolerance), and no further from
    the float64 transform than the chain, which rounds twice a level."""
    _, wt = _carriers(name, kind)
    x = _x(shape, dtype)
    y = dwt3d.one_pass_fw(x, wt, L, plain=True)
    yc = dwt3d.chain_fw(x, wt, L, plain=True)
    back = dwt3d.one_pass_inv(yc, wt, L, plain=True)
    backc = dwt3d.chain_inv(yc, wt, L, plain=True)
    if dtype != torch.bfloat16:
        assert _bits(y, yc) and _bits(back, backc)
        return
    scale = yc.double().abs().max()
    assert (y.double() - yc.double()).abs().max() <= 2 ** -7 * scale
    assert (back.double() - backc.double()).abs().max() <= 2 ** -7 * scale
    ref = dwt3d.chain_fw(x.double(), wt, L, plain=True)
    refi = dwt3d.chain_inv(yc.double(), wt, L, plain=True)
    assert (y.double() - ref).abs().max() <= (yc.double() - ref).abs().max()
    assert (back.double() - refi).abs().max() <= \
        (backc.double() - refi).abs().max()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plain_level_into_strided_octants(dtype):
    """The packed array and the scaling octant may be any views with unit
    column stride, larger than the level: a level into views one element
    into NaN-filled arrays writes every element of the level's sub-cube
    and no other, and the inverse reads them back."""
    _, wt = _carriers("haar", "lifting")
    x = _x((8, 8, 32), dtype)
    big = torch.full((11, 10, 42), float("nan"), dtype=dtype)
    y, lll = big[1:, 1:, 1:], torch.full((5, 5, 17), float("nan"),
                                         dtype=dtype)[1:, 1:, 1:]
    level3d.level3_fw(x, wt, y, lll)
    want = level3d.level3_fw_plain(x, wt)
    for o, w in zip(level3d.octants(y[:8, :8, :32], lll),
                    level3d.octants(want)):
        assert _bits(o, w)
    assert y[8:].isnan().all() and y[:, 8:].isnan().all()
    assert y[:, :, 32:].isnan().all() and y[:4, :4, :16].isnan().all()
    out = torch.full((10, 8, 32), float("nan"), dtype=dtype)[1:9]
    level3d.level3_inv(y, wt, out, lll)
    assert not out.isnan().any()
    tol = 2 ** -6 if dtype == torch.bfloat16 else 1e-6
    assert (out.double() - x.double()).abs().max() <= tol * 4


# --- the kernels' walk, emulated ---------------------------------------------

THREADS, BLOCKS = 256, 264       # csrc/level3d.cu L3_THREADS; 132 SMs x 2


def _view(t):
    """(base, element offset, shape, strides) of a (d, m, n) view."""
    base = t._base if t._base is not None else t
    return id(base), t.storage_offset(), tuple(t.shape), tuple(t.stride())


def _words(v, e):
    """l3_words: base and strides whole 16-byte words (a base tensor's
    data 16-byte aligned, as the CPU and CUDA allocators give it)."""
    _, off, _, (sd, sr, _) = v
    return off % e == 0 and sd % e == 0 and sr % e == 0


def _walk(dh, mh, nh, vec, e):
    """The work items the persistent blocks visit (each thread t, t +
    stride, ...), as (k, i, first column, columns a thread takes):
    ``l3_item``; checked to visit every (row, group) once."""
    per = e if vec else 1
    groups = nh // per
    items = dh * mh * groups
    work = -(-items // THREADS)
    grid = min(BLOCKS, work)
    stride = grid * THREADS
    t = (np.arange(grid * THREADS)[None, :]
         + stride * np.arange(-(-items // stride))[:, None]).ravel()
    t = t[t < items]
    assert np.bincount(t, minlength=items).max() == 1 and t.size == items
    r = t // groups
    return r // mh, r % mh, (t - r * groups) * per, per


def _rows(v, rows):
    """The element segments (base, start, length) of rows ``(k, i)`` of
    the view ``v``, each its full width."""
    base, off, (_, _, n), (sd, sr, _) = v
    k, i = rows
    return base, off + k * sd + i * sr, n


def _check_walk(dh, mh, nh, vec, e):
    """The items of a row cover its columns once: first columns 0, per,
    2 per, ... below nh, each row (k, i) ``nh / per`` times."""
    k, i, c0, per = _walk(dh, mh, nh, vec, e)
    cols = np.bincount((k * mh + i) * nh + c0, minlength=dh * mh * nh)
    want = np.zeros(nh, np.int64)
    want[::per] = 1
    assert (cols.reshape(dh * mh, nh) == want).all()


def _tile(segments, size):
    """The segments (start, length) of one base tile [0, size) once."""
    starts = np.concatenate([s for s, _ in segments])
    lens = np.concatenate([np.full(s.size, n) for s, n in segments])
    order = np.argsort(starts, kind="stable")
    starts, lens = starts[order], lens[order]
    assert starts[0] == 0 and starts[-1] + lens[-1] == size
    assert (starts[1:] == starts[:-1] + lens[:-1]).all()


def _record(monkeypatch, call=True):
    """Replace the driver's one-pass launches by recorders of the octant
    views each launch reads or writes (csrc/level3d.cu octants_of; and,
    with ``call``, make the launch)."""
    launches = []

    def fw(x, wt, y, lll):
        launches.append(("fw", x, level3d.octants(y[tuple(
            slice(s) for s in x.shape)], lll)))
        return level3d.level3_fw(x, wt, y, lll) if call else y

    def inv(y, wt, out, lll):
        launches.append(("inv", level3d.octants(y[tuple(
            slice(s) for s in out.shape)], lll), out))
        return level3d.level3_inv(y, wt, out, lll) if call else out

    monkeypatch.setattr(dwt3d, "_ONE_PASS", (fw, inv))
    return launches


def _emulate(launches, y, out, e, y_in=None):
    """Run the emulation over a forward's and an inverse's launches:
    each launch's path, every element of its views read or written once,
    the forward's packed output ``y`` tiled by its octants, the inverse's
    detail octants read from its input ``y_in`` (default ``y``), and each
    level's scaling octant the view the next launch reads."""
    fw = [r for r in launches if r[0] == "fw"]
    inv = [r for r in launches if r[0] == "inv"]
    ybase = id(y)
    written = []
    paths = []
    for n, (_, x, octs) in enumerate(fw):
        xv, ov = _view(x), [_view(o) for o in octs]
        dh, mh, nh = ov[0][2]
        vec = nh % e == 0 and _words(xv, e)
        paths.append((vec, [_words(o, e) for o in ov]))
        _check_walk(dh, mh, nh, vec, e)
        # a thread reads columns 2 c0 .. 2 (c0 + per) - 1 of the input
        # rows 2k + a, 2i + b: every element of the input once
        assert xv[2] == (2 * dh, 2 * mh, 2 * nh)
        kk, ii = np.divmod(np.arange(dh * mh), mh)
        for o in ov:
            base, start, width = _rows(o, (kk, ii))
            assert width == nh
            if base == ybase:
                written.append((start, nh))
        if n + 1 < len(fw):      # the next level reads this level's LLL
            assert _view(fw[n + 1][1]) == ov[0] and ov[0][0] != ybase
        else:
            assert ov[0][0] == ybase
    _tile(written, y.numel())
    ybase = _view(y if y_in is None else y_in)[0]
    for n, (_, octs, o) in enumerate(inv):
        ov, xv = [_view(t) for t in octs], _view(o)
        dh, mh, nh = ov[0][2]
        vec = nh % e == 0 and all(_words(v, e) for v in ov)
        _check_walk(dh, mh, nh, vec, e)
        assert all(v[0] == ybase for v in ov[1:])
        if n:                    # the scaling octant: the deeper result
            assert ov[0] == _view(inv[n - 1][2]) and ov[0][0] != ybase
        else:
            assert ov[0][0] == ybase
        base, off, shape, (sd, sr, _) = xv
        kk, ii = np.divmod(np.arange(shape[0] * shape[1]), shape[1])
        _tile([(off + kk * sd + ii * sr - off, shape[2])],
              shape[0] * shape[1] * shape[2])
    assert _view(inv[-1][2])[0] == id(out)
    return paths


def _meta_run(monkeypatch, shape, dtype, L, wt):
    launches = _record(monkeypatch, call=False)
    x = torch.empty(shape, dtype=dtype, device="meta")
    y = dwt3d.dwt3(x, wt, L)
    out = dwt3d.idwt3(y, wt, L)
    return launches, y, out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_emulated_walk_at_512_cubed(dtype, monkeypatch):
    """The benchmark's volume, 512^3 L3: one launch a level each way, all
    on the 16-byte path with word stores into every octant; each element
    of y written once by the forward, each level's output once by the
    inverse, whose deeper levels read the scaling octant from the
    previous level's result."""
    _, wt = _carriers("haar", "lifting")
    launches, y, out = _meta_run(monkeypatch, (512,) * 3, dtype, 3, wt)
    assert [r[0] for r in launches] == ["fw"] * 3 + ["inv"] * 3
    e = 16 // y.element_size()
    paths = _emulate(launches, y, out, e)
    assert paths == [(True, [True] * 8)] * 3


@pytest.mark.parametrize("shape, L, want", [
    ((8, 16, 8), 3, {torch.float64: [True, True, False],
                     torch.float32: [True, False, False],
                     torch.bfloat16: [False, False, False]}),
    ((2, 2, 2), 1, {dt: [False] for dt in DTYPES}),
    ((16, 8, 64), 3, {torch.float64: [True] * 3, torch.float32: [True] * 3,
                      torch.bfloat16: [True, True, True]}),
])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_emulated_walk_small_and_deep_levels(shape, L, want, dtype,
                                             monkeypatch):
    """Levels whose octant rows are no whole 16-byte words take the
    element path; the walk covers them all the same."""
    _, wt = _carriers("haar", "filter")
    launches, y, out = _meta_run(monkeypatch, shape, dtype, L, wt)
    paths = _emulate(launches, y, out, 16 // y.element_size())
    assert [p[0] for p in paths] == want[dtype]


def test_emulated_walk_over_a_batch_of_volumes(monkeypatch):
    """A batch runs each volume through the driver: per volume, the
    forward's launches tile its packed output, and the inverse's read the
    volume's part of the batch."""
    _, wt = _carriers("haar", "lifting")
    launches = _record(monkeypatch)
    x = _x((2, 16, 8, 32), torch.float32)
    y = T.dwt(x, wt, 2, ndt=3)
    back = T.idwt(y, wt, 2, ndt=3)
    assert [r[0] for r in launches] == ["fw"] * 4 + ["inv"] * 4
    fw, inv = launches[:4], launches[4:]
    for v in range(2):
        yv = fw[2 * v + 1][2][1]._base      # the volume's packed output
        assert tuple(yv.shape) == (16, 8, 32)
        _emulate(fw[2 * v: 2 * v + 2] + inv[2 * v: 2 * v + 2], yv,
                 inv[2 * v + 1][2], 4, y_in=y.reshape(-1, 16, 8, 32)[v])
    assert (back - x).abs().max() <= 1e-5


# --- buffers -----------------------------------------------------------------

@pytest.mark.parametrize("L", [1, 2, 3])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_no_launch_reads_what_it_writes(L, dtype, monkeypatch):
    """Each launch's inputs and outputs are apart (byte extents), its
    inputs are unchanged by it, and the scratch grows by the predicted
    bytes: one eighth of the volume from L = 2, one sixty-fourth more
    from L = 3, in each direction."""
    _, wt = _carriers("haar", "lifting")
    seen = []

    def fw(x, wt, y, lll):
        x0 = x.clone()
        level3d.level3_fw(x, wt, y, lll)
        seen.append(([x], [t for t in (y, lll) if t is not None]))
        assert _bits(x, x0)
        return y

    def inv(y, wt, out, lll):
        ins = [t for t in (y, lll) if t is not None]
        before = [t.clone() for t in ins]
        level3d.level3_inv(y, wt, out, lll)
        seen.append((ins, [out]))
        assert all(_bits(t, b) for t, b in zip(ins, before))
        return out

    monkeypatch.setattr(dwt3d, "_ONE_PASS", (fw, inv))
    x = _x((16, 16, 32), dtype)
    size = x.numel() * x.element_size()
    want = (0, size // 8, size // 8 + size // 64)[L - 1]
    start = scratch.ALLOCATED["bytes"]
    y = dwt3d.dwt3(x, wt, L)
    assert scratch.ALLOCATED["bytes"] - start == want
    start = scratch.ALLOCATED["bytes"]
    dwt3d.idwt3(y, wt, L)
    assert scratch.ALLOCATED["bytes"] - start == want
    assert len(seen) == 2 * L
    for ins, outs in seen:
        for i in ins:
            bi, si = build.extent(i)
            for o in outs:
                bo, so = build.extent(o)
                assert bi + si <= bo or bo + so <= bi


def test_an_output_over_an_input_is_refused():
    _, wt = _carriers("haar", "lifting")
    x = _x((8, 8, 8), torch.float32)
    with pytest.raises(ValueError, match="overlaps"):
        level3d.level3_fw(x, wt, x)
    with pytest.raises(ValueError, match="overlaps"):
        level3d.level3_fw(x, wt, None, x[:4, :4, :4])


# --- round trip against the JAX package -------------------------------------

@pytest.mark.parametrize("name, kind", HAAR)
@pytest.mark.parametrize("shape, L", SHAPES + [((16, 16, 16), 4)])
def test_dwt_idwt_match_the_jax_package(name, kind, shape, L):
    """Within 1e-12 x max(1, max|ref|) in float64, as the chain is held
    (tests/test_torch_dwt3d.py)."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(72).standard_normal(shape)
    want = np.asarray(J.dwt(x, ref, L))
    got = T.dwt(torch.from_numpy(x), wt, L).numpy()
    tol = 1e-12 * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= tol
    back = T.idwt(torch.from_numpy(got), wt, L).numpy()
    assert np.abs(back - np.asarray(J.idwt(want, ref, L))).max() <= tol
    assert np.abs(back - x).max() <= 1e-12 * max(1.0, np.abs(x).max())
