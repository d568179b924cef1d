"""The launch plans of wavelets_tpu_torch (ops/build.py ``Plan``) on the CPU.

A CPU tensor takes each kernel's plain version, so these tests drive the
plan path with a stand-in for the kernels' library that records each call:
a plan built from one set of tensors and kept under the wrapper's key is
found by the public wrapper for another set of the same signature, and the
arguments it hands the library equal those of a plan built afresh from the
second set.  A changed stride, shape, dtype or level misses; an output
overlapping an input still raises on a hit; the cache is bounded; a plan
holds no tensor of a call; a launch is counted once, in its module's
``LAUNCHES`` as ``build`` registers it.
"""

import ctypes
import gc
import weakref

import pytest
import torch

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import (axis0, build, level1d, level2d, level3d,
                                    modwt1d, stage2d, tail1d, tail2d)
from wavelets_tpu_torch.wt.carriers import OrthoFilter


class _Library:
    """A stand-in for the kernels' library: entry points record their
    arguments and return ``status``."""

    def __init__(self, status=0):
        self.status, self.calls = status, []

    def __getattr__(self, name):
        if name == "wtt_error_string":
            return lambda status: b"a test error"
        return lambda *args: self.calls.append((name, args)) or self.status


@pytest.fixture
def lib(monkeypatch):
    """A fresh, empty plan cache and counter, and the stand-in library;
    the current device is the plans' (None for a CPU tensor) and the raw
    stream 77."""
    stub = _Library()
    monkeypatch.setattr(build, "library", lambda: stub)
    monkeypatch.setattr(build, "_plans", {})
    monkeypatch.setattr(build, "PLANS", {"hits": 0, "misses": 0})
    monkeypatch.setattr(build, "_current_device", lambda: None)
    monkeypatch.setattr(build, "_raw_stream", lambda index: 77)
    return stub


def _fresh(lib, plan, tensors):
    """The arguments a fresh ``plan`` hands the library for ``tensors``."""
    plan.call(tensors, 77)
    return lib.calls.pop()[1]


def _values(args):
    """ctypes arguments as plain values: arrays as lists."""
    out = []
    for a in args:
        if isinstance(a, ctypes.Array):
            out.append(list(a))
        elif isinstance(a, ctypes._SimpleCData):
            out.append(a.value)
        else:
            out.append(a)
    return out


WAVELETS = {
    "cdf97": T.wavelet(T.wt.cdf97, "lifting"),
    "haar": T.wavelet(T.wt.haar),
    "db4": T.wavelet(T.wt.db4),
    "sym5": T.wavelet(T.wt.sym5),
}
# the MODWT takes orthogonal filters only: cdf97's cases run haar's
ORTHO = dict(WAVELETS, cdf97=T.wavelet(T.wt.haar))
# the one-pass 3-D level takes pair-reach wavelets only: haar as a lifting
# scheme (cdf97's and sym5's cases) and as a filter (db4's and haar's)
PAIR = dict.fromkeys(("cdf97", "sym5"), T.wavelet(T.wt.haar, "lifting")) | \
    dict.fromkeys(("db4", "haar"), T.wavelet(T.wt.haar))
DTYPES = (torch.float32, torch.float64, torch.bfloat16)
SHAPES = ((2, 64, 64), (1, 128, 64))      # (B, m, n); 1-D rows (B, m n)


def _t(shape, dtype):
    return torch.randn(shape, dtype=torch.float64).to(dtype)


# Each launch key: make(shape, dtype) -> the call's tensors and levels;
# call(wt, c) runs the public wrapper; key(wt, c) is the wrapper's plan key;
# plan(wt, c) the plan it builds at a miss; tensors(c) the plan's tensors.
def _level_fw(shape, dtype):
    x, y = _t(shape, dtype), _t(shape, dtype)
    B, m, n = shape
    return {"x": x, "outs": (_t((B, m // 2, n // 2), dtype),
                             *level2d.detail_planes(y, 1))}


def _level_inv(shape, dtype):
    B, m, n = shape
    y = _t(shape, dtype)
    return {"quads": (y[:, :m // 2, :n // 2], *level2d.detail_planes(y, 1)),
            "out": _t(shape, dtype)}


def _tail(shape, dtype):
    return {"x": _t(shape, dtype), "out": _t(shape, dtype), "L": 3}


def _stage(shape, dtype):
    B, m, n = shape
    y = _t(shape, dtype)
    return {"x": _t(shape, dtype),
            "outs": (_t((B, m // 4, n // 4), dtype),
                     *level2d.detail_planes(y, 1),
                     *level2d.detail_planes(y, 2))}


def _rows(shape):
    B, m, n = shape
    return B, m * n


def _level1d_fw(shape, dtype):
    B, n = _rows(shape)
    y = _t((B, n), dtype)
    return {"x": _t((B, n), dtype), "s": y[:, :n // 2], "d": y[:, n // 2:]}


def _level1d_inv(shape, dtype):
    B, n = _rows(shape)
    y = _t((B, n), dtype)
    return {"s": y[:, :n // 2], "d": y[:, n // 2:], "out": _t((B, n), dtype)}


def _tail1d(shape, dtype):
    return {"x": _t(_rows(shape), dtype), "out": _t(_rows(shape), dtype),
            "L": 4}


def _axis0_fw(shape, dtype, halo=False):
    B, R, C = shape
    y = _t((B, R, C), dtype)
    c = {"x": _t(shape, dtype), "a": y[:, :R // 2], "d": y[:, R // 2:],
         "above": None, "below": None}
    if halo:
        c["above"], c["below"] = _t((B, 8, C), dtype), _t((B, 8, C), dtype)
    return c


def _axis0_inv(shape, dtype, halo=False, corner=False):
    B, R, C = shape
    y = _t((B, R, C), dtype)
    return {"a": y[:, :R // 2], "d": y[:, R // 2:], "out": _t(shape, dtype),
            "corner": (_t((1, R // 2, C // 2), dtype) if corner else None),
            "halos": (tuple(_t((B, 8, C), dtype) for _ in range(4))
                      if halo else None)}


def _volume(shape):
    """SHAPES as (d, m, n) volumes of an even depth."""
    d, m, n = shape
    return 2 * -(-d // 2), m, n


def _level3(shape, dtype, lll=True):
    d, m, n = shape = _volume(shape)
    return {"x": _t(shape, dtype), "y": _t(shape, dtype),
            "lll": _t((d // 2, m // 2, n // 2), dtype) if lll else None}


def _modwt_levels(shape, dtype):
    B, N = _rows(shape)
    return {"x": _t((B, N), dtype), "out": _t((B, N, 4), dtype), "L": 3}


def _modwt_inv_levels(shape, dtype):
    B, N = _rows(shape)
    return {"xw": _t((B, N, 4), dtype), "out": _t((B, N), dtype)}


def _modwt_k(shape, dtype):
    B, N = _rows(shape)
    y = _t((2, B, N), dtype)
    return {"v": _t((B, N), dtype), "v1": y[0], "w1": y[1], "j": 2}


def _modwt_m(shape, dtype):
    B, N = _rows(shape)
    return {"v1": _t((B, N), dtype), "w1": _t((B, N), dtype),
            "out": _t((B, N), dtype), "j": 2}


SITES = {
    "level_fw": (
        _level_fw, lambda wt, c: level2d.level_fw(c["x"], wt, c["outs"]),
        lambda wt, c: ("level_fw", wt, c["x"], c["outs"]),
        lambda wt, c: level2d._fw_plan(wt, c["x"], c["outs"]),
        lambda c: (c["x"], *c["outs"])),
    "level_inv": (
        _level_inv,
        lambda wt, c: level2d.level_inv(*c["quads"], wt, c["out"]),
        lambda wt, c: ("level_inv", wt, c["quads"], c["out"]),
        lambda wt, c: level2d._inv_plan(wt, c["quads"], c["out"]),
        lambda c: (*c["quads"], c["out"])),
    "tail_fw": (
        _tail, lambda wt, c: tail2d.tail_fw(c["x"], wt, c["L"], c["out"]),
        lambda wt, c: ("tail_fw", wt, c["L"], c["x"], c["out"]),
        lambda wt, c: tail2d._fw_plan(wt, c["L"], c["x"], c["out"]),
        lambda c: (c["x"], c["out"])),
    "tail_inv": (
        _tail, lambda wt, c: tail2d.tail_inv(c["x"], wt, c["L"], c["out"]),
        lambda wt, c: ("tail_inv", wt, c["L"], c["x"], c["out"]),
        lambda wt, c: tail2d._inv_plan(wt, c["L"], c["x"], c["out"]),
        lambda c: (c["x"], c["out"])),
    "stage2_fw": (
        _stage, lambda wt, c: stage2d.stage2_fw(c["x"], wt, c["outs"]),
        lambda wt, c: ("stage2_fw", wt, c["x"], c["outs"]),
        lambda wt, c: stage2d._plan(wt, c["x"], c["outs"]),
        lambda c: (c["x"], *c["outs"])),
    "level1d_fw": (
        _level1d_fw,
        lambda wt, c: level1d.level1d_fw(c["x"], wt, c["s"], c["d"]),
        lambda wt, c: ("level1d_fw", wt, c["x"], c["s"], c["d"]),
        lambda wt, c: level1d._fw_plan(wt, c["x"], c["s"], c["d"]),
        lambda c: (c["x"], c["s"], c["d"])),
    "level1d_inv": (
        _level1d_inv,
        lambda wt, c: level1d.level1d_inv(c["s"], c["d"], wt, c["out"]),
        lambda wt, c: ("level1d_inv", wt, c["s"], c["d"], c["out"]),
        lambda wt, c: level1d._inv_plan(wt, c["s"], c["d"], c["out"]),
        lambda c: (c["s"], c["d"], c["out"])),
    "tail1d_fw": (
        _tail1d,
        lambda wt, c: tail1d.tail1d_fw(c["x"], wt, c["L"], c["out"]),
        lambda wt, c: ("tail1d_fw", wt, c["L"], c["x"], c["out"]),
        lambda wt, c: tail1d._fw_plan(wt, c["L"], c["x"], c["out"]),
        lambda c: (c["x"], c["out"])),
    "tail1d_inv": (
        _tail1d,
        lambda wt, c: tail1d.tail1d_inv(c["x"], wt, c["L"], c["out"]),
        lambda wt, c: ("tail1d_inv", wt, c["L"], c["x"], c["out"]),
        lambda wt, c: tail1d._inv_plan(wt, c["L"], c["x"], c["out"]),
        lambda c: (c["x"], c["out"])),
    "axis0_fw": (
        _axis0_fw, lambda wt, c: axis0.axis0_fw(c["x"], wt, c["a"], c["d"]),
        lambda wt, c: ("axis0_fw", wt, c["x"], c["a"], c["d"], None, None),
        lambda wt, c: axis0._fw_plan(wt, c["x"], c["a"], c["d"], None,
                                     None),
        lambda c: (c["x"], c["a"], c["d"])),
    "axis0_fw_halo": (
        lambda s, dt: _axis0_fw(s, dt, halo=True),
        lambda wt, c: axis0.axis0_fw(c["x"], wt, c["a"], c["d"],
                                     above=c["above"], below=c["below"]),
        lambda wt, c: ("axis0_fw_halo", wt, c["x"], c["a"], c["d"],
                       c["above"], c["below"]),
        lambda wt, c: axis0._fw_plan(wt, c["x"], c["a"], c["d"],
                                     c["above"], c["below"]),
        lambda c: (c["x"], c["a"], c["d"], c["above"], c["below"])),
    "axis0_inv": (
        _axis0_inv,
        lambda wt, c: axis0.axis0_inv(c["a"], c["d"], wt, c["out"]),
        lambda wt, c: ("axis0_inv", wt, c["a"], c["d"], c["out"], None,
                       None),
        lambda wt, c: axis0._inv_plan(wt, c["a"], c["d"], c["out"], None,
                                      None),
        lambda c: (c["a"], c["d"], c["out"])),
    "axis0_inv.corner": (
        lambda s, dt: _axis0_inv(s, dt, corner=True),
        lambda wt, c: axis0.axis0_inv(c["a"], c["d"], wt, c["out"],
                                      c["corner"]),
        lambda wt, c: ("axis0_inv", wt, c["a"], c["d"], c["out"],
                       c["corner"], None),
        lambda wt, c: axis0._inv_plan(wt, c["a"], c["d"], c["out"],
                                      c["corner"], None),
        lambda c: (c["a"], c["d"], c["corner"], c["out"])),
    "axis0_inv_halo": (
        lambda s, dt: _axis0_inv(s, dt, halo=True),
        lambda wt, c: axis0.axis0_inv(c["a"], c["d"], wt, c["out"],
                                      halos=c["halos"]),
        lambda wt, c: ("axis0_inv_halo", wt, c["a"], c["d"], c["out"], None,
                       c["halos"]),
        lambda wt, c: axis0._inv_plan(wt, c["a"], c["d"], c["out"], None,
                                      c["halos"]),
        lambda c: (c["a"], c["d"], *c["halos"], c["out"])),
    "level3_fw": (
        _level3,
        lambda wt, c: level3d.level3_fw(c["x"], wt, c["y"], c["lll"]),
        lambda wt, c: ("level3_fw", wt, c["x"], c["y"], c["lll"]),
        lambda wt, c: level3d._fw_plan(wt, c["x"], c["y"], c["lll"]),
        lambda c: (c["x"], c["y"], c["lll"])),
    "level3_fw.deepest": (
        lambda s, dt: _level3(s, dt, lll=False),
        lambda wt, c: level3d.level3_fw(c["x"], wt, c["y"]),
        lambda wt, c: ("level3_fw", wt, c["x"], c["y"], None),
        lambda wt, c: level3d._fw_plan(wt, c["x"], c["y"], None),
        lambda c: (c["x"], c["y"])),
    "level3_inv": (
        _level3,
        lambda wt, c: level3d.level3_inv(c["y"], wt, c["x"], c["lll"]),
        lambda wt, c: ("level3_inv", wt, c["y"], c["x"], c["lll"]),
        lambda wt, c: level3d._inv_plan(wt, c["y"], c["x"], c["lll"]),
        lambda c: (c["y"], c["lll"], c["x"])),
    "modwt_fw_levels": (
        _modwt_levels,
        lambda wt, c: modwt1d.modwt_fw_levels(c["x"], wt, c["L"], c["out"]),
        lambda wt, c: ("modwt_fw_levels", wt, c["L"], c["x"], c["out"]),
        lambda wt, c: modwt1d._levels_plan(wt, c["L"], c["x"], c["out"]),
        lambda c: (c["x"], c["out"])),
    "modwt_inv_levels": (
        _modwt_inv_levels,
        lambda wt, c: modwt1d.modwt_inv_levels(c["xw"], wt, c["out"]),
        lambda wt, c: ("modwt_inv_levels", wt, c["xw"], c["out"]),
        lambda wt, c: modwt1d._inv_levels_plan(wt, c["xw"], c["out"]),
        lambda c: (c["xw"], c["out"])),
    "modwt_fw": (
        _modwt_k,
        lambda wt, c: modwt1d.modwt_fw(c["v"], wt, c["j"], c["v1"], c["w1"]),
        lambda wt, c: ("modwt_fw", wt, c["j"], c["v"], c["v1"], c["w1"]),
        lambda wt, c: modwt1d._fw_plan(wt, c["j"], c["v"], c["v1"],
                                       c["w1"]),
        lambda c: (c["v"], c["v1"], c["w1"])),
    "modwt_inv": (
        _modwt_m,
        lambda wt, c: modwt1d.modwt_inv(c["v1"], c["w1"], wt, c["j"],
                                        c["out"]),
        lambda wt, c: ("modwt_inv", wt, c["j"], c["v1"], c["w1"], c["out"]),
        lambda wt, c: modwt1d._inv_plan(wt, c["j"], c["v1"], c["w1"],
                                        c["out"]),
        lambda c: (c["v1"], c["w1"], c["out"])),
}


def _wavelet(site, name):
    return (ORTHO if site.startswith("modwt") else
            PAIR if site.startswith("level3") else WAVELETS)[name]


def _stored(site, wt, c):
    """Keep the plan of ``c``'s signature under the wrapper's key, as the
    wrapper's first call on a card does."""
    _, _, key, plan, _ = SITES[site]
    return build.store(build.key(*key(wt, c)), plan(wt, c))


MODULES = (axis0, level1d, level2d, level3d, modwt1d, stage2d, tail1d,
           tail2d)


def test_every_launch_key_has_a_site():
    keys = set()
    for mod in MODULES:
        keys |= set(mod.LAUNCHES)
    assert keys == {s.split(".")[0] for s in SITES}
    assert len(keys) == 19 and len(SITES) == 21


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m.__name__)
def test_a_modules_launch_keys_are_counted_in_build(mod):
    """Each key of the module's ``LAUNCHES`` is registered in
    ``build.COUNTED`` to that very dict, and the registered keys are the
    library's launch entry points."""
    assert mod.LAUNCHES and set(mod.LAUNCHES) == set(mod.PLAIN_CALLS)
    for k in mod.LAUNCHES:
        assert build.COUNTED[k] is mod.LAUNCHES
    entries = {e[4:] for e in build._SIGNATURES if not
               e.startswith("wtt_graph_") and e != "wtt_device_pointers"}
    assert set(build.COUNTED) == entries


@pytest.mark.parametrize("site", sorted(SITES))
def test_a_launch_is_counted_once_where_it_happens(site, lib, monkeypatch):
    """A CPU call raises its key's ``PLAIN_CALLS`` alone; with the plain
    versions switched off, a miss (which builds and keeps the plan) and a
    hit each launch once and raise its ``LAUNCHES`` by one; ``Plan.call``
    alone launches and counts nothing."""
    make, call, _, plan, tensors = SITES[site]
    name, wt = site.split(".")[0], _wavelet(site, "db4")
    mod = next(m for m in MODULES if name in m.LAUNCHES)
    launches, plain = dict(build.COUNTED), dict(mod.PLAIN_CALLS)
    counts = {k: d[k] for k, d in build.COUNTED.items()}

    def rise():
        return {k: d[k] - counts[k] for k, d in build.COUNTED.items()
                if d[k] != counts[k]}
    call(wt, make(SHAPES[0], torch.float32))
    assert rise() == {} and not lib.calls
    assert {k: n - plain[k] for k, n in mod.PLAIN_CALLS.items()
            if n != plain[k]} == {name: 1}
    monkeypatch.setattr(build, "_PLAIN_DEVICE", None)
    for n in (1, 2):
        call(wt, make(SHAPES[0], torch.float32))
        assert rise() == {name: n} and len(lib.calls) == n
    assert build.PLANS == {"hits": 1, "misses": 1}
    c = make(SHAPES[0], torch.float32)
    plan(wt, c).call(tensors(c), 77)
    assert rise() == {name: 2} and len(lib.calls) == 3
    assert build.COUNTED == launches


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(WAVELETS))
@pytest.mark.parametrize("site", sorted(SITES))
def test_a_hit_hands_the_library_a_fresh_plans_arguments(site, name, dtype,
                                                         lib):
    make, call, _, plan, tensors = SITES[site]
    wt = _wavelet(site, name)
    for shape in SHAPES:
        first, second = make(shape, dtype), make(shape, dtype)
        _stored(site, wt, first)
        hits = build.PLANS["hits"]
        lib.calls.clear()
        call(wt, second)
        assert build.PLANS["hits"] == hits + 1
        [(entry, got)] = lib.calls
        want = _fresh(lib, plan(wt, second), tensors(second))
        assert entry == "wtt_" + site.split(".")[0]
        assert _values(got) == _values(want)
        flat = []
        for v in _values(got):
            flat += v if isinstance(v, list) else [v]
        for t in tensors(second):
            assert t.data_ptr() in flat
        assert _values(got)[-1] == 77
        assert not {t.data_ptr() for t in tensors(first)} & set(flat)


def _restrided(t):
    """A view of ``t``'s shape and dtype with other strides."""
    pad = torch.zeros(t.shape[:-1] + (t.shape[-1] + 16,), dtype=t.dtype)
    pad = pad[..., : t.shape[-1]]
    return pad if pad.stride() != t.stride() else pad.contiguous()


def _variants(c):
    """The tensors of ``c``, each replaced once by one of another dtype,
    one of other strides and one of another shape."""
    for k, t in c.items():
        if isinstance(t, torch.Tensor):
            yield k, t.to(torch.float64)
            yield k, _restrided(t)
            yield k, t[:1] if t.shape[0] > 1 else torch.cat([t, t])


@pytest.mark.parametrize("site", sorted(SITES))
def test_another_stride_shape_dtype_or_level_misses(site, lib):
    make, _, key, _, _ = SITES[site]
    wt = _wavelet(site, "db4")
    c = make(SHAPES[0], torch.float32)
    _stored(site, wt, c)
    same = make(SHAPES[0], torch.float32)
    assert build.planned(build.key(*key(wt, same)))
    missed = 0
    for k, v in _variants(c):
        other = build.key(*key(wt, dict(c, **{k: v})))
        assert other is not None and build.planned(other) is None
        missed += 1
    for k in ("L", "j"):
        if k in c:
            assert build.planned(build.key(*key(wt, dict(c, **{k: 1})))) \
                is None
            missed += 1
    assert build.planned(build.key(*key(_wavelet(site, "sym5"), c))) is None
    assert missed >= 3 and build.PLANS == {"hits": 1, "misses": 1}


def test_a_wavelet_or_argument_that_is_no_key_misses(lib):
    x = torch.zeros(1, 8, 8)
    assert build.key("level_fw", WAVELETS["db4"], x, [x, 1]) is None
    assert build.key("level_fw", WAVELETS["db4"], x, 3)[3] == 3
    assert build.planned(("level_fw", {}, 1)) is None
    with pytest.raises(ValueError):     # the wrapper's own check judges it
        level2d.level_fw(x, WAVELETS["db4"], [x, 1, 2, 3])


def _overlapping(site, c):
    """``c`` with an output moved onto an input's memory, the signature
    unchanged."""
    c = dict(c)
    if site == "level_fw":
        c["outs"] = (c["outs"][0], *level2d.detail_planes(c["x"], 1))
    elif site == "level_inv":
        c["out"] = c["quads"][0]._base          # the packed array they view
    elif site == "level1d_fw":
        c["s"] = c["x"][:, : c["s"].shape[1]]
    elif site == "axis0_fw_halo":
        half = c["a"].shape[1]
        c["a"], c["d"] = c["x"][:, :half], c["x"][:, half:]
    elif site == "modwt_inv":
        c["out"] = c["w1"]
    return c


@pytest.mark.parametrize("site", ["level_fw", "level_inv", "level1d_fw",
                                  "axis0_fw_halo", "modwt_inv"])
def test_an_overlap_raises_on_a_signature_that_hit(site, lib):
    make, call, key, _, _ = SITES[site]
    wt = WAVELETS["db4"]
    c = make(SHAPES[0], torch.float32)
    _stored(site, wt, c)
    call(wt, make(SHAPES[0], torch.float32))
    bad = _overlapping(site, make(SHAPES[0], torch.float32))
    assert build.key(*key(wt, bad)) == build.key(*key(wt, c))
    lib.calls.clear()
    with pytest.raises(ValueError, match="an output overlaps an input"):
        call(wt, bad)
    assert lib.calls == [] and build.PLANS["hits"] == 2


@pytest.mark.parametrize("site", ["level_fw", "stage2_fw"])
def test_a_hit_hands_back_the_planes_as_a_miss_does(site, lib):
    make, call, _, _, _ = SITES[site]
    wt = WAVELETS["cdf97"]
    c = make(SHAPES[0], torch.float32)
    miss = call(wt, dict(c, outs=list(c["outs"])))      # the plain version
    _stored(site, wt, c)
    hit = call(wt, dict(c, outs=list(c["outs"])))
    assert type(miss) is type(hit) is tuple and len(lib.calls) == 1
    assert all(a is b for a, b in zip(hit, c["outs"]))


@pytest.mark.parametrize("site", ["tail_fw", "tail_inv", "tail1d_fw"])
def test_a_tail_may_write_its_input_on_a_hit(site, lib):
    make, call, _, _, _ = SITES[site]
    wt = WAVELETS["cdf97"]
    c = make(SHAPES[0], torch.float32)
    _stored(site, wt, c)
    same = make(SHAPES[0], torch.float32)
    same["out"] = same["x"]
    call(wt, same)
    assert len(lib.calls) == 1 and build.PLANS["hits"] == 1


def test_an_oversized_wavelet_raises_before_a_plan_is_kept(lib):
    long = OrthoFilter(tuple([0.05] * 1200), "long")
    c = _level_fw(SHAPES[0], torch.float64)
    key = build.key("level_fw", long, c["x"], c["outs"])
    with pytest.raises(ValueError, match="reach too far"):
        build.store(key, level2d._fw_plan(long, c["x"], c["outs"]))
    with pytest.raises(ValueError, match="reach too far"):
        build.store(key, level2d._inv_plan(
            long, _level_inv(SHAPES[0], torch.float64)["quads"], c["x"]))
    assert build.planned(key) is None
    assert build.PLANS == {"hits": 0, "misses": 0} and not build._plans


def test_plans_count_one_miss_then_hits(lib):
    c = _level_fw(SHAPES[0], torch.float32)
    wt = WAVELETS["cdf97"]
    key = build.key("level_fw", wt, c["x"], c["outs"])
    assert build.planned(key) is None
    build.store(key, level2d._fw_plan(wt, c["x"], c["outs"]))
    for k in range(1, 6):
        level2d.level_fw(c["x"], wt, c["outs"])
        assert build.PLANS == {"hits": k, "misses": 1}
    assert len(lib.calls) == 5


def test_the_cache_keeps_at_most_its_bound_least_recent_out(lib):
    c = _tail(SHAPES[0], torch.float32)
    wt = WAVELETS["haar"]
    keys = [("k", n) for n in range(build.PLAN_LIMIT + 10)]
    for n, key in enumerate(keys):
        build.store(key, tail2d._fw_plan(wt, 3, c["x"], c["out"]))
        if n == build.PLAN_LIMIT - 1:
            assert build.planned(keys[0])     # the first, used again
    assert len(build._plans) == build.PLAN_LIMIT <= 1024
    assert build.planned(keys[0]) is not None
    assert all(build.planned(k) is None for k in keys[1:11])
    assert all(build.planned(k) is not None for k in keys[11:])
    assert build.PLANS["misses"] == len(keys)


def test_a_plan_holds_no_tensor_of_its_call(lib):
    c = _level_fw(SHAPES[0], torch.float32)
    wt = WAVELETS["cdf97"]
    plan = _stored("level_fw", wt, c)
    refs = [weakref.ref(t) for t in (c["x"], *c["outs"])]
    del c
    gc.collect()
    assert all(r() is None for r in refs)
    assert plan.keep.offs.numel()                 # the band table it keeps


def test_an_error_status_raises_from_a_hit(lib):
    c = _level_fw(SHAPES[0], torch.float32)
    wt = WAVELETS["cdf97"]
    _stored("level_fw", wt, c)
    lib.status = 7
    with pytest.raises(RuntimeError, match="level_fw: CUDA error 7"):
        level2d.level_fw(c["x"], wt, c["outs"])


# site -> the wrapper's key and call with its outputs left to it, and
# where its outputs go in the site's tensors
UNGIVEN = {
    "level_fw": (lambda wt, c: ("level_fw", wt, c["x"], None),
                 lambda wt, c: level2d.level_fw(c["x"], wt),
                 lambda got: {"outs": got}),
    "level_inv": (lambda wt, c: ("level_inv", wt, c["quads"], None),
                  lambda wt, c: level2d.level_inv(*c["quads"], wt),
                  lambda got: {"out": got}),
    "tail1d_fw": (lambda wt, c: ("tail1d_fw", wt, c["L"], c["x"], None),
                  lambda wt, c: tail1d.tail1d_fw(c["x"], wt, c["L"]),
                  lambda got: {"out": got}),
    "axis0_fw": (lambda wt, c: ("axis0_fw", wt, c["x"], None, None, None,
                                None),
                 lambda wt, c: axis0.axis0_fw(c["x"], wt),
                 lambda got: {"a": got[0], "d": got[1]}),
    "modwt_fw": (lambda wt, c: ("modwt_fw", wt, c["j"], c["v"], None, None),
                 lambda wt, c: modwt1d.modwt_fw(c["v"], wt, c["j"]),
                 lambda got: {"v1": got[0], "w1": got[1]}),
    "modwt_inv_levels": (
        lambda wt, c: ("modwt_inv_levels", wt, c["xw"], None),
        lambda wt, c: modwt1d.modwt_inv_levels(c["xw"], wt),
        lambda got: {"out": got}),
}


@pytest.mark.parametrize("site", sorted(UNGIVEN))
def test_a_hit_allocates_the_outputs_it_was_not_given(site, lib):
    """The first call (here the plain version) allocates the outputs the
    miss builds its plan from; a hit allocates its own alike and hands
    the library a fresh plan's arguments for them."""
    make, _, _, plan, tensors = SITES[site]
    key, call, put = UNGIVEN[site]
    wt = _wavelet(site, "db4")
    c = make(SHAPES[0], torch.float32)
    first = dict(c, **put(call(wt, c)))
    build.store(build.key(*key(wt, c)), plan(wt, first))
    second = dict(c, **put(call(wt, c)))
    [(_, got)] = lib.calls
    want = _fresh(lib, plan(wt, second), tensors(second))
    assert _values(got) == _values(want)
    assert build.PLANS["hits"] == 1
