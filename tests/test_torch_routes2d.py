"""The port's 2-D routes against the JAX package's alternative 2-D kernels.

Under its switches the JAX package runs fused2d's single-pass level, which
the port computes with kernels A and B (tests/test_torch_level2d.py holds
them against it), and the row and column kernels of lifting2d.py and
filter2d.py, which the port computes as the split level
(ops/rowcol2d.py: E over the rows and I down the columns, J and F back).
Here the split level's plain version, which a CPU tensor takes, is held
against those TPU kernels in interpret mode, as tests/test_pallas.py runs
them, with the switches set by ``monkeypatch``.
Tolerance 2e-4 relative in float32 (both sides are within 1e-4 of
float64); the port's float64 round trips 1e-12.  Then the public
``dwt``/``idwt`` under each row of the switch table (transforms.routes2d)
against the JAX package's dispatch under the same switches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu import transforms as JT
from wavelets_tpu.ops.pallas import filter2d as JF2, lifting2d as JL2

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import (axis0, level1d, level2d, pyramid2d,
                                    rowcol2d, stage2d, tail2d)
from wavelets_tpu_torch.transforms import routes2d
from wavelets_tpu_torch.wt.convert import from_reference

F32 = 2e-4
SWITCHES = ("MXU2D", "MXU_LS2", "FUSED2D", "FUSED_INV", "PACKED2D",
            "PACKED_DMA")
# the switch table: switches, the port's (forward, inverse) routes
TABLE = [
    ({}, ("level", "level")),
    ({"MXU_LS2": "1"}, ("stage", "level")),
    ({"MXU2D": "0"}, ("level", "split")),
    ({"MXU2D": "0", "PACKED2D": "1"}, ("level", "split")),
    ({"MXU2D": "0", "FUSED2D": "0"}, ("split", "split")),
    ({"MXU2D": "0", "FUSED_INV": "1"}, ("level", "level")),
]
MODULES = (level2d, stage2d, tail2d, level1d, axis0)


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


def _switch(mp, switches):
    for k in SWITCHES:
        mp.delenv("WAVELETS_TPU_" + k, raising=False)
    for k, v in switches.items():
        mp.setenv("WAVELETS_TPU_" + k, v)


def _input(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


def _packed(quads):
    ll, lh, hl, hh = (np.asarray(q) for q in quads)
    return np.block([[ll, lh], [hl, hh]])


@pytest.fixture(scope="module")
def jax_out():
    """The JAX package's outputs, computed once per key and shared:
    ``key = (what, switches, name, kind, shape)``."""
    memo = {}

    def get(key, fn):
        if key not in memo:
            with pytest.MonkeyPatch.context() as mp:
                _switch(mp, dict(key[1]))
                with pltpu.force_tpu_interpret_mode():
                    memo[key] = fn()
        return memo[key]
    return get


# --- the row and column kernels (#11-#16) against the split level ----------

def _jax_split_level(ref, kind, x, fw):
    """One level through lifting2d's or filter2d's row and column kernels
    (MXU2D=0 FUSED2D=0), packed."""
    m, n = x.shape
    if kind == "lifting":
        assert JL2._plan_level(m, n, ref, np.float32) is not None
        return np.asarray(JL2.lifting_level2(jnp.asarray(x), ref, fw))
    assert JF2._plan_level(m, n, len(ref.qmf), np.float32) is not None
    if fw:
        return _packed(JF2._level_fw_quads(jnp.asarray(x), ref))
    mh, nh = m // 2, n // 2
    q = [jnp.asarray(v) for v in (x[:mh, :nh], x[:mh, nh:], x[mh:, :nh],
                                  x[mh:, nh:])]
    return np.asarray(JF2._level_inv_quads(*q, ref))


@pytest.mark.parametrize("shape", [(64, 512), (256, 256)])
@pytest.mark.parametrize("name, kind", [
    ("cdf97", "lifting"), ("db2", "lifting"), ("haar", "lifting"),
    ("db2", "filter"), ("db4", "filter"), ("haar", "filter")])
def test_split_level_matches_row_col_kernels_f32(name, kind, shape,
                                                 jax_out):
    ref, wt = _carriers(name, kind)
    sw = (("MXU2D", "0"), ("FUSED2D", "0"))
    x = _input(shape, 103)
    want = jax_out(("split_fw", sw, name, kind, shape),
                   lambda: _jax_split_level(ref, kind, x, True))
    y = torch.full((1, *shape), float("nan"))
    rowcol2d.rowcol_fw_plain(torch.from_numpy(x)[None], wt, y)
    assert _rel(y[0], want) <= F32
    want_inv = jax_out(("split_inv", sw, name, kind, shape),
                       lambda: _jax_split_level(ref, kind, want, False))
    out = torch.empty((1, *shape))
    rowcol2d.rowcol_inv_plain(torch.from_numpy(want.astype(np.float32))[None],
                              wt, out)
    assert _rel(out[0], want_inv) <= F32
    assert np.abs(out[0].numpy() - x).max() <= F32


def test_split_level_in_place_with_a_batch_and_a_corner():
    """The split level reads a deeper LL in place (a strided batch: E runs
    per image) and writes over it; the inverse reads the LL through J's
    corner.  Against the level kernels' plain versions, f64."""
    wt = T.wavelet(T.wt.db2)
    rng = np.random.default_rng(104)
    y = torch.from_numpy(rng.standard_normal((3, 32, 48)))
    sub = y[:, :16, :24]
    x = sub.clone()
    quads = level2d.level_fw_plain(x, wt)
    rowcol2d.rowcol_fw_plain(sub, wt, sub)
    for g, w in zip((sub[:, :8, :12], *level2d.detail_planes(sub, 1)), quads):
        assert (g - w).abs().max() <= 1e-12
    corner = torch.from_numpy(rng.standard_normal((3, 8, 12)))
    out = torch.empty((3, 16, 24), dtype=torch.float64)
    rowcol2d.rowcol_inv_plain(sub, wt, out, corner=corner)
    want = level2d.level_inv_plain(corner, *level2d.detail_planes(sub, 1), wt)
    assert (out - want).abs().max() <= 1e-12
    with pytest.raises(ValueError):
        rowcol2d.rowcol_fw_plain(x, wt, sub, scratch=torch.empty(3, 16, 23))


# --- the public dwt / idwt under the switch table ---------------------------

@pytest.mark.parametrize("switches, routes", TABLE)
def test_routes2d_reads_the_switches(switches, routes, monkeypatch):
    _switch(monkeypatch, switches)
    assert routes2d() == routes


@pytest.mark.parametrize("switches", [
    {"MXU_LS2": "1", "PACKED2D": "0"}, {"MXU_LS2": "1", "PACKED_DMA": "0"},
    {"MXU_LS2": "1", "MXU2D": "0", "FUSED2D": "0"},
    {"MXU2D": "0", "FUSED2D": "0", "PACKED2D": "1"}])
def test_routes2d_corner_cases(switches, monkeypatch):
    """The stage needs the packed DMA driver; under MXU2D=0 PACKED2D=1
    forces fused2d's packed kernel, A in the port."""
    _switch(monkeypatch, switches)
    fw, _ = routes2d()
    assert fw == ("split" if switches.get("FUSED2D") == "0"
                  and "PACKED2D" not in switches else "level")


def _jax_public(switches, name, kind, x, L, jax_out):
    """The JAX package's 2-D dispatch (transforms._dwt_impl, the body of
    its jitted dwt/idwt, whose cache would keep the first call's route)
    with WAVELETS_TPU_PALLAS=1: forward, then the inverse of the port's
    float32 coefficients' JAX twin."""
    ref, _ = _carriers(name, kind)
    sw = tuple(sorted(switches.items())) + (("PALLAS", "1"),)

    def run():
        y = JT._dwt_impl(jnp.asarray(x), ref, L, 2, True)
        return np.asarray(y), np.asarray(JT._dwt_impl(y, ref, L, 2, False))
    return jax_out(("public", sw, name, kind, x.shape), run)


# every row with cdf97 lifting, the rows that reach the row and column
# kernels with db4 filter too
PUBLIC = [(sw, r, "cdf97", "lifting") for sw, r in TABLE] + \
    [(sw, r, "db4", "filter") for sw, r in TABLE if "split" in r]


@pytest.mark.parametrize("switches, routes, name, kind", PUBLIC)
def test_public_dwt_matches_jax_under_switches(switches, routes, name, kind,
                                               monkeypatch, jax_out):
    ref, wt = _carriers(name, kind)
    L = 3
    x = _input((256, 512), 105)
    y_want, x_want = _jax_public(switches, name, kind, x, L, jax_out)
    _switch(monkeypatch, switches)
    y = T.dwt(torch.from_numpy(x), wt, L)
    assert _rel(y, y_want) <= F32
    xr = T.idwt(torch.from_numpy(y_want.copy()), wt, L)
    assert _rel(xr, x_want) <= F32
    assert np.abs(T.idwt(y, wt, L).numpy() - x).max() <= F32
    # float64 round trip through the same routes
    x64 = torch.from_numpy(x.astype(np.float64))
    assert (T.idwt(T.dwt(x64, wt, L), wt, L) - x64).abs().max() <= 1e-12


def _reset():
    for mod in MODULES:
        for k in mod.PLAIN_CALLS:
            mod.PLAIN_CALLS[k] = 0


def _calls():
    got = {}
    for mod in MODULES:
        got.update({k: v for k, v in mod.PLAIN_CALLS.items() if v})
    return got


# at 1024 x 512, L = 5: levels 1-3 are level launches, levels 4-5 the tail
LAUNCH_TABLES = {
    "level": ({"level_fw": 3, "tail_fw": 1}, {"level_inv": 3, "tail_inv": 1}),
    "stage": ({"stage2_fw": 1, "level_fw": 1, "tail_fw": 1}, None),
    "split": ({"level1d_fw": 3, "axis0_fw": 3, "tail_fw": 1},
              {"tail_inv": 1, "axis0_inv": 3, "level1d_inv": 3}),
}


@pytest.mark.parametrize("switches, routes", TABLE)
def test_public_route_launch_tables(switches, routes, monkeypatch):
    """The plain versions each route runs, counted on the CPU, and every
    route's result equal to the default route's (f64, 1e-12)."""
    _switch(monkeypatch, switches)
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(106).standard_normal(
        (1024, 512)))
    _reset()
    y = T.dwt(x, wt, 5)
    assert _calls() == LAUNCH_TABLES[routes[0]][0]
    _reset()
    xr = T.idwt(y, wt, 5)
    assert _calls() == LAUNCH_TABLES[routes[1]][1]
    ref = pyramid2d.dwt2(x[None], wt, 5)[0]
    assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
    assert (xr - x).abs().max() <= 1e-12


@pytest.mark.parametrize("route", ["stage", "split"])
def test_batched_images_take_the_route(route, monkeypatch):
    """A batch rides the drivers' leading axis: the stage route runs A per
    level for it (N takes one image), the split route E per image below
    level 1; both equal the level route."""
    _switch(monkeypatch, {"MXU_LS2": "1"} if route == "stage" else
            {"MXU2D": "0", "FUSED2D": "0"})
    wt = T.wavelet(T.wt.db4)
    x = torch.from_numpy(np.random.default_rng(107).standard_normal(
        (3, 512, 256)))
    _reset()
    y = T.dwt(x, wt, 4, ndt=2)
    calls = _calls()
    assert "stage2_fw" not in calls
    if route == "split":
        # level 1 reads x as one block of rows, level 2 image by image
        # (levels 3-4 are the tail's)
        assert calls["level1d_fw"] == 1 + 3
    ref = pyramid2d.dwt2(x, wt, 4)
    assert (y - ref).abs().max() <= 1e-12 * ref.abs().max()
    assert (T.idwt(y, wt, 4, ndt=2) - x).abs().max() <= 1e-12
