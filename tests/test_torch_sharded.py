"""The ring drivers (wavelets_tpu_torch/parallel/sharded.py) against the JAX
package's on its virtual CPU devices.

The port runs on ``Mesh(["cpu"] * k)``, the JAX package on
``parallel.make_mesh(k)`` of the 8 virtual devices (tests/conftest.py),
for k = 2, 3 and 4: the periodic route (kernels E/F and I/J in halo mode,
their plain versions here), the lifting boundaries zeropad and symmetric
(the torch formulation), the deep fallback and 1-D, 2-D and 3-D.  Inputs
are made with numpy from a seed, in float64; tolerance 1e-12 of the scale.
Shapes are small (the JAX references compile a shard_map per level), so
small that the cost model would send every level to the fallback: the
tests set WAVELETS_TPU_SHARD_TAIL_LEVEL, which both packages read at call
time, to shard every level that can be.
"""

import numpy as np
import pytest
import torch

import jax
import wavelets_tpu as J
from wavelets_tpu import parallel as JP
from wavelets_tpu.parallel import costmodel as JC, sharded as JS

import wavelets_tpu_torch as T
from wavelets_tpu_torch import parallel as P
from wavelets_tpu_torch.parallel import costmodel as TC, mesh, sharded
from wavelets_tpu_torch.wt.convert import from_reference


@pytest.fixture(autouse=True)
def _shard_every_level(monkeypatch):
    monkeypatch.setenv("WAVELETS_TPU_SHARD_TAIL_LEVEL", "99")


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _meshes(k):
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} virtual devices")
    return JP.make_mesh(k), P.Mesh(["cpu"] * k, ("x",))


def _carriers(name, kind, bd="periodic"):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind, bd)
    return ref, from_reference(ref)


_DRIVERS = {1: ("dwt1", "idwt1"), 2: ("dwt2", "idwt2"), 3: ("dwt3", "idwt3")}


def _both(k, shape, name, kind, bd, L, seed=61):
    """Forward and inverse through both packages: (port y, JAX y, port
    round trip, JAX round trip, x)."""
    jmesh, pmesh = _meshes(k)
    ref, wt = _carriers(name, kind, bd)
    x = np.random.default_rng(seed).standard_normal(shape)
    fw, inv = _DRIVERS[len(shape)]
    jy = getattr(JP, fw)(x, ref, L, jmesh)
    jx = getattr(JP, inv)(jy, ref, L, jmesh)
    py = getattr(P, fw)(torch.from_numpy(x), wt, L, pmesh)
    px = getattr(P, inv)(py, wt, L, pmesh)
    return (py.gather("cpu"), np.asarray(jy), px.gather("cpu"),
            np.asarray(jx), x)


@pytest.mark.parametrize("k, shape, name, kind, bd, L", [
    (2, (64, 32), "db2", "filter", "periodic", 3),
    (3, (96, 24), "db4", "filter", "periodic", 3),
    (4, (64, 32), "cdf97", "lifting", "periodic", 3),
    (4, (128, 16), "cdf97", "lifting", "zeropad", 2),
    (3, (96, 16), "haar", "lifting", "symmetric", 2),
    (2, (1024,), "cdf97", "lifting", "periodic", 5),
    (3, (768,), "db2", "lifting", "zeropad", 3),
    (2, (32, 16, 16), "db4", "filter", "periodic", 2),
    (4, (64, 8, 8), "cdf97", "lifting", "symmetric", 1),
])
def test_matches_jax_parallel(k, shape, name, kind, bd, L):
    before = sharded.STATS["sharded_levels"]
    py, jy, px, jx, x = _both(k, shape, name, kind, bd, L)
    assert sharded.STATS["sharded_levels"] == before + 2 * L
    _close(py, jy)
    _close(px, jx)
    _close(px, x)


def test_deep_levels_fall_back_to_the_single_device_route():
    """L = 6 of 64 x 64 over 2 shards: the deep bands are too small to
    shard and take one single-device level each."""
    before = dict(sharded.STATS)
    py, jy, px, jx, x = _both(2, (64, 64), "db2", "filter", "periodic", 6)
    _close(py, jy)
    _close(px, x)
    assert sharded.STATS["fallback_levels"] > before["fallback_levels"]
    assert sharded.STATS["sharded_levels"] > before["sharded_levels"]


def test_tail_switch_override_reroutes_and_matches(monkeypatch):
    """WAVELETS_TPU_SHARD_TAIL_LEVEL, read at call time, sends the levels
    from the switch on to the fallback, with the same result."""
    _, pmesh = _meshes(2)
    wt = T.wavelet(T.wt.ALL_CLASSES["db2"], "lifting")
    x = torch.from_numpy(np.random.default_rng(62).standard_normal((64, 32)))
    want = T.dwt(x, wt, 4)
    monkeypatch.setenv("WAVELETS_TPU_SHARD_TAIL_LEVEL", "2")
    before = dict(sharded.STATS)
    got = P.dwt2(x, wt, 4, pmesh)
    assert sharded.STATS["fallback_levels"] - before["fallback_levels"] == 3
    _close(got.gather("cpu"), want)
    monkeypatch.delenv("WAVELETS_TPU_SHARD_TAIL_LEVEL")
    ref = J.wt.wavelet(J.wt.ALL_CLASSES["db2"], "lifting")
    for shape, nd in (((64, 32), 2), ((16384, 16384), 4), ((1 << 20,), 8)):
        assert sharded.tail_switch_for(shape, torch.float64, wt, nd, 4) == \
            JS.tail_switch_for(shape, np.float64, ref, nd, 4)


@pytest.mark.parametrize("name, kind", [("db4", "lifting"),
                                        ("sym5", "lifting")])
def test_small_shards_of_factored_schemes(name, kind):
    """Factored schemes at 4 rows per shard over 8 shards: the gate sends
    the level to the fallback where one neighbour cannot cover the reach
    (sym5's composed bands reach further than the JAX package's gate)."""
    py, jy, px, jx, x = _both(8, (32, 64), name, kind, "periodic", 1, 31)
    _close(py, jy, 1e-10)
    _close(px, x, 1e-10)


def test_one_shard_mesh_is_the_single_device_route():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(63).standard_normal((32, 32)))
    got = P.dwt2(x, wt, 3, P.Mesh(["cpu"], ("x",)))
    assert torch.equal(got.gather("cpu"), T.dwt(x, wt, 3))
    assert list(got.blocks) == [(0,)]


def test_uneven_rows_take_the_fallback():
    """36 rows over 4 shards: the blocks are 9, 9, 9, 9 rows and no level
    can be cut into even chunks, so every level takes the fallback."""
    wt = T.wavelet(T.wt.db2)
    x = torch.from_numpy(np.random.default_rng(64).standard_normal((36, 8)))
    y = P.dwt2(x, wt, 2, P.Mesh(["cpu"] * 4, ("x",)))
    _close(y.gather("cpu"), T.dwt(x, wt, 2))
    xs = P.shard_rows(x[:34], P.Mesh(["cpu"] * 4, ("x",)))
    assert [b.shape[0] for b in xs.blocks.values()] == [9, 9, 8, 8]


def test_entries_promote_and_validate():
    jmesh, pmesh = _meshes(4)
    ref, wt = _carriers("db2", "filter")
    xi = (np.random.default_rng(11).standard_normal((64, 32)) * 100).astype(
        np.int32)
    got = P.dwt2(torch.from_numpy(xi), wt, 3, pmesh).gather("cpu")
    assert got.dtype == torch.float64
    _close(got, J.dwt(xi, ref, 3))
    with pytest.raises(ValueError):
        P.dwt2(torch.zeros((96, 96)), wt, 6, pmesh)
    with pytest.raises(ValueError):
        P.dwt2(torch.zeros(64), wt, 2, pmesh)
    with pytest.raises(ValueError):
        P.dwt1(torch.zeros((8, 8)), wt, 2, pmesh)


def test_sharded_layout_and_gather():
    pmesh = P.Mesh(["cpu"] * 2, ("x",))
    x = torch.arange(48.0).reshape(8, 6)
    xs = P.shard_rows(x.clone(), pmesh)
    assert xs.spec == ("x", None) and xs.shape == (8, 6)
    assert torch.equal(xs.blocks[(1,)], x[4:])
    assert torch.equal(xs.gather("cpu"), x)
    assert P.shard_rows(xs, pmesh) is xs
    assert torch.equal(xs.fetch((slice(3, 6), slice(1, 3)), "cpu"),
                       x[3:6, 1:3])
    xs.store((2, 2), torch.zeros((4, 2)))
    y = x.clone()
    y[2:6, 2:4] = 0
    assert torch.equal(xs.gather("cpu"), y)


def test_mesh_and_make_mesh():
    m = P.Mesh(["cpu"] * 3, "x")
    assert m.shape == {"x": 3} and m == P.Mesh(["cpu"] * 3, ("x",))
    with pytest.raises(ValueError):
        P.Mesh([["cpu"], ["cpu", "cpu"]], ("x", "y"))
    with pytest.raises(ValueError):
        P.Mesh([], ("x",))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            P.make_mesh()
        with pytest.raises(ValueError):
            P.make_mesh(2)


def test_moves_between_devices_are_copies():
    """On one device a move is the tensor itself; to another device a
    copy, counted."""
    t = torch.zeros(4)
    assert mesh.move(t, "cpu") is t


@pytest.mark.parametrize("sc", ["ici", "dcn"])
def test_cost_model_is_the_jax_packages(sc):
    """The copied model picks the same switch level and projection."""
    jsc, tsc = JC.SCENARIOS[sc], TC.SCENARIOS[sc]
    assert (jsc.alpha_s, jsc.beta_Bps, jsc.hbm_Bps, jsc.passes) == \
        (tsc.alpha_s, tsc.beta_Bps, tsc.hbm_Bps, tsc.passes)
    for m, n, h, nd, L in ((32768, 16384, 4, 2, 8), (64, 64, 7, 4, 6),
                           (1 << 12, 1, 4, 8, 10), (512, 512, 30, 4, 8)):
        assert TC.tail_switch_level(m, n, 4, h, nd, L, tsc) == \
            JC.tail_switch_level(m, n, 4, h, nd, L, jsc)
        assert TC.project(m, n, L, 8, h, nd, tsc) == \
            JC.project(m, n, L, 8, h, nd, jsc)
    levels = [{"t_halo_only_ms": 0.1 * i} for i in range(1, 4)]
    assert TC.fit_alpha_beta(levels, 64, 4, 4) == \
        JC.fit_alpha_beta(levels, 64, 4, 4)
