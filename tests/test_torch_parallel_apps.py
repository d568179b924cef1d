"""The distributed application layer (wavelets_tpu_torch/parallel/apps.py)
against the JAX package's on its virtual CPU devices.

Best-basis trees must be identical; noisest, denoise (plain and TI), the
packet transform and the MODWT agree within 1e-12 of the scale in float64
(TI within 1e-10: the spins are summed in another order).  The port runs
on ``Mesh(["cpu"] * k)`` for k = 2, 4 and 6 (not a power of two), the JAX
package on ``parallel.make_mesh(k)``; 2-D inputs also on the (2, 2) grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wavelets_tpu as J
from wavelets_tpu import parallel as JP

import wavelets_tpu_torch as T
from wavelets_tpu_torch import parallel as P
from wavelets_tpu_torch.wt.convert import from_reference


@pytest.fixture(autouse=True)
def _shard_every_level(monkeypatch):
    """Shard every level that can be (the cost model would send these
    small bands to the fallback); both packages read it at call time."""
    monkeypatch.setenv("WAVELETS_TPU_SHARD_TAIL_LEVEL", "99")


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _meshes(k):
    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} virtual devices")
    return JP.make_mesh(k), P.Mesh(["cpu"] * k, ("x",))


def _carriers(name, kind="filter", bd="periodic"):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind, bd)
    return ref, from_reference(ref)


@pytest.mark.parametrize("k, n, name, kind, L", [
    (4, 64, "db2", "filter", None), (2, 128, "cdf97", "lifting", None),
    (4, 128, "db2", "filter", 3), (6, 96, "db2", "filter", None)])
def test_bestbasistree_identical(k, n, name, kind, L):
    """The first case against the JAX package's distributed search; the
    others against its single-device one, which its own tests hold equal
    to the distributed one (each depth's psum compiles a shard_map)."""
    ref, wt = _carriers(name, kind)
    x = np.random.default_rng(91).standard_normal(n)
    if (k, n) == (4, 64):
        jmesh, pmesh = _meshes(k)
        want = JP.bestbasistree(jnp.asarray(x), ref, L=L, mesh=jmesh)
    else:
        pmesh = P.Mesh(["cpu"] * k, ("x",))
        want = J.bestbasistree(jnp.asarray(x), ref, L=L)
    got = P.bestbasistree(torch.from_numpy(x), wt, L=L, mesh=pmesh)
    assert np.array_equal(want, got)


def test_bestbasistree_refuses_non_periodic():
    _, pmesh = _meshes(2)
    _, wt = _carriers("cdf97", "lifting", "zeropad")
    with pytest.raises(NotImplementedError):
        P.bestbasistree(torch.zeros(64), wt, mesh=pmesh)


def _image(n, seed):
    base = J.testfunction(n, "HeaviSine")
    return np.add.outer(base, base) + 0.1 * \
        np.random.default_rng(seed).standard_normal((n, n))


@pytest.mark.parametrize("k", [2, 4])
def test_noisest_and_denoise_match(k):
    jmesh, pmesh = _meshes(k)
    ref, wt = _carriers("db2")
    img = _image(64, 93)
    want = float(JP.noisest(jnp.asarray(img), ref, mesh=jmesh))
    got = float(P.noisest(torch.from_numpy(img), wt, mesh=pmesh))
    assert abs(got - want) <= 1e-12 * abs(want)
    want = JP.denoise(jnp.asarray(img), ref, L=3, mesh=jmesh)
    got = P.denoise(torch.from_numpy(img), wt, L=3, mesh=pmesh)
    _close(got.gather("cpu"), want)


def test_noisest_above_the_cap_subsamples_across_shards(monkeypatch):
    """The MAD sample of a band larger than the cap: the stride subsample,
    gathered from every shard, equals the single-device one."""
    from wavelets_tpu_torch.parallel import apps
    from wavelets_tpu_torch.threshold.denoise import mad_subsampled
    _, pmesh = _meshes(4)
    y = P.shard_rows(torch.from_numpy(
        np.random.default_rng(94).standard_normal((64, 24))), pmesh)
    flat = y.gather("cpu")[16:32].reshape(-1)
    got = apps._band_sample(y, 16, 32, 100, torch.device("cpu"))
    assert torch.equal(got, flat[::-(-flat.numel() // 100)])
    assert float(mad_subsampled(got, 100)) == float(mad_subsampled(flat, 100))


def test_denoise_TI_and_grid_match():
    jmesh, pmesh = _meshes(4)
    ref, wt = _carriers("db2")
    img = _image(32, 95)
    want = JP.denoise(jnp.asarray(img), ref, L=2, TI=True, nspin=2,
                      mesh=jmesh)
    got = P.denoise(torch.from_numpy(img), wt, L=2, TI=True, nspin=2,
                    mesh=pmesh)
    _close(got.gather("cpu"), want, 1e-10)
    from wavelets_tpu.parallel import mesh2d as JG
    gmesh = P.Mesh([["cpu"] * 2] * 2, ("x", "y"))
    want = JP.denoise(jnp.asarray(img), ref, L=2, mesh=JG.make_mesh2d((2, 2)))
    got = P.denoise(torch.from_numpy(img), wt, L=2, mesh=gmesh)
    assert got.spec == ("x", "y")
    _close(got.gather("cpu"), want)


def test_denoise_refusals():
    _, pmesh = _meshes(2)
    _, wt = _carriers("db2")
    with pytest.raises(ValueError):
        P.denoise(torch.zeros((16, 16)), None, TI=True, mesh=pmesh)
    x = torch.from_numpy(_image(16, 99))
    _close(P.denoise(x, None, mesh=pmesh).gather("cpu"), T.denoise(x, None))


@pytest.mark.parametrize("k, tree, bd", [
    (4, ("full", 4), "periodic"), (2, ("dwt", 3), "periodic"),
    (4, ("full", 3), "zeropad"), (6, ("full", 4), "periodic")])
def test_wpt_matches_and_inverts(k, tree, bd):
    """Against the JAX package's sharded wpt; on 6 shards (segments that
    straddle shards) against its single-device wpt, which its sharded one
    cannot run there."""
    ref, wt = _carriers("db2", "filter") if bd == "periodic" else \
        _carriers("cdf97", "lifting", bd)
    n = 384 if k == 6 else 256
    x = np.random.default_rng(97).standard_normal(n)
    t = J.maketree(n, tree[1], tree[0])
    if k == 6:
        pmesh = P.Mesh(["cpu"] * k, ("x",))
        want = J.wpt(jnp.asarray(x), ref, t)
    else:
        jmesh, pmesh = _meshes(k)
        want = JP.wpt(jnp.asarray(x), ref, t, mesh=jmesh)
    got = P.wpt(torch.from_numpy(x), wt, t, mesh=pmesh)
    _close(got.gather("cpu"), want)
    back = P.iwpt(got, wt, t, mesh=pmesh)
    _close(back.gather("cpu"), x)


@pytest.mark.parametrize("frac", ["1.0", "0.1"])
def test_modwt_halo_and_gather(frac, monkeypatch):
    """256 samples over 4 shards (64 each): db4's dilated reach passes 64
    at level 5, so L = 5 takes the ring's rows for levels 1-4 and the
    gathered band for level 5; frac 0.1 gathers from level 2 on."""
    monkeypatch.setenv("WAVELETS_TPU_MODWT_GATHER_FRAC", frac)
    _, pmesh = _meshes(4)
    ref, wt = _carriers("db4")
    x = np.random.default_rng(96).standard_normal(256)
    want = J.modwt(jnp.asarray(x), ref, 5)
    got = P.modwt(torch.from_numpy(x), wt, 5, mesh=pmesh)
    assert got.shape == (256, 6) and got.spec == ("x", None)
    _close(got.gather("cpu"), want)
    _close(P.imodwt(got, wt, mesh=pmesh).gather("cpu"), x)


def test_modwt_matches_jax_parallel_and_validates():
    jmesh, pmesh = _meshes(2)
    ref, wt = _carriers("db2")
    x = np.random.default_rng(98).standard_normal(64)
    want = JP.modwt(jnp.asarray(x), ref, 2, mesh=jmesh)
    got = P.modwt(torch.from_numpy(x), wt, 2, mesh=pmesh)
    _close(got.gather("cpu"), want)
    with pytest.raises(ValueError):
        P.modwt(torch.zeros(256), wt, 9, mesh=pmesh)
    with pytest.raises(ValueError):
        P.modwt(torch.zeros(256), wt, 0, mesh=pmesh)
    one = P.modwt(torch.from_numpy(x), wt, 2, mesh=P.Mesh(["cpu"], "x"))
    _close(one.gather("cpu"), want)


def test_mesh_dwt_routes_by_mesh_rank():
    """A 2-axis mesh takes the grid drivers for images and the ring over
    its first axis for signals."""
    from wavelets_tpu_torch.parallel import apps
    _, wt = _carriers("db2")
    gmesh = P.Mesh([["cpu"] * 2] * 2, ("x", "y"))
    x = torch.from_numpy(np.random.default_rng(71).standard_normal(256))
    y = apps._mesh_dwt(x, wt, 3, gmesh, "x", True)
    assert y.spec == ("x",)
    _close(y.gather("cpu"), T.dwt(x, wt, 3))
    img = torch.from_numpy(np.random.default_rng(72).standard_normal((32, 32)))
    y = apps._mesh_dwt(img, wt, 2, gmesh, "x", True)
    assert y.spec == ("x", "y")
    _close(y.gather("cpu"), T.dwt(img, wt, 2))
