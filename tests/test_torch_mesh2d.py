"""The grid drivers (wavelets_tpu_torch/parallel/mesh2d.py) against the JAX
package's on its virtual CPU devices.

The port runs on a ``Mesh`` of CPU devices shaped (2, 2), (3, 2) and
(2, 3), the JAX package on ``mesh2d.make_mesh2d`` of the same shape:
images sharded P('x', 'y'), volumes P('x', 'y', None), periodic and the
lifting boundaries, and the deep fallback.  float64; tolerance 1e-12 of
the scale.
"""

import numpy as np
import pytest
import torch

import jax
import wavelets_tpu as J
from wavelets_tpu.parallel import mesh2d as JG

from wavelets_tpu_torch import parallel as P
from wavelets_tpu_torch.parallel import mesh2d as G
from wavelets_tpu_torch.wt.convert import from_reference


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _meshes(shape):
    if len(jax.devices()) < shape[0] * shape[1]:
        pytest.skip("needs more virtual devices")
    return (JG.make_mesh2d(shape),
            P.Mesh([["cpu"] * shape[1]] * shape[0], ("x", "y")))


@pytest.mark.parametrize("grid, shape, name, kind, bd, L", [
    ((2, 2), (64, 32), "db2", "filter", "periodic", 3),
    ((3, 2), (96, 32), "cdf97", "lifting", "periodic", 2),
    ((2, 3), (64, 96), "cdf97", "lifting", "zeropad", 2),
    ((2, 2), (64, 64), "haar", "lifting", "symmetric", 2),
    ((2, 2), (64, 64), "db2", "filter", "periodic", 6),
    ((2, 2), (32, 16, 16), "db2", "filter", "periodic", 2),
    ((3, 2), (48, 32, 8), "cdf97", "lifting", "zeropad", 3),
])
def test_grid_matches_jax(grid, shape, name, kind, bd, L):
    jmesh, pmesh = _meshes(grid)
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind, bd)
    wt = from_reference(ref)
    x = np.random.default_rng(66).standard_normal(shape)
    fw, inv = ("dwt2", "idwt2") if len(shape) == 2 else ("dwt3", "idwt3")
    jy = getattr(JG, fw)(x, ref, L, jmesh)
    py = getattr(G, fw)(torch.from_numpy(x), wt, L, pmesh)
    assert py.spec[:2] == ("x", "y")
    _close(py.gather("cpu"), jy)
    px = getattr(G, inv)(py, wt, L, pmesh)
    _close(px.gather("cpu"), getattr(JG, inv)(jy, ref, L, jmesh))
    _close(px.gather("cpu"), x)


def test_grid_entry_checks():
    pmesh = P.Mesh([["cpu"] * 2] * 2, ("x", "y"))
    wt = from_reference(J.wt.wavelet(J.wt.db2))
    with pytest.raises(ValueError):
        G.dwt2(torch.zeros((16, 16, 4)), wt, 2, pmesh)     # rank
    with pytest.raises(ValueError):
        G.dwt2(torch.zeros((24, 24)), wt, 4, pmesh)        # L too large
    with pytest.raises(ValueError):
        G.dwt2(torch.zeros((16, 16)), wt, 2, P.Mesh(["cpu"] * 2, ("x",)))
    xs = G.shard_grid3(torch.zeros((8, 8, 4)), pmesh)
    assert xs.spec == ("x", "y", None) and len(xs.blocks) == 4
