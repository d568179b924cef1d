"""chip_smoke.py's library yardsticks compute the kernels' functions.

On the card each yardstick (one PyTorch call, timed beside a kernel) is
held against the kernel's plain version within 1e-4; a yardstick that
computes another function fails the whole run there.  Here, on the CPU in
float64, the yardsticks of the inverse 2-D level (a polyphase conv2d), of
the inverse 1-D level (a polyphase conv1d) and of I/J in halo mode are
held against the plain versions within 1e-12 of the scale, for a lifting
and a filter wavelet; and the switch table and launch tables that phase
3g checks on the card are held against the port's routes.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as C
import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import axis0, level1d, level2d, pyramid2d
from wavelets_tpu_torch.transforms import routes2d


def _close(got, want):
    assert torch.allclose(got, want, rtol=0,
                          atol=1e-12 * max(1.0, want.abs().max().item()))


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_inverse_2d_yardstick_is_the_inverse_level(name, kind):
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    x = torch.from_numpy(np.random.default_rng(51).standard_normal(
        (1, 16, 24)))
    quads = level2d.level_fw_plain(x, wt)
    got = C.interleave2d(C.library_inv2d(quads, wt)())
    _close(got, level2d.level_inv_plain(*quads, wt)[0])
    _close(got, x[0])


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_halo_yardsticks_are_the_halo_levels(name, kind):
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    rng = np.random.default_rng(52)
    fa, fb = axis0.halo_reach(wt, False)
    ia, ib = axis0.halo_reach(wt, True)
    x, above, below = (torch.from_numpy(rng.standard_normal((1, r, 5)))
                       for r in (16, fa + 1, fb))
    a, d = axis0.axis0_fw_plain(x, wt, above=above, below=below)
    o = C.library_halo_fw(x, above, below, wt)()
    _close(o[:, 0], a)
    _close(o[:, 1], d)
    halos = tuple(torch.from_numpy(rng.standard_normal((1, r, 5)))
                  for r in (ia, ib, ia, ib + 2))
    want = axis0.axis0_inv_plain(a, d, wt, halos=halos)
    got = C.interleave_rows(C.library_halo_inv(a, d, halos, wt)(),
                            want.shape[1:])
    _close(got, want[0])


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_inverse_1d_polyphase_yardstick_is_the_inverse_level(name, kind):
    """The split route's F yardstick: one conv1d on (s, d) as channels."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    x = torch.from_numpy(np.random.default_rng(53).standard_normal((3, 40)))
    s, d = level1d.level1d_fw_plain(x, wt)
    got = C.interleave1d(C.library_inv1d_polyphase(s, d, wt)())
    _close(got, level1d.level1d_inv_plain(s, d, wt))
    _close(got, x)


@pytest.mark.parametrize("name, switches, routes", C.SWITCH_TABLE)
def test_switch_table_is_the_ports(name, switches, routes, monkeypatch):
    """chip_smoke's switch table is transforms.routes2d's, and ``switched``
    sets exactly its switches for the calls inside and restores the rest."""
    monkeypatch.setenv("WAVELETS_TPU_MXU2D", "0")
    monkeypatch.setenv("WAVELETS_TPU_FUSED2D", "0")
    with C.switched(switches):
        assert routes2d() == routes
        assert {k for k in os.environ if k.startswith("WAVELETS_TPU_")
                and k[13:] in C.SWITCHES} == {
                    "WAVELETS_TPU_" + k for k in switches}
    assert routes2d() == ("split", "split")


@pytest.mark.parametrize("routes", [("level", "level"), ("stage", "level"),
                                    ("split", "split")])
def test_route_launch_table_is_what_the_route_runs(routes):
    """chip_smoke's expected launches per route against the plain versions
    the CPU runs, at 1024 x 512 L5 (levels 1-3 are level launches)."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(54).standard_normal(
        (1, 1024, 512)).astype(np.float32))
    C.reset_counts()
    y = pyramid2d.dwt2(x, wt, 5, route=routes[0])
    pyramid2d.idwt2(y, wt, 5, route=routes[1])
    plain = {k: v for k, v in C.counts()[1].items() if v}
    want = {k: v for k, v in C.route_launches(routes, 1024, 512, 5, wt,
                                              torch.float32).items() if v}
    assert plain == want
