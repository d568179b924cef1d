"""chip_smoke.py's library yardsticks compute the kernels' functions.

On the card each yardstick (one PyTorch call, timed beside a kernel) is
held against the kernel's plain version within 1e-4; a yardstick that
computes another function fails the whole run there.  Here, on the CPU in
float64, the yardsticks of the inverse 2-D level (a polyphase conv2d) and
of I/J in halo mode are held against the plain versions within 1e-12 of
the scale, for a lifting and a filter wavelet.
"""

import numpy as np
import pytest
import torch

import chip_smoke as C
import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import axis0, level2d


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
