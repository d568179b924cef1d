"""The halo mode of the axis-0 level (ops/axis0.py, kernels I and J)
against the JAX package.

The plain versions, which a CPU tensor takes, are held in float32 against
the TPU kernels that the halo mode replaces, ``axis0_level_fw_ext`` /
``axis0_level_inv_ext``, run in interpret mode as tests/test_pallas.py
runs them: with the wrapped rows as halos and with random halos.  The
TPU kernels take halos of ``_halo_of(wt)`` rows (a sublane granule);
the port takes any height that covers the bands' reach, so the TPU's
halos go in as they are.  The sharding gate is checked over every
wavelet.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py (phase 2e).

Tolerances: float32 against an interpret-mode kernel 1e-4 (the MXU bodies
emulate f32 dots in three bf16 passes); the halo mode with wrapped halos
equals the periodic level bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import axis0 as JA
from wavelets_tpu.parallel import sharded as JS

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import axis0
from wavelets_tpu_torch.parallel import sharded
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


def _t(a):
    """(R, C) numpy -> (1, R, C) tensor."""
    return torch.from_numpy(np.ascontiguousarray(a))[None]


@pytest.mark.parametrize("halos", ["wrapped", "random"])
@pytest.mark.parametrize("name, kind", [("db2", "filter"),
                                        ("cdf97", "lifting")])
def test_plain_matches_ext_halo_kernels_f32(name, kind, halos):
    """#26-#29 at (128, 512): the forward with (above, below) and the
    inverse with the four halo blocks, in interpret mode."""
    ref, wt = _carriers(name, kind)
    rng = np.random.default_rng(81)
    x = rng.standard_normal((128, 512)).astype(np.float32)
    h = JA._halo_of(ref)
    if halos == "wrapped":
        above, below = x[-h:], x[:h]
    else:
        above, below = rng.standard_normal((2, h, 512)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JA.axis0_level_fw_ext(
            jnp.asarray(above), jnp.asarray(x), jnp.asarray(below), ref))
    a, d = axis0.axis0_fw_plain(_t(x), wt, above=_t(above), below=_t(below))
    got = torch.cat([a[0], d[0]]).numpy()
    assert np.abs(got - want).max() < 1e-4
    ah = [want[:64][-h:], want[:64][:h]]
    dh = [want[64:][-h:], want[64:][:h]]
    if halos == "random":
        ah = list(rng.standard_normal((2, h, 512)).astype(np.float32))
        dh = list(rng.standard_normal((2, h, 512)).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        want_inv = np.asarray(JA.axis0_level_inv_ext(
            tuple(map(jnp.asarray, ah)), jnp.asarray(want[:64]),
            tuple(map(jnp.asarray, dh)), jnp.asarray(want[64:]), ref))
    got_inv = axis0.axis0_inv_plain(
        _t(want[:64]), _t(want[64:]), wt,
        halos=(_t(ah[0]), _t(ah[1]), _t(dh[0]), _t(dh[1])))[0].numpy()
    assert np.abs(got_inv - want_inv).max() < 1e-4
    if halos == "wrapped":
        assert np.abs(got_inv - x).max() < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("db4", "filter"),
                                        ("sym5", "filter")])
def test_wrapped_halos_equal_the_periodic_level(name, kind, dtype):
    """Halos equal to the wrapped rows give the periodic level bit for bit,
    on strided views, with R = 2H (H the reach), forward and inverse."""
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    fa, fb = axis0.halo_reach(wt, False)
    ia, ib = axis0.halo_reach(wt, True)
    R = 2 * max(fa, fb, 2 * ia, 2 * ib, 1)
    base = torch.from_numpy(np.random.default_rng(82).standard_normal(
        (3, R + 3, 12))).to(dtype)
    x = base[:, 1:R + 1, 2:9]
    a, d = axis0.axis0_fw(x, wt)
    ah, dh = axis0.axis0_fw(x, wt, above=x[:, R - fa:], below=x[:, :fb])
    assert torch.equal(a, ah) and torch.equal(d, dh)
    Rh = R // 2
    back = axis0.axis0_inv(a, d, wt, halos=(a[:, Rh - ia:], a[:, :ib],
                                            d[:, Rh - ia:], d[:, :ib]))
    assert torch.equal(back, axis0.axis0_inv(a, d, wt))


def test_halo_plain_is_the_level_of_the_extended_rows_f64():
    """With random halos the forward equals the periodic level of a longer
    signal whose neighbouring rows are those halos, read in the middle."""
    wt = T.wavelet(T.wt.db4)
    fa, fb = axis0.halo_reach(wt, False)
    rng = np.random.default_rng(83)
    full = torch.from_numpy(rng.standard_normal((2, 64, 5)))
    x = full[:, 16:48]
    a, d = axis0.axis0_fw(x, wt, above=full[:, 16 - fa:16],
                          below=full[:, 48:48 + fb])
    fa_, fd_ = axis0.axis0_fw(full, wt)
    assert torch.allclose(a, fa_[:, 8:24], rtol=0, atol=1e-12)
    assert torch.allclose(d, fd_[:, 8:24], rtol=0, atol=1e-12)
    ia, ib = axis0.halo_reach(wt, True)
    back = axis0.axis0_inv(fa_[:, 8:24], fd_[:, 8:24], wt,
                           halos=(fa_[:, 8 - ia:8], fa_[:, 24:24 + ib],
                                  fd_[:, 8 - ia:8], fd_[:, 24:24 + ib]))
    assert torch.allclose(back, x, rtol=0, atol=1e-12)


def test_halo_mode_checks_and_counts():
    wt = T.wavelet(T.wt.db4)
    fa, fb = axis0.halo_reach(wt, False)
    x = torch.zeros((1, 16, 4))
    with pytest.raises(ValueError, match="reach"):
        axis0.axis0_fw(x, wt, above=x[:, :fa - 1], below=x[:, :fb])
    with pytest.raises(ValueError):                       # below alone
        axis0.axis0_fw(x, wt, below=x[:, :fb])
    with pytest.raises(ValueError):                       # other width
        axis0.axis0_fw(x, wt, above=torch.zeros((1, fa, 5)),
                       below=x[:, :fb])
    a, d = axis0.axis0_fw(x, wt)
    ia, ib = axis0.halo_reach(wt, True)
    halos = (a[:, :ia], a[:, :ib], d[:, :ia], d[:, :ib])
    with pytest.raises(ValueError):                       # a corner too
        axis0.axis0_inv(a, d, wt, corner=a[:, :, :2], halos=halos)
    with pytest.raises(ValueError):                       # heights differ
        axis0.axis0_inv(a, d, wt, halos=(a[:, :ia], a[:, :ib],
                                         d[:, :ia + 1], d[:, :ib]))
    with pytest.raises(ValueError):                       # out overlaps
        axis0.axis0_fw(x, wt, a, d, above=a[:, :fa], below=x[:, :fb])
    before = dict(axis0.PLAIN_CALLS)
    axis0.axis0_fw(x, wt, above=x[:, :fa], below=x[:, :fb])
    axis0.axis0_inv(a, d, wt, halos=halos)
    assert axis0.PLAIN_CALLS["axis0_fw_halo"] == before["axis0_fw_halo"] + 1
    assert axis0.PLAIN_CALLS["axis0_inv_halo"] == \
        before["axis0_inv_halo"] + 1
    assert axis0.PLAIN_CALLS["axis0_fw"] == before["axis0_fw"]


# the factored lifting schemes whose composed bands reach beyond the JAX
# package's per-step gate (sharded._halo_rows says why the port's gate
# takes the larger value)
_WIDER = {("vaid", "lifting"), ("db8", "lifting"), ("db9", "lifting"),
          ("db10", "lifting"), ("coif8", "lifting"), ("sym5", "lifting"),
          ("sym9", "lifting")}


def test_the_gate_covers_the_reach_for_every_wavelet():
    """Over every wavelet of ALL_CLASSES, both engines: a shard of the
    gate's rows holds the forward reach, and half of it the inverse's, so
    one neighbour's rows always suffice; the port's gate equals the JAX
    package's except where the composed bands reach further."""
    wider = set()
    for name, cls in J.wt.ALL_CLASSES.items():
        for kind in ("filter", "lifting"):
            try:
                ref = J.wt.wavelet(cls, kind)
            except (ValueError, NotImplementedError):
                continue
            wt = from_reference(ref)
            gate = sharded._halo_rows(wt)
            m_loc = max(2, gate + gate % 2)      # the least shard: even
            fa, fb = axis0.halo_reach(wt, False)
            ia, ib = axis0.halo_reach(wt, True)
            assert max(fa, fb) <= m_loc and max(ia, ib) <= m_loc // 2
            if gate != JS._halo_rows(ref):
                assert gate > JS._halo_rows(ref)
                wider.add((name, kind))
    assert wider == _WIDER


def _aligned(shape, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset)[offset:].view(shape)


def test_inverse_halo_views_pick_the_staging_path():
    """Kernel J in halo mode stages by 16-byte words only where the four
    halo views too have 16-byte bases and strides of whole words: a
    zero-row halo (haar's reach below is 0) counts like any other view;
    a halo one element in, or cut from a wider array, takes 4 bytes."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    ia, ib = axis0.halo_reach(wt, True)
    a = _aligned((2, 8, 16))
    halos = (_aligned((2, ia, 16)), _aligned((2, ib, 16)),
             _aligned((2, ia, 16)), _aligned((2, 0, 16)))
    assert axis0.inv_plan(a, a, wt, halos=halos).staging == 16
    assert axis0.inv_plan(a, a, wt, halos=(
        _aligned((2, ia, 16), 1),) + halos[1:]).staging == 4
    assert axis0.inv_plan(a, a, wt, halos=halos[:3] + (
        _aligned((2, ib + 2, 19))[:, 1:, 1:17],)).staging == 4


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("sym5", "filter")])
def test_inverse_halo_walk(name, kind):
    """Kernel J's walk in halo mode, emulated (tests/test_torch_axis0.py,
    emulate_inv): with random halos, taller than the reach and strided,
    every output written once and equal to the plain version; with the
    wrapped rows as halos, bit for bit the periodic walk."""
    from test_torch_axis0 import emulate_inv
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    ia, ib = axis0.halo_reach(wt, True)
    rng = np.random.default_rng(84)
    B, Rh, C = 2, 40, 12
    a = torch.from_numpy(rng.standard_normal((B, Rh, C)))
    d = torch.from_numpy(rng.standard_normal((B, Rh, C)))

    def strided(h):
        return torch.from_numpy(rng.standard_normal(
            (B, h + 3, C + 5)))[:, 1:h + 1, 2:C + 2]

    halos = (strided(ia + 1), strided(ib + 2), strided(ia + 1), strided(ib))
    out, writes = emulate_inv(a, d, wt, halos=halos)
    assert (writes == 1).all()
    ref = axis0.axis0_inv_plain(a, d, wt, halos=halos).numpy()
    assert np.abs(out - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())
    wrapped = (a[:, Rh - ia:], a[:, :ib], d[:, Rh - ia:], d[:, :ib])
    assert np.array_equal(emulate_inv(a, d, wt, halos=wrapped)[0],
                          emulate_inv(a, d, wt)[0])


def test_forward_halo_views_pick_the_staging_path():
    """Kernel I in halo mode stages by 16-byte words only where the two
    halo views too have 16-byte bases and strides of whole words: a
    zero-row halo (haar's reach is 0 on both sides) counts like any other
    view; a halo one element in, or cut from a wider array, takes 4
    bytes."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    fa, fb = axis0.halo_reach(wt, False)
    x, a = _aligned((2, 16, 16)), _aligned((2, 8, 16))
    halos = (_aligned((2, fa, 16)), _aligned((2, fb, 16)))

    def staging(wt, halos):
        return axis0.fw_plan(x, a, a, wt, halos, min_pairs=0).staging

    assert staging(wt, halos) == 16
    assert staging(wt, (_aligned((2, fa, 16), 1), halos[1])) == 4
    assert staging(wt, (halos[0],
                        _aligned((2, fb + 2, 19))[:, 1:, 1:17])) == 4
    haar = T.wavelet(T.wt.haar, "lifting")
    assert axis0.halo_reach(haar, False) == (0, 0)
    assert staging(haar, (_aligned((2, 0, 16)),) * 2) == 16


@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("db4", "filter")])
def test_forward_halo_walk(name, kind):
    """Kernel I's walk in halo mode, emulated (tests/test_torch_axis0.py,
    emulate_fw): with random halos, taller than the reach and strided,
    every output written once and equal to the plain version; with the
    wrapped rows as halos, bit for bit the periodic walk."""
    from test_torch_axis0 import emulate_fw
    wt = T.wavelet(T.wt.ALL_CLASSES[name], kind)
    fa, fb = axis0.halo_reach(wt, False)
    rng = np.random.default_rng(85)
    B, R, C = 2, 80, 12
    x = torch.from_numpy(rng.standard_normal((B, R, C)))

    def strided(h):
        return torch.from_numpy(rng.standard_normal(
            (B, h + 3, C + 5)))[:, 1:h + 1, 2:C + 2]

    halos = (strided(fa + 1), strided(fb + 2))
    a, d, writes = emulate_fw(x, wt, halos=halos)
    assert (writes == 1).all()
    ra, rd = axis0.axis0_fw_plain(x, wt, above=halos[0], below=halos[1])
    for got, ref in ((a, ra.numpy()), (d, rd.numpy())):
        assert np.abs(got - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())
    wrapped = (x[:, R - fa:], x[:, :fb])
    for got, ref in zip(emulate_fw(x, wt, halos=wrapped)[:2],
                        emulate_fw(x, wt)[:2]):
        assert np.array_equal(got, ref)
