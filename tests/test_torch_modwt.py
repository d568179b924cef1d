"""The MODWT of the port (ops/modwt.py, ops/modwt1d.py: kernels K and M)
against the JAX package.

The public ``modwt``/``imodwt`` run their levels through the kernels'
plain versions on a CPU tensor and are held in float64 against
``wavelets_tpu.modwt`` / ``imodwt`` within 1e-12 x max(1, max|ref|); the
plain route is held in float32 against the TPU kernels
(``modwt1d.modwt_pallas`` / ``imodwt_pallas``, #36 / #37) in interpret
mode, as tests/test_pallas.py runs them, within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import modwt1d as JM

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import modwt as modwt_ops, modwt1d
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


def _carriers(name, kind="filter"):
    ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind)
    return ref, from_reference(ref)


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("name, shape", [
    ("db4", (512,)), ("db4", (1000,)), ("db4", (64,)), ("db4", (3, 1000)),
    ("db4", (2, 3, 64)), ("haar", (512,)), ("haar", (3, 1000)),
    ("sym6", (64,)), ("sym6", (2, 3, 64))])
def test_modwt_imodwt_match_the_jax_package(name, shape):
    """Every level the length allows (maxmodwttransformlevels): at N = 1000
    level 9's reach 7 * 256 wraps the row more than once."""
    ref, wt = _carriers(name)
    x = np.random.default_rng(71).standard_normal(shape)
    want = J.modwt(x, ref)
    got = T.modwt(torch.from_numpy(x), wt)
    assert got.shape == shape + (T.maxmodwttransformlevels(shape[-1]) + 1,)
    _close(got, want)
    back = T.imodwt(got, wt)
    _close(back, J.imodwt(want, ref))
    _close(back, x, 5e-9 if name == "sym6" else 1e-12)


@pytest.mark.parametrize("L", [1, 3, 6])
def test_explicit_levels_match(L):
    ref, wt = _carriers("db2")
    x = np.random.default_rng(72).standard_normal((2, 96))
    want = J.modwt(x, ref, L)
    got = T.modwt(x, wt, L, device="cpu")
    _close(got, want)
    _close(T.imodwt(got, wt), J.imodwt(want, ref))


def test_plain_matches_modwt_kernels_f32():
    """#36 / #37 at the JAX tests' own (16, 512) db4 L6."""
    ref, wt = _carriers("db4")
    x = np.random.default_rng(73).standard_normal((16, 512)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JM.modwt_pallas(jnp.asarray(x), ref, 6))
        want_inv = np.asarray(JM.imodwt_pallas(jnp.asarray(want), ref))
    got = modwt1d.modwt(torch.from_numpy(x), wt, 6)
    assert np.abs(got.numpy() - want).max() < 1e-4
    back = modwt1d.imodwt(torch.from_numpy(want.copy()), wt)
    assert np.abs(back.numpy() - want_inv).max() < 1e-4
    assert np.abs(back.numpy() - x).max() < 1e-4


def test_the_same_refusals_as_the_jax_package():
    ref, wt = _carriers("db4")
    x = np.zeros(16)
    for L in (0, -1, 5):                  # L < 1, and 2^5 > 16
        with pytest.raises(ValueError):
            J.modwt(x, ref, L)
        with pytest.raises(ValueError):
            T.modwt(x, wt, L, device="cpu")
    # a lifting scheme has no MODWT filters: refused on both sides
    gls_ref, gls = _carriers("cdf97", "lifting")
    with pytest.raises(AttributeError):
        J.modwt(x, gls_ref, 2)
    with pytest.raises(TypeError, match="OrthoFilter"):
        T.modwt(x, gls, 2, device="cpu")
    with pytest.raises(AttributeError):
        J.imodwt(np.zeros((16, 3)), gls_ref)
    with pytest.raises(TypeError, match="OrthoFilter"):
        T.imodwt(np.zeros((16, 3)), gls, device="cpu")


def test_level_zero_inverse_is_the_scaling_column():
    ref, wt = _carriers("haar")
    xw = np.random.default_rng(74).standard_normal((3, 8, 1))
    _close(T.imodwt(xw, wt, device="cpu"), J.imodwt(xw, ref))


def test_route_is_one_launch_per_level():
    """Rows that the plan fits take one modwt_fw_levels forward and one
    modwt_inv_levels inverse, rows it does not (here a filter of 41 taps,
    more than the kernel's 32) one K and one M per level.  On a CPU tensor
    each takes its plain version and no kernel is launched."""
    x = torch.zeros((4, 64))
    for name, route in (("db4", {"modwt_fw_levels": 1, "modwt_fw": 0,
                                 "modwt_inv_levels": 1, "modwt_inv": 0}),
                        ("batt4", {"modwt_fw_levels": 0, "modwt_fw": 5,
                                   "modwt_inv_levels": 0, "modwt_inv": 5})):
        _, wt = _carriers(name)
        assert modwt1d.modwt_plan(64, 5, len(wt.qmf), x.dtype, 4).fits == \
            bool(route["modwt_fw_levels"])
        assert modwt1d.modwt_inv_plan(64, 5, len(wt.qmf), x.dtype,
                                      4).fits == bool(
                                          route["modwt_inv_levels"])
        launches = dict(modwt1d.LAUNCHES)
        before = dict(modwt1d.PLAIN_CALLS)
        T.imodwt(T.modwt(x, wt, 5), wt)
        assert modwt1d.LAUNCHES == launches
        want = {k: before[k] + n for k, n in route.items()}
        assert modwt1d.PLAIN_CALLS == want


# chip_smoke.py's rows of the all-levels kernel, (N, L)
_PLAN_ROWS = ((5, 1), (5, 2), (64, 1), (64, 6), (1000, 5), (1000, 9),
              (4096, 3), (8192, 1), (8192, 6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("B", [1, 3, 512])
@pytest.mark.parametrize("taps", [2, 8, 12, 24])
def test_modwt_plan(taps, B, dtype):
    """The plan of every row chip_smoke.py drives: a power-of-two cluster
    of at most 16 blocks (8 beyond three rows) that covers the row with
    MIN_SPAN samples a block or more, level L's reach as the halo, a tap
    template at least the filter, and the layout's shared bytes within
    one block's 227 KB."""
    size = torch.empty((), dtype=dtype).element_size()
    for N, L in _PLAN_ROWS:
        plan = modwt1d.modwt_plan(N, L, taps, dtype, B)
        assert plan.fits
        assert plan.cluster in ((1, 2, 4, 8, 16) if B <= 3 else (1, 2, 4, 8))
        assert plan.span * plan.cluster >= N > plan.span * (plan.cluster - 1)
        assert plan.cluster == 1 or plan.span >= modwt1d.MIN_SPAN
        assert plan.halo == (taps - 1) * 2 ** (L - 1)
        assert plan.taps == min(k for k in modwt1d.TAP_TEMPLATES if k >= taps)
        assert plan.smem == modwt1d._layout_bytes(N, L, plan.cluster,
                                                  plan.halo, size)
        assert plan.smem <= 227 * 1024
        assert plan == modwt1d.cluster_plan(plan.cluster, N, L, taps, dtype)


@pytest.mark.parametrize("dtype, cluster", [(torch.float32, 4),
                                            (torch.bfloat16, 2),
                                            (torch.float64, 8)])
def test_modwt_plan_of_the_main_path(dtype, cluster):
    """(512, 8192) db4 L6: the smallest cluster whose blocks fit two to an
    SM; one row alone spreads over 16 blocks."""
    assert modwt1d.modwt_plan(8192, 6, 8, dtype, 512).cluster == cluster
    assert modwt1d.modwt_plan(8192, 6, 8, dtype, 1).cluster == 16


@pytest.mark.parametrize("N, L, taps", [(1 << 20, 6, 8), (1 << 17, 13, 8),
                                        (64, 5, 41), (8192, 13, 24)])
def test_rows_beyond_the_plan_take_one_K_per_level(N, L, taps):
    """Rows no cluster holds (or filters of more than 32 taps) do not fit,
    in any dtype; the wrapper refuses them, and modwt runs them one level
    at a time."""
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        if (N, L, dtype) == (8192, 13, torch.bfloat16):
            continue            # 24 taps at L13 fit 16 bfloat16 blocks
        assert not modwt1d.modwt_plan(N, L, taps, dtype, 8).fits
    if taps == 41:
        _, wt = _carriers("batt4")
        with pytest.raises(ValueError, match="modwt_plan"):
            modwt1d.modwt_fw_levels(torch.zeros((8, N)), wt, L)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name, N, L", [("db4", 64, 6), ("sym6", 1000, 9),
                                        ("coif8", 96, 5), ("haar", 5, 2)])
def test_levels_plain_is_the_chain_of_K(name, N, L, dtype):
    """modwt_fw_levels' plain version equals the chain of modwt_fw_plain
    levels into the (B, N, L+1) layout bit for bit (each scaling band
    rounded to the storage type between levels), and so does the public
    modwt; a strided input gives the same numbers."""
    _, wt = _carriers(name)
    x = torch.from_numpy(np.random.default_rng(78).standard_normal(
        (3, 2 * N))).to(dtype)[:, ::2]
    out = torch.full((3, N, L + 1), float("nan"), dtype=dtype)
    v = x
    for j in range(1, L + 1):
        v1 = out[..., L] if j == L else torch.empty((3, N), dtype=dtype)
        modwt1d.modwt_fw_plain(v, wt, j, v1, out[..., j - 1])
        v = v1
    got = modwt1d.modwt_fw_levels_plain(x, wt, L)
    assert torch.equal(got, out)
    assert torch.equal(modwt1d.modwt_fw_levels(x.contiguous(), wt, L), out)
    assert torch.equal(T.modwt(x, wt, L), out)


def test_levels_wrapper_checks_its_output():
    _, wt = _carriers("db4")
    x = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        modwt1d.modwt_fw_levels(x, wt, 2, torch.zeros((2, 16, 4)))   # L+1
    with pytest.raises(ValueError):                  # rows not contiguous
        modwt1d.modwt_fw_levels(x, wt, 2,
                                torch.zeros((2, 3, 16)).transpose(1, 2))
    with pytest.raises(ValueError):
        modwt1d.modwt_fw_levels(x, wt, 5)            # 2^5 > 16


def test_columns_are_written_in_place():
    """K writes v1 and w1 into strided columns of one array; M reads them
    back from there: the same numbers as contiguous planes."""
    _, wt = _carriers("db4")
    v = torch.from_numpy(np.random.default_rng(75).standard_normal((3, 40)))
    v1, w1 = modwt1d.modwt_fw(v, wt, 3)
    cols = torch.full((3, 40, 4), float("nan"), dtype=torch.float64)
    modwt1d.modwt_fw(v, wt, 3, cols[..., 3], cols[..., 1])
    assert torch.equal(cols[..., 3], v1) and torch.equal(cols[..., 1], w1)
    assert torch.isnan(cols[..., 0]).all() and torch.isnan(cols[..., 2]).all()
    assert torch.equal(modwt1d.modwt_inv(cols[..., 3], cols[..., 1], wt, 3),
                       modwt1d.modwt_inv(v1, w1, wt, 3))


def test_plain_version_is_the_engine_step():
    """K's plain version is ops/modwt.modwt_step, in the arithmetic type."""
    _, wt = _carriers("db2")
    v = torch.from_numpy(np.random.default_rng(76).standard_normal((2, 24)))
    g, h = modwt_ops.modwt_filter_pair(wt)
    sv, sw = modwt_ops.modwt_step(v, 4, h, g)     # reach 3 * 8 = 24 = N
    v1, w1 = modwt1d.modwt_fw(v, wt, 4)
    assert torch.equal(v1, sv) and torch.equal(w1, sw)
    vb = v.to(torch.bfloat16)
    b1, c1 = modwt1d.modwt_fw(vb, wt, 4)
    f1, e1 = modwt1d.modwt_fw(vb.float(), wt, 4)
    assert torch.equal(b1, f1.to(torch.bfloat16))
    assert torch.equal(c1, e1.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_narrow_dtypes_track_float64(dtype):
    ref, wt = _carriers("db4")
    x = np.random.default_rng(77).standard_normal((4, 256))
    want = np.asarray(J.modwt(x, ref, 5))
    got = T.modwt(torch.from_numpy(x).to(dtype), wt, 5)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(
        want).max()
    back = T.imodwt(got, wt)
    assert np.abs(back.double().numpy() - x).max() <= 10 * tol * np.abs(
        x).max()


# --- the all-levels inverse (modwt_inv_levels) --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("taps", [2, 8, 12, 24, 41])
def test_modwt_inv_plan(taps, dtype):
    """The inverse's plan is the forward's: the same shared layout (two
    scaling buffers of H + R samples and a stage of R (L + 1) + E), so the
    same answers for every row chip_smoke.py drives and for the rows
    beyond it; at the main path's (512, 8192) db4 L6 a cluster of 4 blocks
    (f32; bf16 2, f64 8), and 16 for one row."""
    for B in (1, 3, 512):
        for N, L in _PLAN_ROWS + ((1 << 20, 6), (1 << 17, 13), (64, 5)):
            plan = modwt1d.modwt_inv_plan(N, L, taps, dtype, B)
            assert plan == modwt1d.modwt_plan(N, L, taps, dtype, B)
            assert plan.fits == (taps <= 32 and (N, L) not in (
                (1 << 20, 6), (1 << 17, 13)))
    if taps == 8:
        main = {torch.float32: 4, torch.bfloat16: 2, torch.float64: 8}
        assert modwt1d.modwt_inv_plan(8192, 6, 8, dtype, 512).cluster == \
            main[dtype]
        assert modwt1d.modwt_inv_plan(8192, 6, 8, dtype, 1).cluster == 16


def _inv_chain(xw, wt):
    """The chain of modwt_inv_plain levels, each scaling band in a plane
    of the storage type: what imodwt computed level by level."""
    B, N, L1 = xw.shape
    v = xw[..., L1 - 1]
    for j in range(L1 - 1, 0, -1):
        v = modwt1d.modwt_inv_plain(v, xw[..., j - 1], wt, j,
                                    out=torch.empty((B, N), dtype=xw.dtype))
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("name, N, L", [("db4", 64, 6), ("sym6", 1000, 9),
                                        ("coif8", 96, 5), ("haar", 5, 2)])
def test_inv_levels_plain_is_the_chain_of_M(name, N, L, dtype):
    """modwt_inv_levels' plain version equals the chain of modwt_inv_plain
    levels bit for bit in three dtypes (each scaling band rounded to the
    storage type between levels), through the wrapper, through imodwt and
    from a batch-strided input; imodwt runs it once."""
    _, wt = _carriers(name)
    xw = torch.from_numpy(np.random.default_rng(79).standard_normal(
        (6, N, L + 1))).to(dtype)[::2]
    want = _inv_chain(xw, wt)
    assert torch.equal(modwt1d.modwt_inv_levels_plain(xw, wt), want)
    out = torch.full((3, N), float("nan"), dtype=dtype)
    assert modwt1d.modwt_inv_levels(xw, wt, out) is out
    assert torch.equal(out, want)
    before = dict(modwt1d.PLAIN_CALLS)
    assert torch.equal(T.imodwt(xw, wt), want)
    assert modwt1d.PLAIN_CALLS["modwt_inv_levels"] == \
        before["modwt_inv_levels"] + 1
    assert modwt1d.PLAIN_CALLS["modwt_inv"] == before["modwt_inv"]


@pytest.fixture(scope="module")
def jax_modwt_1000():
    """The JAX package's modwt and imodwt of one (2, 1000) draw at every
    level N = 1000 allows, computed once: {L: (xw, back)}."""
    ref, _ = _carriers("db4")
    x = np.random.default_rng(80).standard_normal((2, 1000))
    out = {}
    for L in range(1, T.maxmodwttransformlevels(1000) + 1):
        xw = np.array(J.modwt(x, ref, L))
        out[L] = (xw, np.asarray(J.imodwt(xw, ref)))
    return out


@pytest.mark.parametrize("L", range(1, 10))
def test_imodwt_one_launch_matches_the_jax_package(L, jax_modwt_1000):
    """imodwt of (2, 1000) db4 rows at every level N = 1000 allows (level
    9's reach 7 * 256 wraps the row more than once): one modwt_inv_levels
    call, within 1e-12 of the JAX package's imodwt in float64."""
    assert T.maxmodwttransformlevels(1000) == 9
    _, wt = _carriers("db4")
    xw, want = jax_modwt_1000[L]
    before = dict(modwt1d.PLAIN_CALLS)
    got = T.imodwt(torch.from_numpy(xw), wt)
    assert modwt1d.PLAIN_CALLS["modwt_inv_levels"] == \
        before["modwt_inv_levels"] + 1
    _close(got, want)


def test_inv_levels_wrapper_checks_its_input():
    """The wrapper takes (B, N, L+1) rows of L+1 contiguous samples with L
    >= 1 and 2^L <= N, and refuses rows beyond its plan (41 taps); imodwt
    runs those, and other layouts, one M per level."""
    _, wt = _carriers("db4")
    xw = torch.zeros((2, 16, 3))
    with pytest.raises(ValueError):
        modwt1d.modwt_inv_levels(xw[..., :1], wt)          # L = 0
    with pytest.raises(ValueError):                      # 2^5 > 16
        modwt1d.modwt_inv_levels(torch.zeros((2, 16, 6)), wt)
    with pytest.raises(ValueError):                      # rows not contiguous
        modwt1d.modwt_inv_levels(torch.zeros((2, 3, 16)).transpose(1, 2), wt)
    with pytest.raises(ValueError):                      # out overlaps xw
        modwt1d.modwt_inv_levels(xw, wt, xw[..., 0])
    _, batt = _carriers("batt4")
    with pytest.raises(ValueError, match="modwt_inv_plan"):
        modwt1d.modwt_inv_levels(torch.zeros((2, 64, 3)), batt)
    cols = torch.from_numpy(np.random.default_rng(81).standard_normal(
        (2, 3, 16))).transpose(1, 2)
    before = dict(modwt1d.PLAIN_CALLS)
    got = T.imodwt(cols, wt)
    assert modwt1d.PLAIN_CALLS["modwt_inv"] == before["modwt_inv"] + 2
    assert torch.equal(got, T.imodwt(cols.contiguous(), wt))
