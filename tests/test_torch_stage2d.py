"""Kernel N's plain version (ops/stage2d.py) and the stage route against
the JAX package's fused two-level stage (``stage2d._stage2_kernel``).

The JAX side runs its TPU kernels in interpret mode with
``WAVELETS_TPU_MXU_LS2=1``, as tests/test_mxu2d.py runs them; its f32 dots
are split-bf16 emulations within about 1e-5 of f32, so the port's plain
version, which a CPU tensor takes, must agree within 2e-4 relative (the
class of the split-dot TPU kernels).  In bfloat16 both round every level's
outputs, the JAX side with one-pass bf16 dots: 2^-5 relative.  The CUDA
kernel itself is held against the plain version on the card by
chip_smoke.py (phase kernelsstage).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import (filter2d as JF2, lifting2d as JL2,
                                     stage2d as JS)

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import level2d, pyramid2d, stage2d, tail2d
from wavelets_tpu_torch.wt.convert import from_reference

SHAPE = (256, 512)
WAVELETS = [("cdf97", "lifting"), ("db4", "filter")]
TOL = {"float32": 2e-4, "bfloat16": 2.0 ** -5}


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


def _input(dtype):
    x = np.random.default_rng(95).standard_normal(SHAPE).astype(np.float32)
    return x if dtype == "float32" else np.array(
        jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def jax_stage():
    """The JAX package's outputs, computed once per case and shared:
    ``("dwt", name, kind, L, dtype)`` the packed dwt2 with the stage on,
    ``("stage", name, kind, last)`` stage2_fw itself (f32)."""
    memo = {}

    def get(key):
        if key not in memo:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("WAVELETS_TPU_MXU_LS2", "1")
                ref, _ = _carriers(key[1], key[2])
                with pltpu.force_tpu_interpret_mode():
                    if key[0] == "dwt":
                        L, dt = key[3], key[4]
                        xx = jnp.asarray(_input(dt), dt)
                        assert JS.stage2_ok(*SHAPE, ref, xx.dtype)
                        fn = JL2.dwt2_lifting if key[2] == "lifting" \
                            else JF2.dwt2_filter
                        memo[key] = np.asarray(fn(xx, ref, L), np.float64)
                    else:
                        last = key[3]
                        res = JS.stage2_fw(jnp.asarray(_input("float32")),
                                           None, SHAPE, ref, last=last)
                        memo[key] = ((np.asarray(res),) if last else
                                     (np.asarray(res[1]), np.asarray(res[0])))
        return memo[key]
    return get


def _rel(got, want):
    return np.abs(np.asarray(got, np.float64) - want).max() / \
        np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [2, 3])
@pytest.mark.parametrize("name, kind", WAVELETS)
def test_stage_route_matches_jax_stage(name, kind, L, dtype, jax_stage):
    """pyramid2d's stage route (N's plain version, then C for L = 3) against
    the JAX packed driver with the stage on."""
    _, wt = _carriers(name, kind)
    want = jax_stage(("dwt", name, kind, L, dtype))
    x = torch.from_numpy(_input(dtype)).to(getattr(torch, dtype))[None]
    before = dict(stage2d.PLAIN_CALLS)
    got = pyramid2d.dwt2(x, wt, L, route="stage")[0].double().numpy()
    assert stage2d.PLAIN_CALLS["stage2_fw"] == before["stage2_fw"] + 1
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("last", [True, False])
@pytest.mark.parametrize("name, kind", WAVELETS)
def test_plain_matches_stage2_kernel_f32(name, kind, last, jax_stage):
    """stage2_fw_plain against stage2d.stage2_fw: with ``last`` LL2 goes
    into the packed array's corner, else to its own array."""
    _, wt = _carriers(name, kind)
    m, n = SHAPE
    want = jax_stage(("stage", name, kind, last))
    y = torch.full((1, m, n), float("nan"))
    ll2 = y[:, : m >> 2, : n >> 2] if last else torch.empty((1, m >> 2,
                                                             n >> 2))
    outs = (ll2, *level2d.detail_planes(y, 1), *level2d.detail_planes(y, 2))
    stage2d.stage2_fw_plain(torch.from_numpy(_input("float32"))[None], wt,
                            outs)
    ywant = want[0].copy()
    if not last:
        assert _rel(ll2[0].numpy(), want[1]) <= TOL["float32"]
        ywant[: m >> 2, : n >> 2] = np.nan     # LL2 went to its own array
    got = y[0].double().numpy()
    mask = ~np.isnan(ywant)
    assert np.array_equal(np.isnan(got), ~mask)
    scale = np.abs(ywant[mask]).max()
    assert np.abs(got[mask] - ywant[mask]).max() <= TOL["float32"] * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
@pytest.mark.parametrize("name, kind", [("cdf97", "lifting"),
                                        ("haar", "lifting"),
                                        ("coif4", "filter")])
def test_plain_equals_two_level_launches(name, kind, dtype):
    """N's plain version is two plain level launches of A, LL1 stored in
    the storage type in between: bit for bit, batch and ragged shapes."""
    _, wt = _carriers(name, kind)
    x = torch.from_numpy(np.random.default_rng(96).standard_normal(
        (2, 36, 20))).to(dtype)
    got = stage2d.stage2_fw_plain(x, wt)
    ll1, *d1 = level2d.level_fw_plain(x, wt)
    ll2, *d2 = level2d.level_fw_plain(ll1, wt)
    for g, w in zip(got, (ll2, *d1, *d2)):
        assert torch.equal(g, w)


def test_stage_route_gate():
    """N runs for one image with both first levels as level launches; a
    batch, a single level or a deeper first tail runs A per level."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    f32 = torch.float32
    assert pyramid2d.stage_ok(1, 256, 512, 2, wt, f32)
    assert not pyramid2d.stage_ok(2, 256, 512, 2, wt, f32)    # a batch
    assert not pyramid2d.stage_ok(1, 256, 512, 1, wt, f32)    # one level
    assert not pyramid2d.stage_ok(1, 128, 256, 3, wt, f32)    # k = 1
    assert pyramid2d.kernel_levels(128, 256, 3, wt, f32, False) == 1
    batt = T.wavelet(T.wt.batt6)
    assert stage2d.stage_tile(batt, f32) is None
    assert not pyramid2d.stage_ok(1, 1024, 1024, 3, batt, f32)


@pytest.mark.parametrize("name, kind, dtype, tile", [
    ("cdf97", "lifting", torch.float32, 32),
    ("cdf97", "lifting", torch.bfloat16, 32),
    ("cdf97", "lifting", torch.float64, 16),
    ("coif4", "filter", torch.float32, 16),
    ("batt4", "filter", torch.float32, None)])
def test_stage_tile_follows_shared_memory(name, kind, dtype, tile):
    _, wt = _carriers(name, kind)
    assert stage2d.stage_tile(wt, dtype) == tile
    if tile is not None:
        assert stage2d.smem_bytes(wt, dtype, tile) <= level2d.SMEM_LIMIT
        if tile < stage2d.TILES[0]:
            assert stage2d.smem_bytes(wt, dtype, 2 * tile) > \
                level2d.SMEM_LIMIT


@pytest.mark.parametrize("L, calls", [
    (2, {"stage2_fw": 1, "level_fw": 0, "tail_fw": 0}),
    (3, {"stage2_fw": 1, "level_fw": 1, "tail_fw": 0}),
    (5, {"stage2_fw": 1, "level_fw": 1, "tail_fw": 1})])
def test_stage_route_launch_table(L, calls):
    """At 1024 x 512 f32 levels 1-3 are level launches (128 x 64 fits the
    tail): N takes levels 1-2, A level 3, C the rest."""
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.from_numpy(np.random.default_rng(97).standard_normal(
        (1, 1024, 512)).astype(np.float32))
    for d in (stage2d.PLAIN_CALLS, level2d.PLAIN_CALLS, tail2d.PLAIN_CALLS):
        for k in d:
            d[k] = 0
    y = pyramid2d.dwt2(x, wt, L, route="stage")
    got = {"stage2_fw": stage2d.PLAIN_CALLS["stage2_fw"],
           "level_fw": level2d.PLAIN_CALLS["level_fw"],
           "tail_fw": tail2d.PLAIN_CALLS["tail_fw"]}
    assert got == calls
    assert torch.equal(y, pyramid2d.dwt2(x, wt, L))


def test_stage_wrapper_checks_its_inputs():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    x = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError):
        stage2d.stage2_fw(torch.zeros((1, 16, 18)), wt)        # n % 4
    with pytest.raises(ValueError):
        stage2d.stage2_fw(x, wt, stage2d.stage2_fw(x, wt)[:6])  # six planes
    outs = list(stage2d.stage2_fw(x, wt))
    outs[1] = torch.zeros((1, 8, 8), dtype=torch.float64)
    with pytest.raises(ValueError):
        stage2d.stage2_fw(x, wt, outs)                          # dtype
    y = torch.zeros((1, 16, 16))
    with pytest.raises(ValueError):                             # overlap
        stage2d.stage2_fw(y, wt, (y[:, :4, :4], *level2d.detail_planes(y, 1),
                                  *level2d.detail_planes(y, 2)))
    with pytest.raises(ValueError):
        pyramid2d.dwt2(x, wt, 2, route="fused")
    with pytest.raises(ValueError):
        pyramid2d.idwt2(x, wt, 2, route="stage")
