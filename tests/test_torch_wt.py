"""The port's wavelet tables against the JAX package's.

``wavelets_tpu_torch/wt`` and ``utils`` are copies (the port may not import
JAX, and the JAX package's ``__init__`` does), so the copies are pinned to
the originals statement for statement; carriers carried across with
``from_reference`` equal the port's own; and the band tables that drive the
kernels equal ``mxu2d.level_bands`` / ``synthesis_bands`` exactly.
"""

import ast
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import wavelets_tpu as J
from wavelets_tpu.ops.pallas import mxu2d

import wavelets_tpu_torch as T
from wavelets_tpu_torch.ops import bands
from wavelets_tpu_torch.wt.convert import from_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = [f"wt/{f}.py" for f in ("__init__", "classes", "daubechies",
                                 "filters", "schemes", "factor", "carriers")] \
    + [f"utils/{f}.py" for f in ("__init__", "indexing", "signals", "trees")]
NAMES = sorted(J.wt.ALL_CLASSES)


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """One BLAS and one torch thread: the suite runs its files on parallel
    workers, and threads oversubscribed across them slow every worker."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _code(path):
    """The module's syntax tree with its docstrings set aside."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copies_match_the_originals(rel):
    assert _code(os.path.join(ROOT, "wavelets_tpu_torch", rel)) == \
        _code(os.path.join(ROOT, "wavelets_tpu", rel))


def test_class_table_is_the_same():
    assert NAMES == sorted(T.wt.ALL_CLASSES)
    assert len(NAMES) == 28


def _pair(name, kind):
    """(JAX carrier, port carrier), or the exception type both raise."""
    try:
        ref = J.wt.wavelet(J.wt.ALL_CLASSES[name], kind)
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            T.wt.wavelet(T.wt.ALL_CLASSES[name], kind)
        return None
    return ref, T.wt.wavelet(T.wt.ALL_CLASSES[name], kind)


@pytest.mark.parametrize("kind", ["filter", "lifting"])
@pytest.mark.parametrize("name", NAMES)
def test_from_reference_equals_own_carrier(name, kind):
    pair = _pair(name, kind)
    if pair is None:
        return
    ref, own = pair
    assert from_reference(ref) == own
    assert type(from_reference(ref)) is type(own)


@pytest.mark.parametrize("kind", ["filter", "lifting"])
@pytest.mark.parametrize("name", NAMES)
def test_bands_equal_mxu2d_exactly(name, kind):
    pair = _pair(name, kind)
    if pair is None:
        return
    ref, own = pair
    for got, want in zip(bands.level_bands(own), mxu2d.level_bands(ref)):
        assert np.array_equal(got, np.asarray(want))
    for (gd, gc), (wd, wc) in zip(bands.synthesis_bands(own),
                                  mxu2d.synthesis_bands(ref)):
        assert np.array_equal(gd, wd) and np.array_equal(gc, wc)
    assert bands.band_reach(own) == mxu2d._band_reach(ref)
    assert bands.syn_reach(own) == mxu2d._syn_reach(ref)


def test_boundary_and_errors_carry_across():
    ref = J.wt.wavelet(J.wt.cdf97, "lifting", "symmetric")
    assert from_reference(ref).boundary == "symmetric"
    assert from_reference(ref) == T.wt.wavelet(T.wt.cdf97, "lifting",
                                               "symmetric")
    with pytest.raises(TypeError):
        from_reference(object())
    with pytest.raises(ValueError):
        T.wt.wavelet(T.wt.batt4, "lifting")       # det != 1: no lifting


def test_band_tables_are_cached_and_read_only():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    assert bands.level_bands(wt) is bands.level_bands(wt)
    with pytest.raises(ValueError):
        bands.level_bands(wt)[1][0] = 0.0


def test_band_table_layout():
    wt = T.wavelet(T.wt.cdf97, "lifting")
    fw = bands.band_table(wt, False, torch.bfloat16, torch.device("cpu"))
    assert fw.counts == (9, 7) and fw.dmin == -4 and fw.span == 8
    assert fw.offs.dtype == torch.int32 and fw.coefs.dtype == torch.float32
    inv = bands.band_table(wt, True, torch.float64, torch.device("cpu"))
    assert len(inv.counts) == 4 and inv.coefs.dtype == torch.float64
    assert (-inv.dmin, inv.dmin + inv.span) == bands.syn_reach(wt) == (2, 2)
