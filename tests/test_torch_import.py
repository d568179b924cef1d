"""The port's import contract, kernel-wrapper dispatch and input checks.

``wavelets_tpu_torch`` must import without JAX (the machine with the card
has none) and without ``nvcc``; a CPU tensor takes each kernel's plain
version, and only a CUDA tensor launches (and counts) a kernel.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import wavelets_tpu_torch as wtt
from wavelets_tpu_torch import profiling
from wavelets_tpu_torch.ops import (axis0, build, dwt1d, level1d, level2d,
                                    modwt1d, pyramid2d, stage2d, tail1d,
                                    tail2d)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = code_or_args if isinstance(code_or_args, list) \
        else [sys.executable, "-c", code_or_args]
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_import_leaves_jax_out():
    res = _run(
        "import sys\n"
        "import wavelets_tpu_torch\n"
        "import wavelets_tpu_torch.profiling\n"
        "from wavelets_tpu_torch.ops import (axis0, bands, build, dwt1d, "
        "dwt3d, filter_fb, level1d, level2d, lifting, modwt, modwt1d, "
        "pyramid2d, scratch, tail1d, tail2d, wpt)\n"
        "from wavelets_tpu_torch import subbands, transforms\n"
        "from wavelets_tpu_torch.wt import convert\n"
        "from wavelets_tpu_torch.threshold import (denoise, entropy, ops, "
        "pursuit)\n"
        "from wavelets_tpu_torch.parallel import (apps, costmodel, mesh, "
        "mesh2d, sharded)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'wavelets_tpu' or m.startswith('wavelets_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n")
    assert res.returncode == 0, res.stderr


def test_no_module_imports_jax_or_the_jax_package():
    """No import statement of the port or of chip_smoke.py names jax or
    wavelets_tpu."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|wavelets_tpu)\b", re.M)
    files = sorted(Path(ROOT, "wavelets_tpu_torch").rglob("*.py"))
    files.append(Path(ROOT, "chip_smoke.py"))
    assert len(files) > 40
    for f in files:
        assert not pat.search(f.read_text()), f


def test_the_jax_packages_public_surface_is_exported():
    """Every transform, subband, polyphase and threshold name of
    wavelets_tpu's surface (wavelets_tpu/__init__.py) exists in the port,
    and every name of wavelets_tpu.parallel in its parallel package."""
    for name in ("dwt", "idwt", "wpt", "iwpt", "modwt", "imodwt", "dwtc",
                 "idwtc", "dwt_subbands", "idwt_subbands", "to_packed",
                 "from_packed", "split_last", "merge_last",
                 "threshold", "HardTH", "SoftTH", "SemiSoftTH", "SteinTH",
                 "BiggestTH", "PosTH", "NegTH", "DNFT", "VisuShrink",
                 "denoise", "noisest", "coefentropy", "Entropy",
                 "ShannonEntropy", "LogEnergyEntropy", "bestbasistree",
                 "matchingpursuit"):
        assert name in wtt.__all__ and callable(getattr(wtt, name)), name
    from importlib import import_module
    from wavelets_tpu_torch import parallel
    threshold = import_module("wavelets_tpu_torch.threshold")
    for name in ("make_mesh", "shard_rows", "dwt1", "idwt1", "dwt2",
                 "idwt2", "dwt3", "idwt3", "bestbasistree", "noisest",
                 "denoise", "wpt", "iwpt", "modwt", "imodwt", "mesh2d"):
        assert name in parallel.__all__ and hasattr(parallel, name), name
    for name in ("make_mesh2d", "shard_grid", "shard_grid3", "dwt2",
                 "idwt2", "dwt3", "idwt3"):
        assert hasattr(parallel.mesh2d, name), name
    for name in ("THType", "DEFAULT_TH", "DEFAULT_WAVELET"):
        assert name in threshold.__all__, name


def test_import_builds_nothing():
    """Importing and running on the CPU never asks for the library."""
    x = torch.zeros((1, 8, 8))
    wtt.idwt(wtt.dwt(x, wtt.wavelet(wtt.wt.haar), 3, ndt=2),
             wtt.wavelet(wtt.wt.haar), 3, ndt=2)
    assert build.library.cache_info().currsize == 0


def test_build_key_follows_sources():
    assert [p.name for p in build.SOURCES] == [
        "axis0.cu", "graph.cu", "level1d.cu", "level2d.cu", "level3d.cu",
        "modwt1d.cu", "stage2d.cu", "tail1d.cu", "tail2d.cu"]
    assert set(build._SIGNATURES) >= {"wtt_axis0_fw", "wtt_axis0_inv",
                                      "wtt_axis0_fw_halo",
                                      "wtt_axis0_inv_halo",
                                      "wtt_modwt_fw", "wtt_modwt_inv",
                                      "wtt_modwt_fw_levels",
                                      "wtt_stage2_fw", "wtt_graph_begin",
                                      "wtt_graph_end", "wtt_graph_replay"}
    key = build._key()
    assert len(key) == 16 and key == build._key()
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS


@pytest.mark.parametrize("dtype, code", [
    (torch.float32, 0), (torch.float64, 1), (torch.bfloat16, 2)])
def test_dtype_codes(dtype, code):
    assert build.dtype_code(dtype) == code


def test_compile_needs_nvcc(tmp_path):
    """No nvcc here: building refuses, and leaves nothing behind."""
    with pytest.raises(RuntimeError, match="nvcc"):
        build._compile(tmp_path / "key" / "lib.so")
    assert not (tmp_path / "key").exists()


_MODULES = (level2d, tail2d, level1d, tail1d, axis0, modwt1d, stage2d)


def _calls(name):
    launches, plain = {}, {}
    for mod in _MODULES:
        launches.update(mod.LAUNCHES)
        plain.update(mod.PLAIN_CALLS)
    return launches[name], plain[name]


@pytest.mark.parametrize("name", ["level_fw", "level_inv", "tail_fw",
                                  "tail_inv", "level1d_fw", "level1d_inv",
                                  "tail1d_fw", "tail1d_inv", "axis0_fw",
                                  "axis0_inv", "modwt_fw", "modwt_inv",
                                  "modwt_fw_levels", "axis0_fw_halo",
                                  "axis0_inv_halo", "stage2_fw"])
def test_cpu_tensor_takes_plain_version(name):
    wt = wtt.wavelet(wtt.wt.cdf97, "lifting")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 16, 8)))
    quads = level2d.level_fw_plain(x, wt)
    rows = x[0]
    s, d = level1d.level1d_fw_plain(rows, wt)
    db4 = wtt.wavelet(wtt.wt.db4)
    run = {
        "level_fw": lambda: level2d.level_fw(x, wt),
        "level_inv": lambda: level2d.level_inv(*quads, wt),
        "tail_fw": lambda: tail2d.tail_fw(x, wt, 2),
        "tail_inv": lambda: tail2d.tail_inv(x, wt, 2),
        "level1d_fw": lambda: level1d.level1d_fw(rows, wt),
        "level1d_inv": lambda: level1d.level1d_inv(s, d, wt),
        "tail1d_fw": lambda: tail1d.tail1d_fw(rows, wt, 3),
        "tail1d_inv": lambda: tail1d.tail1d_inv(rows, wt, 3),
        "axis0_fw": lambda: axis0.axis0_fw(x, wt),
        "axis0_inv": lambda: axis0.axis0_inv(x, x.clone(), wt),
        "modwt_fw": lambda: modwt1d.modwt_fw(rows, db4, 2),
        "modwt_inv": lambda: modwt1d.modwt_inv(rows, rows.clone(), db4, 2),
        "modwt_fw_levels": lambda: modwt1d.modwt_fw_levels(rows, db4, 2),
        "axis0_fw_halo": lambda: axis0.axis0_fw(x, wt, above=x[:, :4],
                                                below=x[:, :3]),
        "axis0_inv_halo": lambda: axis0.axis0_inv(
            x, x.clone(), wt, halos=(x[:, :2], x[:, :2], x[:, :2],
                                     x[:, :2])),
        "stage2_fw": lambda: stage2d.stage2_fw(x, wt),
    }[name]
    launches, plain = _calls(name)
    run()
    assert _calls(name) == (launches, plain + 1)


def test_wrappers_check_their_inputs():
    wt = wtt.wavelet(wtt.wt.haar, "lifting")
    x = torch.zeros((1, 8, 8))
    with pytest.raises(ValueError):
        level2d.level_fw(torch.zeros((1, 7, 8)), wt)          # odd rows
    with pytest.raises(ValueError):
        level2d.level_fw(torch.zeros((8, 8)), wt)             # no batch axis
    with pytest.raises(TypeError):
        level2d.level_fw(torch.zeros((1, 8, 8), dtype=torch.int32), wt)
    with pytest.raises(ValueError):
        level2d.level_fw(torch.zeros((1, 8, 16))[..., ::2], wt)   # stride
    with pytest.raises(ValueError):
        level2d.level_fw(x, wt, (torch.zeros((1, 4, 4)),) * 3)
    with pytest.raises(ValueError):
        level2d.level_fw(x, wt, (torch.zeros((1, 4, 5)),) * 4)
    q = level2d.level_fw(x, wt)
    with pytest.raises(ValueError):
        level2d.level_inv(*q, wt, out=torch.zeros((1, 8, 9)))
    with pytest.raises(ValueError):
        level2d.level_inv(q[0], q[1], q[2], torch.zeros((1, 4, 4),
                          dtype=torch.float64), wt)
    with pytest.raises(ValueError):                           # aliasing
        level2d.level_fw(x, wt, (x[:, :4, :4], *q[1:]))
    y = torch.zeros((1, 8, 8))
    planes = (y[:, :4, :4], *level2d.detail_planes(y, 1))
    with pytest.raises(ValueError):
        level2d.level_inv(*planes, wt, out=y)
    level2d.level_inv(*planes, wt)                # reading in place is fine
    with pytest.raises(ValueError):
        tail2d.tail_fw(x, wt, 4)                              # 8 lacks 2^4
    with pytest.raises(ValueError):
        tail2d.tail_fw(x, wt, 0)
    with pytest.raises(ValueError):
        tail2d.tail_fw(torch.zeros((1, 128, 256)), wt, 1)     # too large


def test_1d_wrappers_check_their_inputs():
    wt = wtt.wavelet(wtt.wt.haar, "lifting")
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        level1d.level1d_fw(torch.zeros((2, 7)), wt)              # odd length
    with pytest.raises(ValueError):
        level1d.level1d_fw(torch.zeros(8), wt)                   # no batch
    with pytest.raises(TypeError):
        level1d.level1d_fw(torch.zeros((2, 8), dtype=torch.int32), wt)
    with pytest.raises(ValueError):
        level1d.level1d_fw(torch.zeros((2, 16))[:, ::2], wt)     # stride
    with pytest.raises(ValueError):
        level1d.level1d_fw(x, wt, torch.zeros((2, 4)))           # s alone
    with pytest.raises(ValueError):
        level1d.level1d_fw(x, wt, torch.zeros((2, 4)), torch.zeros((2, 5)))
    with pytest.raises(ValueError):                              # aliasing
        level1d.level1d_fw(x, wt, x[:, :4], torch.zeros((2, 4)))
    s, d = level1d.level1d_fw(x, wt)
    with pytest.raises(ValueError):
        level1d.level1d_inv(s, d, wt, out=torch.zeros((2, 9)))
    with pytest.raises(ValueError):
        level1d.level1d_inv(s, d.double(), wt)
    y = torch.zeros((2, 8))
    with pytest.raises(ValueError):                              # aliasing
        level1d.level1d_inv(y[:, :4], y[:, 4:], wt, out=y)
    level1d.level1d_inv(y[:, :4], y[:, 4:], wt)      # reading in place is fine
    with pytest.raises(ValueError):
        tail1d.tail1d_fw(x, wt, 4)                               # 8 lacks 2^4
    with pytest.raises(ValueError):
        tail1d.tail1d_fw(x, wt, 0)
    with pytest.raises(ValueError):
        tail1d.tail1d_fw(torch.zeros((1, 1 << 15)), wt, 1)       # too long
    with pytest.raises(ValueError):
        tail1d.tail1d_inv(x, wt, 2,
                          out=torch.zeros((2, 8), dtype=torch.float64))


def test_3d_and_modwt_wrappers_check_their_inputs():
    wt = wtt.wavelet(wtt.wt.haar, "lifting")
    db4 = wtt.wavelet(wtt.wt.db4)
    x = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):
        axis0.axis0_fw(torch.zeros((2, 7, 4)), wt)               # odd rows
    with pytest.raises(ValueError):
        axis0.axis0_fw(torch.zeros((8, 4)), wt)                  # no batch
    with pytest.raises(TypeError):
        axis0.axis0_fw(torch.zeros((2, 8, 4), dtype=torch.int32), wt)
    with pytest.raises(ValueError):
        axis0.axis0_fw(torch.zeros((2, 8, 8))[..., ::2], wt)     # stride
    with pytest.raises(ValueError):
        axis0.axis0_fw(x, wt, torch.zeros((2, 4, 4)))            # a alone
    with pytest.raises(ValueError):                              # aliasing
        axis0.axis0_fw(x, wt, x[:, :4], torch.zeros((2, 4, 4)))
    a, d = axis0.axis0_fw(x, wt)
    with pytest.raises(ValueError):
        axis0.axis0_inv(a, d.double(), wt)
    y = torch.zeros((2, 8, 4))
    with pytest.raises(ValueError):                              # aliasing
        axis0.axis0_inv(y[:, :4], y[:, 4:], wt, out=y)
    with pytest.raises(ValueError):                              # aliasing
        axis0.axis0_inv(a, d, wt, out=y, corner=y[:1, :4, :2])
    v = torch.zeros((2, 16))
    with pytest.raises(ValueError):
        modwt1d.modwt_fw(v, db4, 0)                              # level 0
    with pytest.raises(ValueError):
        modwt1d.modwt_fw(torch.zeros(16), db4, 1)                # no batch
    with pytest.raises(TypeError):
        modwt1d.modwt_fw(v.to(torch.int32), db4, 1)
    with pytest.raises(ValueError):                              # aliasing
        modwt1d.modwt_fw(v, db4, 1, v, torch.zeros((2, 16)))
    with pytest.raises(ValueError):
        modwt1d.modwt_inv(v, torch.zeros((2, 8)), db4, 1)
    with pytest.raises(TypeError, match="OrthoFilter"):          # lifting
        modwt1d.modwt_fw(v, wt, 1)


@pytest.mark.parametrize("n, L, dtype, k", [
    (4096, 8, torch.float32, 0), (1 << 20, 20, torch.float32, 6),
    (1 << 24, 8, torch.float32, 8), (1 << 20, 10, torch.float32, 6),
    (1 << 20, 20, torch.float64, 7), (1 << 15, 15, torch.bfloat16, 1),
    (1 << 14, 14, torch.float32, 0), (2, 1, torch.float64, 0)])
def test_route_levels1d(n, L, dtype, k):
    """The 1-D paths: level launches down to the tail's length, then one
    tail launch for the rest."""
    for wt in (wtt.wavelet(wtt.wt.db2), wtt.wavelet(wtt.wt.cdf97, "lifting")):
        for inverse in (False, True):
            assert dwt1d.kernel_levels1d(n, L, wt, dtype, inverse) == k


@pytest.mark.parametrize("m, n, dtype, fits", [
    (128, 128, torch.float32, True), (128, 256, torch.float32, False),
    (128, 128, torch.bfloat16, True), (64, 128, torch.float64, True),
    (128, 128, torch.float64, False), (2, 2, torch.float64, True)])
def test_tail_fits_follows_shared_memory(m, n, dtype, fits):
    wt = wtt.wavelet(wtt.wt.cdf97, "lifting")
    assert tail2d.tail_fits(m, n, wt, dtype) == fits
    assert tail2d.tail_fits(m, n, wt, dtype, inverse=True) == fits


@pytest.mark.parametrize("size, L, dtype, k", [
    (16384, 8, torch.float32, 7), (16384, 8, torch.bfloat16, 7),
    (4096, 8, torch.float64, 6), (256, 8, torch.float32, 1),
    (128, 3, torch.float32, 0), (16384, 1, torch.float32, 1)])
def test_route_levels(size, L, dtype, k):
    """The main path: level launches down to the tail's size, then one
    tail launch for the rest."""
    wt = wtt.wavelet(wtt.wt.cdf97, "lifting")
    for inverse in (False, True):
        assert pyramid2d.kernel_levels(size, size, L, wt, dtype,
                                       inverse) == k


def test_profiling_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        profiling.time_fn(lambda v: v + 1, torch.zeros(4))
    with pytest.raises(ValueError):
        profiling.copy_bandwidth(torch.zeros(4))
    with pytest.raises(ValueError):
        profiling.enqueue_time(lambda v: v + 1, torch.zeros(4))


def test_sol_fraction_definition():
    x = torch.zeros((1024, 1024))
    floor_s = 2 * x.numel() * 4 * (4 / 3) / 1e12
    assert profiling.sol_fraction(floor_s * 2, x, 1e12) == pytest.approx(0.5)


@pytest.mark.parametrize("L, geometric", [(1, 1.0), (3, 1 + 1 / 8 + 1 / 64)])
def test_sol_fraction_of_a_3d_pyramid(L, geometric):
    """One read and one write of the active volume per level."""
    assert profiling.geometric3d(L) == pytest.approx(geometric)


def test_sol_fraction_of_the_modwt():
    """The transform's least traffic: one plane read and L + 1 written (or
    L + 1 read, one written): 6 levels move 8 planes, which sol_fraction
    counts as 2 x 4."""
    x = torch.zeros((512, 8192))
    floor_s = 8 * x.numel() * 4 / 1e12
    assert profiling.sol_fraction(floor_s, x, 1e12,
                                  profiling.geometric_modwt(6)) == \
        pytest.approx(1)


@pytest.mark.parametrize("L, geometric", [(1, 1.0), (2, 1.5),
                                          (8, 2 - 2 ** -7)])
def test_sol_fraction_of_a_1d_pyramid(L, geometric):
    """One read and one write of the active row per level: the row, then
    half of it, ..."""
    assert profiling.geometric1d(L) == pytest.approx(geometric)
    x = torch.zeros(1 << 20)
    floor_s = 2 * x.numel() * 4 * geometric / 1e12
    assert profiling.sol_fraction(floor_s, x, 1e12,
                                  profiling.geometric1d(L)) == pytest.approx(1)


def test_chip_smoke_refuses_without_cuda():
    """No card: chip_smoke.py exits non-zero and prints no result."""
    res = _run([sys.executable, "chip_smoke.py"])
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py copied away from the package cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
