"""The port's import contract, kernel-wrapper dispatch and input checks.

``wavelets_tpu_torch`` must import without JAX (the machine with the card
has none) and without ``nvcc``; a CPU tensor takes each kernel's plain
version, and only a CUDA tensor launches (and counts) a kernel.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import wavelets_tpu_torch as wtt
from wavelets_tpu_torch import profiling
from wavelets_tpu_torch.ops import build, level2d, pyramid2d, tail2d

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
        "from wavelets_tpu_torch.ops import (bands, build, filter_fb, "
        "level2d, lifting, pyramid2d, tail2d)\n"
        "from wavelets_tpu_torch.wt import convert\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'wavelets_tpu' or m.startswith('wavelets_tpu.')]\n"
        "assert not bad, bad\n"
        "assert 'triton' not in sys.modules\n")
    assert res.returncode == 0, res.stderr


def test_import_builds_nothing():
    """Importing and running on the CPU never asks for the library."""
    x = torch.zeros((1, 8, 8))
    wtt.idwt(wtt.dwt(x, wtt.wavelet(wtt.wt.haar), 3, ndt=2),
             wtt.wavelet(wtt.wt.haar), 3, ndt=2)
    assert build.library.cache_info().currsize == 0


def test_build_key_follows_sources():
    assert [p.name for p in build.SOURCES] == ["level2d.cu", "tail2d.cu"]
    key = build._key()
    assert len(key) == 16 and key == build._key()
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS


@pytest.mark.parametrize("dtype, code", [
    (torch.float32, 0), (torch.float64, 1), (torch.bfloat16, 2)])
def test_dtype_codes(dtype, code):
    assert build.dtype_code(dtype) == code


def _calls(name):
    return ({**level2d.LAUNCHES, **tail2d.LAUNCHES}[name],
            {**level2d.PLAIN_CALLS, **tail2d.PLAIN_CALLS}[name])


@pytest.mark.parametrize("name", ["level_fw", "level_inv", "tail_fw",
                                  "tail_inv"])
def test_cpu_tensor_takes_plain_version(name):
    wt = wtt.wavelet(wtt.wt.cdf97, "lifting")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 16, 8)))
    quads = level2d.level_fw_plain(x, wt)
    run = {
        "level_fw": lambda: level2d.level_fw(x, wt),
        "level_inv": lambda: level2d.level_inv(*quads, wt),
        "tail_fw": lambda: tail2d.tail_fw(x, wt, 2),
        "tail_inv": lambda: tail2d.tail_inv(x, wt, 2),
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


def test_sol_fraction_definition():
    x = torch.zeros((1024, 1024))
    floor_s = 2 * x.numel() * 4 * (4 / 3) / 1e12
    assert profiling.sol_fraction(floor_s * 2, x, 1e12) == pytest.approx(0.5)


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
