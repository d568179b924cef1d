#!/usr/bin/env python3
"""Smoke run of wavelets_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the run
exits non-zero:

  0. device    -- a CUDA card is required; prints nvidia-smi's name and
                  power limit on a line of its own.
  1. build     -- nvcc builds the kernels from wavelets_tpu_torch/csrc.
  2. kernels   -- every 2-D kernel (level forward in quads and packed mode,
                  level inverse, forward and inverse tail) against its plain
                  PyTorch version on the card: f64, f32 and bf16; cdf97 and
                  haar lifting and db4 filter; shapes from 2x2 to 2048^2 with
                  a batch of 3.  Tolerance on max|kernel - plain| / max|plain|:
                  1e-12 (f64), 1e-5 (f32), 2^-7 (bf16).
  2b. kernels1d -- the 1-D kernels (level forward E and inverse F, tail
                  forward G and inverse H) the same way: lengths 2 to 2^15
                  with a batch of 3, plus one 2^20 row for E and F, and E/F
                  through the row strides of the packet transform.
  3. main      -- dwt/idwt of the 16384^2 float32 image, cdf97 lifting, 8
                  levels, through the public entry points; the launch counts
                  show the route, the round trip is checked, and smaller
                  runs are held against float64 references.
  3b. main1d   -- the 1-D paths through the public dwt/idwt/wpt/iwpt:
                  batched (4096, 4096) db4 L8, single 2^20 db2 L20, single
                  2^24 cdf97 L8 and wpt 2^20 db4 L10; each with its launch
                  table, its f32 round trip and a plain float64 reference.
  4. times     -- CUDA-event times (median of three chained measurements) of
                  the 2-D main path in f32 and bf16, the same-run copy floor
                  and sol_fraction, the 2048^2 forward, and each 2-D kernel
                  beside its plain version and one PyTorch library call.
  4b. times1d  -- the same for the 1-D paths (f32, and bf16 for the batched
                  one), with the host's time to enqueue each call, and the
                  1-D kernels.
  5. trace     -- torch.profiler over five calls of each path: the device
                  time of each launch of one call, the device's busy time,
                  and its idle share against the calls' time with the
                  profiler off.

Then the per-kernel JSON line, and last {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

import wavelets_tpu_torch as w
from wavelets_tpu_torch import profiling as P
from wavelets_tpu_torch.ops import (bands, build, dwt1d, level1d, level2d,
                                    lifting, pyramid2d, tail1d, tail2d)
from wavelets_tpu_torch.ops import wpt as wpt_ops
from wavelets_tpu_torch.ops.bands import tap_count as taps

WAVELETS = (("cdf97", "lifting"), ("haar", "lifting"), ("db4", "filter"))
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SHAPES = ((2, 2), (4, 8), (16, 16), (96, 160), (64, 128), (128, 128),
          (2048, 2048))
SHAPES1D = (2, 8, 96, 4096, 1 << 14, 1 << 15)
BATCH = 3
SIZE, LEVELS = 16384, 8
# the 1-D main paths: name, shape, wavelet, levels, packet transform?
PATHS1D = (("batched_4096x4096_db4_L8", (4096, 4096), ("db4", "filter"), 8,
            False),
           ("single_2e20_db2_L20", (1 << 20,), ("db2", "filter"), 20, False),
           ("single_2e24_cdf97_L8", (1 << 24,), ("cdf97", "lifting"), 8,
            False),
           ("wpt_2e20_db4_L10", (1 << 20,), ("db4", "filter"), 10, True))
# launches of E, G (forward) and F, H (inverse) on each 1-D path, f32
ROUTES1D = {
    "batched_4096x4096_db4_L8": {"level1d_fw": 0, "tail1d_fw": 1,
                                 "level1d_inv": 0, "tail1d_inv": 1},
    "single_2e20_db2_L20": {"level1d_fw": 6, "tail1d_fw": 1,
                            "level1d_inv": 6, "tail1d_inv": 1},
    "single_2e24_cdf97_L8": {"level1d_fw": 8, "tail1d_fw": 0,
                             "level1d_inv": 8, "tail1d_inv": 0},
    "wpt_2e20_db4_L10": {"level1d_fw": 10, "tail1d_fw": 0,
                         "level1d_inv": 10, "tail1d_inv": 0},
}
# published H100 SXM rates (NVIDIA's data sheet): device memory, and FP32
# outside the tensor cores (every timed kernel computes in float32)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
# a library call computes the kernel's function within this of the plain
# version (cuDNN sums in another order)
LIBRARY_TOL = 1e-4
MODULES = (level2d, tail2d, level1d, tail1d)


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


def max_abs(got, ref):
    return (got.double() - ref.double()).abs().max().item()


def counts():
    launches, plain = {}, {}
    for mod in MODULES:
        launches.update(mod.LAUNCHES)
        plain.update(mod.PLAIN_CALLS)
    return launches, plain


def reset_counts():
    for mod in MODULES:
        for d in (mod.LAUNCHES, mod.PLAIN_CALLS):
            for k in d:
                d[k] = 0


def launched(name, fn):
    """Run fn, synchronise, and require exactly one launch of ``name``."""
    before = counts()[0][name]
    out = fn()
    torch.cuda.synchronize()
    require(counts()[0][name] == before + 1, f"{name} launched once")
    return out


def wavelet(name, kind):
    return w.wavelet(w.wt.ALL_CLASSES[name], kind)


def bound(nbytes, flops):
    """Least time in ms for the bytes at the memory rate and the operations
    at the FP32 rate, and which of the two bounds it."""
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_F32
    return max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations"


# --- one PyTorch library call per level kernel (yardsticks, never used by
# the port) ---------------------------------------------------------------

def analysis_filters(wt):
    """The analysis bands as correlation filters (s, d) over the window
    that starts at 2k + dmin: ``h (2, K)``, ``dmin``."""
    ds, cs, dd, cd = bands.level_bands(wt)
    dmin = int(min(ds.min(), dd.min()))
    h = np.zeros((2, int(max(ds.max(), dd.max())) - dmin + 1))
    np.add.at(h[0], ds - dmin, cs)
    np.add.at(h[1], dd - dmin, cd)
    return h, dmin


def synthesis_filters(wt):
    """The synthesis bands as transposed-convolution filters: x[m] =
    sum_k s[k] h[0, m - 2k - jmin] + d[k] h[1, m - 2k - jmin]."""
    terms = []
    for p in (0, 1):
        for ch in (0, 1):
            deltas, coefs = bands.synthesis_bands(wt)[2 * p + ch]
            terms += [(ch, p - 2 * int(dl), c) for dl, c in zip(deltas, coefs)]
    jmin = min(j for _, j, _ in terms)
    h = np.zeros((2, max(j for _, j, _ in terms) - jmin + 1))
    for ch, j, c in terms:
        h[ch, j - jmin] += c
    return h, jmin


def _wrap_index(length, first, n, dev):
    return (torch.arange(length, device=dev) + first) % n


def library_fw1d(x, wt):
    """conv1d, stride 2, on ``x (B, n)`` padded periodically beforehand:
    returns the call, whose output is ``(B, 2, n/2)`` = (s, d)."""
    h, dmin = analysis_filters(wt)
    n = x.shape[1]
    xp = x[:, _wrap_index(n + h.shape[1] - 1, dmin, n, x.device)]
    xp = xp[:, None].contiguous()
    wgt = torch.from_numpy(h)[:, None].to(x)
    return lambda: F.conv1d(xp, wgt, stride=2)


def _transposed_pad(h, jmin, nh):
    """(first padded index a, padded length, crop offset) of a stride-2
    transposed convolution that computes the periodic synthesis."""
    K = h.shape[1]
    a = -((jmin + K) // 2)
    return a, nh + K + 2, -jmin - 2 * a


def library_inv1d(s, d, wt):
    """conv_transpose1d, stride 2, on (s, d) stacked as two channels and
    padded periodically beforehand: returns the call, whose output is the
    ``(B, 2nh)`` merged rows."""
    h, jmin = synthesis_filters(wt)
    nh = s.shape[1]
    a, lin, t0 = _transposed_pad(h, jmin, nh)
    idx = _wrap_index(lin, a, nh, s.device)
    sp = torch.stack([s[:, idx], d[:, idx]], 1).contiguous()
    wgt = torch.from_numpy(h)[:, None].to(s)
    return lambda: F.conv_transpose1d(sp, wgt, stride=2)[:, 0, t0: t0 + 2 * nh]


_QUADS = ((0, 0), (0, 1), (1, 0), (1, 1))   # LL, LH, HL, HH: (axis 0, 1)


def library_fw2d(x, wt):
    """conv2d, stride 2, on ``x (1, m, n)`` padded periodically beforehand,
    with the four separable filters: output ``(1, 4, m/2, n/2)``."""
    h, dmin = analysis_filters(wt)
    _, m, n = x.shape
    K = h.shape[1]
    xp = x[:, _wrap_index(m + K - 1, dmin, m, x.device)]
    xp = xp[:, :, _wrap_index(n + K - 1, dmin, n, x.device)][:, None]
    wgt = torch.from_numpy(np.stack([np.outer(h[r], h[c])
                                     for r, c in _QUADS]))[:, None].to(x)
    xp = xp.contiguous()
    return lambda: F.conv2d(xp, wgt, stride=2)


def library_inv2d(quads, wt):
    """conv_transpose2d, stride 2, on the four quadrants ``(1, mh, nh)``
    stacked as channels and padded periodically: output ``(1, 2mh, 2nh)``."""
    h, jmin = synthesis_filters(wt)
    _, mh, nh = quads[0].shape
    ar, lr, t0 = _transposed_pad(h, jmin, mh)
    ac, lc, _ = _transposed_pad(h, jmin, nh)
    ri = _wrap_index(lr, ar, mh, quads[0].device)
    ci = _wrap_index(lc, ac, nh, quads[0].device)
    inp = torch.stack([q[0][ri][:, ci] for q in quads])[None].contiguous()
    wgt = torch.from_numpy(np.stack([np.outer(h[r], h[c])
                                     for r, c in _QUADS]))[:, None]
    wgt = wgt.to(quads[0])
    return lambda: F.conv_transpose2d(inp, wgt, stride=2)[
        :, 0, t0: t0 + 2 * mh, t0: t0 + 2 * nh]


def quads_of(y):
    """Level 1's four quadrants (LL, LH, HL, HH) of a packed ``y``."""
    _, m, n = y.shape
    return (y[:, : m // 2, : n // 2], *level2d.detail_planes(y, 1))


def packed_of(o):
    """conv2d's four channels ``(1, 4, mh, nh)`` as one packed level."""
    _, _, mh, nh = o.shape
    y = o.new_empty((1, 2 * mh, 2 * nh))
    for q, c in zip(quads_of(y), o.unbind(1)):
        q.copy_(c)
    return y


# --- phases ------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    # library yardsticks in full float32, as the kernels compute
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def phase_build():
    seconds = build.build()
    log = build.build_log()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill", log)]
    emit({"phase": "build", "seconds": seconds,
          "sources": [str(p.relative_to(build.PKG.parent))
                      for p in build.SOURCES],
          "kernels": len(regs), "max_registers": max(regs),
          "spill_bytes": sum(spills)})


def phase_kernels(dev):
    rng = np.random.default_rng(1)
    worst = {}
    cases = 0
    for (wname, kind) in WAVELETS:
        wt = wavelet(wname, kind)
        for dt, tol in TOL.items():
            for m, n in SHAPES:
                x = torch.from_numpy(rng.standard_normal((BATCH, m, n))).to(
                    dev).to(dt)
                errs = {}
                # A, quads mode: four fresh arrays
                ref = level2d.level_fw_plain(x, wt)
                got = launched("level_fw", lambda: level2d.level_fw(x, wt))
                errs["level_fw_quads"] = max(map(rel_err, got, ref))
                # A, packed mode: the details at level 2 of a (2m, 2n) array
                y = torch.full((BATCH, 2 * m, 2 * n), float("nan"),
                               dtype=dt, device=dev)
                ll = torch.empty_like(ref[0])
                planes = (ll, *level2d.detail_planes(y, 2))
                launched("level_fw", lambda: level2d.level_fw(x, wt, planes))
                errs["level_fw_packed"] = max(map(rel_err, planes, ref))
                # B, reading the quadrants in place from the packed array
                ref_inv = level2d.level_inv_plain(*planes, wt)
                got_inv = launched("level_inv",
                                   lambda: level2d.level_inv(*planes, wt))
                errs["level_inv"] = rel_err(got_inv, ref_inv)
                # C and D, all the levels the shape allows
                Lt = w.maxtransformlevels((m, n))
                if (tail2d.tail_fits(m, n, wt, dt)
                        and tail2d.tail_fits(m, n, wt, dt, inverse=True)):
                    ref_t = tail2d.tail_fw_plain(x, wt, Lt)
                    got_t = launched("tail_fw",
                                     lambda: tail2d.tail_fw(x, wt, Lt))
                    errs["tail_fw"] = rel_err(got_t, ref_t)
                    ref_ti = tail2d.tail_inv_plain(ref_t, wt, Lt)
                    got_ti = launched("tail_inv",
                                      lambda: tail2d.tail_inv(ref_t, wt, Lt))
                    errs["tail_inv"] = rel_err(got_ti, ref_ti)
                for name, e in errs.items():
                    require(e <= tol, f"{name} {wname} {dt} {(m, n)}: "
                            f"rel err {e:.3e} > {tol:.1e}")
                    key = f"{name}/{str(dt)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), e)
                cases += 1
    emit({"phase": "kernels", "cases": cases, "batch": BATCH,
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst})


def phase_kernels1d(dev):
    rng = np.random.default_rng(2)
    worst = {}
    cases = 0
    rows = [(BATCH, n) for n in SHAPES1D] + [(1, 1 << 20)]
    for (wname, kind) in WAVELETS:
        wt = wavelet(wname, kind)
        for dt, tol in TOL.items():
            for B, n in rows:
                x = torch.from_numpy(rng.standard_normal((B, n))).to(
                    dev).to(dt)
                h = n // 2
                errs = {}
                # E into two fresh planes
                rs, rd = level1d.level1d_fw_plain(x, wt)
                gs, gd = launched("level1d_fw",
                                  lambda: level1d.level1d_fw(x, wt))
                errs["level1d_fw"] = max(rel_err(gs, rs), rel_err(gd, rd))
                # E with the packet transform's strides: [s | d] per row
                y = torch.full((B, n), float("nan"), dtype=dt, device=dev)
                launched("level1d_fw", lambda: level1d.level1d_fw(
                    x, wt, y[:, :h], y[:, h:]))
                errs["level1d_fw_rows"] = max(rel_err(y[:, :h], rs),
                                              rel_err(y[:, h:], rd))
                # F from two planes, and in place from the rows' halves
                ref_i = level1d.level1d_inv_plain(rs, rd, wt)
                got_i = launched("level1d_inv",
                                 lambda: level1d.level1d_inv(rs, rd, wt))
                errs["level1d_inv"] = rel_err(got_i, ref_i)
                ref_r = level1d.level1d_inv_plain(y[:, :h], y[:, h:], wt)
                got_r = launched("level1d_inv", lambda: level1d.level1d_inv(
                    y[:, :h], y[:, h:], wt))
                errs["level1d_inv_rows"] = rel_err(got_r, ref_r)
                # G and H, all the levels the length allows
                Lt = w.maxtransformlevels(n)
                if (B == BATCH and tail1d.tail1d_fits(n, wt, dt)
                        and tail1d.tail1d_fits(n, wt, dt, inverse=True)):
                    ref_t = tail1d.tail1d_fw_plain(x, wt, Lt)
                    got_t = launched("tail1d_fw",
                                     lambda: tail1d.tail1d_fw(x, wt, Lt))
                    errs["tail1d_fw"] = rel_err(got_t, ref_t)
                    ref_ti = tail1d.tail1d_inv_plain(ref_t, wt, Lt)
                    got_ti = launched("tail1d_inv", lambda: tail1d.tail1d_inv(
                        ref_t, wt, Lt))
                    errs["tail1d_inv"] = rel_err(got_ti, ref_ti)
                for name, e in errs.items():
                    require(e <= tol, f"{name} {wname} {dt} {(B, n)}: "
                            f"rel err {e:.3e} > {tol:.1e}")
                    key = f"{name}/{str(dt)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), e)
                cases += 1
    emit({"phase": "kernels1d", "cases": cases,
          "rows": [list(r) for r in rows],
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst})


def phase_main(x):
    wt = w.wavelet(w.wt.cdf97, "lifting")
    k_fw = pyramid2d.kernel_levels(SIZE, SIZE, LEVELS, wt, x.dtype, False)
    k_inv = pyramid2d.kernel_levels(SIZE, SIZE, LEVELS, wt, x.dtype, True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = w.dwt(x, wt, LEVELS)
    xr = w.idwt(y, wt, LEVELS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = counts()
    expected = {"level_fw": k_fw, "tail_fw": int(k_fw < LEVELS),
                "level_inv": k_inv, "tail_inv": int(k_inv < LEVELS),
                "level1d_fw": 0, "level1d_inv": 0, "tail1d_fw": 0,
                "tail1d_inv": 0}
    require(launches == expected, f"route {launches} == {expected}")
    require(not any(plain.values()), f"no plain version ran: {plain}")
    require(y.shape == x.shape and y.dtype == x.dtype, "packed shape")
    require(bool(torch.isfinite(y).all()), "finite coefficients")
    rt = (xr - x).abs().max().item()
    require(rt <= 1e-3, f"f32 round trip {rt:.3e} <= 1e-3")

    # f32 kernels against the plain f64 pyramid, on the card, at 2048^2 L8
    x2 = x[:2048, :2048].contiguous()
    y32 = w.dwt(x2, wt, LEVELS)
    y64 = pyramid2d.dwt2(x2.double()[None], wt, LEVELS, plain=True)[0]
    e32 = rel_err(y32, y64)
    require(e32 <= 1e-3, f"2048^2 f32 vs plain f64 {e32:.3e} <= 1e-3")
    # f64 round trip at 4096^2 L8 through the kernels
    x4 = x[:4096, :4096].double()
    rt64 = (w.idwt(w.dwt(x4, wt, LEVELS), wt, LEVELS) - x4).abs().max().item()
    require(rt64 <= 1e-12, f"f64 round trip {rt64:.3e} <= 1e-12")
    # against the independent torch lifting engine, f64, 256^2 L8
    xs = x[:256, :256].double()
    es = rel_err(w.dwt(xs, wt, LEVELS),
                 lifting.dwt_nd_lifting(xs, wt, LEVELS, 2))
    require(es <= 1e-12, f"256^2 f64 vs lifting engine {es:.3e} <= 1e-12")
    emit({"phase": "main", "shape": [SIZE, SIZE], "levels": LEVELS,
          "dtype": "float32", "launches": launches, "plain_calls": plain,
          "wall_s_first_call_pair": wall, "roundtrip_max_abs_err": rt,
          "f32_vs_plain_f64_2048_rel_err": e32,
          "f64_roundtrip_4096_max_abs_err": rt64,
          "f64_vs_lifting_engine_256_rel_err": es})
    return launches


def inputs1d(dev):
    """The 1-D inputs, drawn as bench.py:180-193 draws them from
    default_rng(1) (the 2^20 signal first, then the (512, 8192) and 256^3
    arrays of its other keys, then the (4096, 4096) rows), and the 2^24
    signal drawn next."""
    rng = np.random.default_rng(1)
    x20 = rng.standard_normal(1 << 20).astype(np.float32)
    rng.standard_normal((512, 8192))
    rng.standard_normal((256, 256, 256))
    xb = rng.standard_normal((4096, 4096)).astype(np.float32)
    x24 = rng.standard_normal(1 << 24).astype(np.float32)
    return {(1 << 20,): torch.from_numpy(x20).to(dev),
            (4096, 4096): torch.from_numpy(xb).to(dev),
            (1 << 24,): torch.from_numpy(x24).to(dev)}


def path_fns(shape, wt, L, packet, plain=False):
    """Forward and inverse of one 1-D path, through the public entry
    points, or through the plain versions (``plain=True``)."""
    n = shape[-1]
    if packet:
        if plain:
            tree = w.maketree(n, L, "full")
            return (lambda v: wpt_ops.wpt(v, wt, tree, plain=True),
                    lambda v: wpt_ops.iwpt(v, wt, tree, plain=True))
        return (lambda v: w.wpt(v, wt, L), lambda v: w.iwpt(v, wt, L))
    if plain:
        return (lambda v: dwt1d.dwt1(v.reshape(-1, n), wt, L,
                                     plain=True).reshape(v.shape),
                lambda v: dwt1d.idwt1(v.reshape(-1, n), wt, L,
                                      plain=True).reshape(v.shape))
    return (lambda v: w.dwt(v, wt, L, ndt=1),
            lambda v: w.idwt(v, wt, L, ndt=1))


def phase_main1d(xs):
    total = {}
    for name, shape, (wname, kind), L, packet in PATHS1D:
        wt = wavelet(wname, kind)
        x = xs[shape]
        fw, inv = path_fns(shape, wt, L, packet)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fw(x)
        xr = inv(y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, plain = counts()
        expected = {k: 0 for k in launches}
        expected.update(ROUTES1D[name])
        require(launches == expected, f"{name} route {launches}")
        require(not any(plain.values()), f"{name}: no plain version ran")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        require(y.shape == x.shape and y.dtype == x.dtype, f"{name} shape")
        require(bool(torch.isfinite(y).all()), f"{name} finite")
        rt = (xr - x).abs().max().item()
        require(rt <= 1e-3, f"{name} f32 round trip {rt:.3e} <= 1e-3")
        pfw, _ = path_fns(shape, wt, L, packet, plain=True)
        e64 = rel_err(y, pfw(x.double()))
        require(e64 <= 1e-3, f"{name} f32 vs plain f64 {e64:.3e} <= 1e-3")
        out = {"phase": "main1d", "path": name, "shape": list(shape),
               "levels": L, "dtype": "float32", "launches": ROUTES1D[name],
               "plain_calls": sum(plain.values()),
               "wall_s_first_call_pair": wall, "roundtrip_max_abs_err": rt,
               "f32_vs_plain_f64_rel_err": e64}
        if name == "single_2e20_db2_L20":
            x64 = x.double()
            rt64 = (inv(fw(x64)) - x64).abs().max().item()
            require(rt64 <= 1e-12, f"{name} f64 round trip {rt64:.3e}")
            out["f64_roundtrip_max_abs_err"] = rt64
        emit(out)
    return total


def kernel_row(name, kern, plain, outs, tol, library=None, lib_ref=None):
    """Time a kernel beside its plain version (and a library call), and
    check the three agree; ``outs`` are the buffers the kernel writes."""
    x0 = outs[0]
    ms = P.med3(lambda _: kern(), x0, 20) * 1e3
    got = [o.clone() for o in outs]
    plain_ms = P.time_fn(lambda _: plain(), x0, 3) * 1e3
    rel = max(rel_err(g, o) for g, o in zip(got, outs))
    require(rel <= tol, f"{name} at the main path's shape: rel err {rel:.3e}")
    row = {"ms": ms, "plain_ms": plain_ms,
           "max_abs_err": max(max_abs(g, o) for g, o in zip(got, outs)),
           "library_ms": None}
    if library is not None:
        lib_out = library()
        lrel = max(rel_err(a, b) for a, b in zip(lib_ref(lib_out), outs))
        require(lrel <= LIBRARY_TOL, f"{name} library call: rel err "
                f"{lrel:.3e} > {LIBRARY_TOL}")
        del lib_out
        row["library_ms"] = P.med3(lambda _: library(), x0, 10) * 1e3
        row["library_rel_err"] = lrel
    return row


def phase_times(dev, x):
    wt = w.wavelet(w.wt.cdf97, "lifting")
    out = {"phase": "times", "shape": [SIZE, SIZE], "levels": LEVELS}
    for tag, xt in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        fw = P.med3(lambda v: w.dwt(v, wt, LEVELS), xt, 20)
        yt = w.dwt(xt, wt, LEVELS)
        inv = P.med3(lambda v: w.idwt(v, wt, LEVELS), yt, 20)
        copy_s, bw = P.copy_bandwidth(xt, 20)
        out[tag] = {"fw_ms": fw * 1e3, "inv_ms": inv * 1e3,
                    "fw_gsps": xt.numel() / fw / 1e9,
                    "inv_gsps": xt.numel() / inv / 1e9,
                    "copy_ms": copy_s * 1e3, "copy_gbps": bw / 1e9,
                    "fw_sol_fraction": P.sol_fraction(fw, xt, bw),
                    "inv_sol_fraction": P.sol_fraction(inv, xt, bw)}
        del yt
    out["f32"]["plain_fw_ms"] = P.time_fn(
        lambda v: pyramid2d.dwt2(v, wt, LEVELS, plain=True), x[None],
        1, chain=False) * 1e3
    x2 = x[:2048, :2048].contiguous()
    out["f32_2048_fw_ms"] = P.med3(lambda v: w.dwt(v, wt, LEVELS), x2,
                                   20) * 1e3
    emit(out)
    copy_ms = out["f32"]["copy_ms"]

    # each kernel beside its plain version at the main path's shapes:
    # level 1 of 16384^2, and the tail's 128^2 with one level
    xb = x[None]
    ll = torch.empty((1, SIZE // 2, SIZE // 2), dtype=x.dtype, device=dev)
    planes = (ll, *level2d.detail_planes(torch.empty_like(xb), 1))
    xr = torch.empty_like(xb)
    small = x[None, :128, :128].contiguous()
    ys, xs = torch.empty_like(small), torch.empty_like(small)
    rows = {}
    rows["level_fw"] = kernel_row(
        "level_fw", lambda: level2d.level_fw(xb, wt, planes),
        lambda: level2d.level_fw_plain(xb, wt, planes), planes, TOL[x.dtype],
        library_fw2d(xb, wt), lambda o: [o[:, i] for i in range(4)])
    rows["level_inv"] = kernel_row(
        "level_inv", lambda: level2d.level_inv(*planes, wt, out=xr),
        lambda: level2d.level_inv_plain(*planes, wt, out=xr), (xr,),
        TOL[x.dtype], library_inv2d(planes, wt), lambda o: [o])
    # one tail level is one periodic 2-D level: the same library calls
    rows["tail_fw"] = kernel_row(
        "tail_fw", lambda: tail2d.tail_fw(small, wt, 1, out=ys),
        lambda: tail2d.tail_fw_plain(small, wt, 1, out=ys), (ys,),
        TOL[x.dtype], library_fw2d(small, wt), lambda o: [packed_of(o)])
    rows["tail_inv"] = kernel_row(
        "tail_inv", lambda: tail2d.tail_inv(ys, wt, 1, out=xs),
        lambda: tail2d.tail_inv_plain(ys, wt, 1, out=xs), (xs,),
        TOL[x.dtype], library_inv2d(quads_of(ys), wt), lambda o: [o])
    # bounds: each input read once, each output written once; operations
    # of the separable passes (2 per tap)
    big, sm = 2 * x.numel() * 4, 2 * small.numel() * 4
    for name, nbytes, numel in (("level_fw", big, x.numel()),
                                ("level_inv", big, x.numel()),
                                ("tail_fw", sm, small.numel()),
                                ("tail_inv", sm, small.numel())):
        flops = 2 * taps(wt, name.endswith("inv")) * numel
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(nbytes, flops)
        rows[name]["copy_bound_ms"] = copy_ms * nbytes / big
    return rows


def phase_times1d(xs):
    out = {"phase": "times1d"}
    for name, shape, (wname, kind), L, packet in PATHS1D:
        wt = wavelet(wname, kind)
        x = xs[shape]
        geometric = L if packet else P.geometric1d(L)
        tags = (("f32", x),) + ((("bf16", x.to(torch.bfloat16)),)
                                if name.startswith("batched") else ())
        entry = {}
        for tag, xt in tags:
            fw, inv = path_fns(shape, wt, L, packet)
            fw_s = P.med3(fw, xt, 10)
            yt = fw(xt)
            inv_s = P.med3(inv, yt, 10)
            copy_s, bw = P.copy_bandwidth(xt, 10)
            entry[tag] = {"fw_ms": fw_s * 1e3, "inv_ms": inv_s * 1e3,
                          "fw_host_ms": P.enqueue_time(fw, xt) * 1e3,
                          "inv_host_ms": P.enqueue_time(inv, yt) * 1e3,
                          "fw_gsps": xt.numel() / fw_s / 1e9,
                          "inv_gsps": xt.numel() / inv_s / 1e9,
                          "copy_ms": copy_s * 1e3, "copy_gbps": bw / 1e9,
                          "fw_sol_fraction": P.sol_fraction(fw_s, xt, bw,
                                                            geometric),
                          "inv_sol_fraction": P.sol_fraction(inv_s, xt, bw,
                                                             geometric)}
            del yt
        pfw, pinv = path_fns(shape, wt, L, packet, plain=True)
        entry["f32"]["plain_fw_ms"] = P.time_fn(pfw, x, 1, chain=False) * 1e3
        y = path_fns(shape, wt, L, packet)[0](x)
        entry["f32"]["plain_inv_ms"] = P.time_fn(pinv, y, 1,
                                                 chain=False) * 1e3
        out[name] = entry
    emit(out)

    # the 1-D kernels at their main paths' largest shapes: E and F at level
    # 1 of the 2^24 cdf97 signal, G and H over the (4096, 4096) db4 rows
    rows = {}
    cdf = wavelet("cdf97", "lifting")
    x24 = xs[(1 << 24,)][None]
    s, d = torch.empty_like(x24[:, ::2]), torch.empty_like(x24[:, ::2])
    xr = torch.empty_like(x24)
    rows["level1d_fw"] = kernel_row(
        "level1d_fw", lambda: level1d.level1d_fw(x24, cdf, s, d),
        lambda: level1d.level1d_fw_plain(x24, cdf, s, d), (s, d),
        TOL[torch.float32], library_fw1d(x24, cdf),
        lambda o: [o[:, 0], o[:, 1]])
    rows["level1d_inv"] = kernel_row(
        "level1d_inv", lambda: level1d.level1d_inv(s, d, cdf, out=xr),
        lambda: level1d.level1d_inv_plain(s, d, cdf, out=xr), (xr,),
        TOL[torch.float32], library_inv1d(s, d, cdf), lambda o: [o])
    db4 = wavelet("db4", "filter")
    xb = xs[(4096, 4096)]
    yb, xbr = torch.empty_like(xb), torch.empty_like(xb)
    rows["tail1d_fw"] = kernel_row(
        "tail1d_fw", lambda: tail1d.tail1d_fw(xb, db4, 8, out=yb),
        lambda: tail1d.tail1d_fw_plain(xb, db4, 8, out=yb), (yb,),
        TOL[torch.float32])
    rows["tail1d_inv"] = kernel_row(
        "tail1d_inv", lambda: tail1d.tail1d_inv(yb, db4, 8, out=xbr),
        lambda: tail1d.tail1d_inv_plain(yb, db4, 8, out=xbr), (xbr,),
        TOL[torch.float32])
    copy_ms = out["single_2e24_cdf97_L8"]["f32"]["copy_ms"]
    copy_b = 2 * x24.numel() * 4
    geo8 = P.geometric1d(8) / 2     # samples over the 8 levels, per sample
    for name, nbytes, flops in (
            ("level1d_fw", copy_b, taps(cdf, False) * x24.numel()),
            ("level1d_inv", copy_b, taps(cdf, True) * x24.numel()),
            ("tail1d_fw", 2 * xb.numel() * 4,
             2 * taps(db4, False) * xb.numel() * geo8),
            ("tail1d_inv", 2 * xb.numel() * 4,
             2 * taps(db4, True) * xb.numel() * geo8)):
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(nbytes, flops)
        rows[name]["copy_bound_ms"] = copy_ms * nbytes / copy_b
    return rows


def trace(fn, x, calls=5):
    """torch.profiler over ``calls`` calls of ``fn(x)``: the device time of
    each of this repo's kernel launches in the first call, and the device's
    busy time per call (the union of its events).  The idle share is one
    less the busy time over the same calls' time with the profiler off
    (CUDA events), since the profiler slows the host."""
    call_us = P.time_fn(fn, x, calls, chain=False) * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn(x)
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    require(ev, "the profiler recorded device events")
    busy, end = 0.0, None
    for e in ev:
        s0, e0 = e.time_range.start, e.time_range.end
        if end is None or s0 >= end:
            busy += e0 - s0
            end = e0
        elif e0 > end:
            busy += e0 - end
            end = e0
    ours = [e for e in ev if "_kernel" in e.name]
    require(ours, "the profiler recorded this repo's kernels")
    require(busy / calls <= 1.05 * call_us,
            f"device busy {busy / calls:.1f} us per call within the call's "
            f"{call_us:.1f} us")
    return {"launch_us": [[e.name.split("<")[0].split("(")[0].split("::")[-1],
                           round(e.time_range.end - e.time_range.start, 2)]
                          for e in ours[:len(ours) // calls]],
            "busy_us_per_call": busy / calls, "call_us": call_us,
            "idle_share": 1 - busy / calls / call_us}


def phase_trace(x, xs):
    cdf = w.wavelet(w.wt.cdf97, "lifting")
    x2 = x[:2048, :2048].contiguous()
    runs = [("2d_16384_cdf97_L8", x, (lambda v: w.dwt(v, cdf, LEVELS),
                                      lambda v: w.idwt(v, cdf, LEVELS))),
            ("2d_2048_cdf97_L8", x2, (lambda v: w.dwt(v, cdf, LEVELS),
                                      lambda v: w.idwt(v, cdf, LEVELS)))]
    for name, shape, (wname, kind), L, packet in PATHS1D:
        runs.append((name, xs[shape],
                     path_fns(shape, wavelet(wname, kind), L, packet)))
    for name, xt, (fw, inv) in runs:
        yt = fw(xt)
        emit({"phase": "trace", "path": name, "fw": trace(fw, xt),
              "inv": trace(inv, yt)})
        del yt


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_kernels(dev)
    phase_kernels1d(dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (SIZE, SIZE)).astype(np.float32)).to(dev)
    launches = phase_main(x)
    xs = inputs1d(dev)
    launches.update({k: v for k, v in phase_main1d(xs).items()
                     if k.endswith(("1d_fw", "1d_inv"))})
    require(all(v > 0 for v in launches.values()),
            f"every kernel launched on its main path: {launches}")
    rows = phase_times(dev, x)
    torch.cuda.empty_cache()
    rows.update(phase_times1d(xs))
    torch.cuda.empty_cache()
    phase_trace(x, xs)
    src = {"level_fw": "level2d.cu", "level_inv": "level2d.cu",
           "tail_fw": "tail2d.cu", "tail_inv": "tail2d.cu",
           "level1d_fw": "level1d.cu", "level1d_inv": "level1d.cu",
           "tail1d_fw": "tail1d.cu", "tail1d_inv": "tail1d.cu"}
    replaces = {"level_fw": "wavelets_tpu/ops/pallas/mxu2d.py:1610",
                "level_inv": "wavelets_tpu/ops/pallas/mxu2d.py:1236",
                "tail_fw": "wavelets_tpu/ops/pallas/tail2d.py:52",
                "tail_inv": "wavelets_tpu/ops/pallas/tail2d.py:82",
                "level1d_fw": "wavelets_tpu/ops/pallas/dwt1d.py:356",
                "level1d_inv": "wavelets_tpu/ops/pallas/dwt1d.py:379",
                "tail1d_fw": "wavelets_tpu/ops/pallas/pyramid1d.py:236",
                "tail1d_inv": "wavelets_tpu/ops/pallas/pyramid1d.py:400"}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"wavelets_tpu_torch/csrc/{src[name]}",
         "replaces": replaces[name], "launches": launches[name],
         **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "copy_bound_ms")}}
        for name in src]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
