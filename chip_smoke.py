#!/usr/bin/env python3
"""Smoke run of wavelets_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the run
exits non-zero:

  0. device   -- a CUDA card is required; prints nvidia-smi's name and
                 power limit on a line of its own.
  1. build    -- nvcc builds the kernels from wavelets_tpu_torch/csrc.
  2. kernels  -- every kernel (level forward in quads and packed mode, level
                 inverse, forward and inverse tail) against its plain
                 PyTorch version on the card: f64, f32 and bf16; cdf97 and
                 haar lifting and db4 filter; shapes from 2x2 to 2048^2 with
                 a batch of 3.  Tolerance on max|kernel - plain| / max|plain|:
                 1e-12 (f64), 1e-5 (f32), 2^-7 (bf16).
  3. main     -- dwt/idwt of the 16384^2 float32 image, cdf97 lifting, 8
                 levels, through the public entry points; the launch counts
                 show the route, the round trip is checked, and smaller
                 runs are held against float64 references.
  4. times    -- CUDA-event times (median of three chained measurements) of
                 the main path in f32 and bf16, the same-run copy floor
                 and sol_fraction, the 2048^2 forward, and each kernel beside
                 its plain version at the main path's shapes.

Then the per-kernel JSON line, and last {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import time

import numpy as np
import torch

import wavelets_tpu_torch as w
from wavelets_tpu_torch import profiling as P
from wavelets_tpu_torch.ops import build, level2d, lifting, pyramid2d, tail2d

WAVELETS = (("cdf97", "lifting"), ("haar", "lifting"), ("db4", "filter"))
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SHAPES = ((2, 2), (4, 8), (16, 16), (96, 160), (64, 128), (128, 128),
          (2048, 2048))
BATCH = 3
SIZE, LEVELS = 16384, 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def rel_err(got, ref):
    got, ref = got.double(), ref.double()
    scale = ref.abs().max().item()
    return (got - ref).abs().max().item() / (scale if scale > 0 else 1.0)


def counts():
    return ({**level2d.LAUNCHES, **tail2d.LAUNCHES},
            {**level2d.PLAIN_CALLS, **tail2d.PLAIN_CALLS})


def reset_counts():
    for d in (level2d.LAUNCHES, tail2d.LAUNCHES, level2d.PLAIN_CALLS,
              tail2d.PLAIN_CALLS):
        for k in d:
            d[k] = 0


def launched(name, fn):
    """Run fn, synchronise, and require exactly one launch of ``name``."""
    before = counts()[0][name]
    out = fn()
    torch.cuda.synchronize()
    require(counts()[0][name] == before + 1, f"{name} launched once")
    return out


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
        wt = w.wavelet(w.wt.ALL_CLASSES[wname], kind)
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
                "level_inv": k_inv, "tail_inv": int(k_inv < LEVELS)}
    require(launches == expected, f"route {launches} == {expected}")
    require(all(v > 0 for v in launches.values()), "every kernel launched")
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

    # each kernel beside its plain version at the main path's shapes:
    # level 1 of 16384^2, and the tail's 128^2 with one level
    xb = x[None]
    ll = torch.empty((1, SIZE // 2, SIZE // 2), dtype=x.dtype, device=dev)
    planes = (ll, *level2d.detail_planes(torch.empty_like(xb), 1))
    xr = torch.empty_like(xb)
    small = x[None, :128, :128].contiguous()
    ys, xs = torch.empty_like(small), torch.empty_like(small)
    pairs = {
        "level_fw": (lambda: level2d.level_fw(xb, wt, planes),
                     lambda: level2d.level_fw_plain(xb, wt, planes), planes),
        "level_inv": (lambda: level2d.level_inv(*planes, wt, out=xr),
                      lambda: level2d.level_inv_plain(*planes, wt, out=xr),
                      (xr,)),
        "tail_fw": (lambda: tail2d.tail_fw(small, wt, 1, out=ys),
                    lambda: tail2d.tail_fw_plain(small, wt, 1, out=ys),
                    (ys,)),
        "tail_inv": (lambda: tail2d.tail_inv(ys, wt, 1, out=xs),
                     lambda: tail2d.tail_inv_plain(ys, wt, 1, out=xs),
                     (xs,)),
    }
    rows = {}
    for name, (kern, plain, outs) in pairs.items():
        ms = P.med3(lambda _: kern(), xb, 20) * 1e3
        got = [o.clone() for o in outs]
        plain_ms = P.time_fn(lambda _: plain(), xb, 3) * 1e3
        rel = max(rel_err(g, o) for g, o in zip(got, outs))
        require(rel <= TOL[x.dtype], f"{name} at the main path's shape: "
                f"rel err {rel:.3e}")
        err = max((g.double() - o.double()).abs().max().item()
                  for g, o in zip(got, outs))
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
    return rows


def main():
    phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_kernels(dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (SIZE, SIZE)).astype(np.float32)).to(dev)
    launches = phase_main(x)
    rows = phase_times(dev, x)
    src = {"level_fw": "level2d.cu", "level_inv": "level2d.cu",
           "tail_fw": "tail2d.cu", "tail_inv": "tail2d.cu"}
    replaces = {"level_fw": "wavelets_tpu/ops/pallas/mxu2d.py:1610",
                "level_inv": "wavelets_tpu/ops/pallas/mxu2d.py:1236",
                "tail_fw": "wavelets_tpu/ops/pallas/tail2d.py:52",
                "tail_inv": "wavelets_tpu/ops/pallas/tail2d.py:82"}
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"wavelets_tpu_torch/csrc/{src[name]}",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"]} for name in src]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
