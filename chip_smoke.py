#!/usr/bin/env python3
"""Smoke run of wavelets_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the run
exits non-zero:

  0. device    -- a CUDA card is required; prints nvidia-smi's name and
                  power limit on a line of its own.
  1. build     -- nvcc builds the kernels from wavelets_tpu_torch/csrc.
  2. kernels   -- every 2-D kernel (level forward in quads and packed mode,
                  and through a view that takes its 4-byte staging path;
                  level inverse, forward and inverse tail) against its plain
                  PyTorch version on the card: f64, f32 and bf16; cdf97 and
                  haar lifting and db4 filter; shapes from 2x2 to 2048^2 with
                  a batch of 3.  Tolerance on max|kernel - plain| / max|plain|:
                  1e-12 (f64), 1e-5 (f32), 2^-7 (bf16).  coif4 and db10: A's
                  first form, and B; the tails C and D
                  also on one image (a cluster of blocks), for coif4 (the
                  32-tap template) and db10 (the one-block generic kernel),
                  in place at 128^2 L4 (64 x 128 in f64), and bit for bit
                  against chains of A and B launches (L = 1-4; bf16 L = 1).
  2b. kernels1d -- the 1-D kernels (level forward E and inverse F, tail
                  forward G and inverse H) the same way: lengths 2 to 2^15
                  with a batch of 3, plus one 2^20 row for E and F, and E/F
                  through the row strides of the packet transform; and F's
                  forms (windows of 8 and 16, the first form: cdf97, db4,
                  sym5, db10) on its 16- and 4-byte staging paths, on 2^19
                  rows of 2 samples, 700 rows of 2, (5, 1000), (3, 4096)
                  and one 2^20 row; E's forms (windows of 16 and 8, the
                  first form: cdf97, db4, haar, sym5, db10) on the same
                  rows and both paths, the 4-byte path writing into the
                  halves of odd-width rows; H's forms (windows of 8 and 4,
                  the first form: cdf97, db4, sym5, db10) and G's (windows
                  of 8 and 4 output pairs, the first form: the same
                  wavelets) on both staging paths, 700 rows of 2 to one
                  row of 2^14 through 14 levels (2^13 in f64), over
                  NaN-filled outputs, bit for bit against the first form
                  (staging off) and in place.
  2c. kernels3d -- the axis-0 kernels (forward I, inverse J, and J reading
                  a separate corner) the same way, on (B, R, C) views with
                  gaps between rows and batch items, R = 2, narrow C and
                  the 3-D driver's permuted layouts; J's forms (windows of
                  8 and 16, the first form: cdf97, db4, coif4, db10) on
                  contiguous planes and on the 3-D driver's permuted
                  planes with a corner whose width is no whole 16-byte
                  word, on both staging paths, Rh = 1 and narrow C.  I's
                  forms (windows of 16 and 8: cdf97, haar, db4) bit for
                  bit: the tiled form (a size bound of 0 pairs) against
                  the first form (a bound above the level) over NaN-filled
                  outputs, in three dtypes, on the 3-D driver's views, a
                  ragged C, a view one element in (the 4-byte path), R =
                  2, small levels (smaller items), 4100 batch items of 3
                  columns (several to a strip) and a level of full items;
                  in halo mode with random halos, and with the wrapped
                  rows, equal to the periodic tiled level bit for bit.
  2d. kernelsmodwt -- the MODWT kernels (forward K, inverse M) the same
                  way for four filter wavelets (db4, haar, sym6, coif8: the
                  8-, 16- and 32-tap templates),
                  on (B, N) rows with N = 5 to 8192, N = 1000, strided
                  columns and a tap reach above N; and the all-levels
                  kernel (modwt_fw_levels) against its plain version and,
                  bit for bit, against chains of K launches in f32, f64
                  and bf16: N = 5, 64, 1000, 8192, reaches of several
                  times N, L from 1 to the most the plan fits, B = 1, 3,
                  64 and 512, every cluster size the plan picks (1-16),
                  a strided input; rows beyond the plan must be refused.
                  The all-levels inverse (modwt_inv_levels) the same way:
                  against its plain version and, bit for bit, against
                  chains of M launches in f32, f64 and bf16, on the same
                  rows (every cluster size 1-16, reaches of several times
                  N, a batch-strided input for db4); rows beyond its plan
                  must be refused.
  2e. kernelshalo -- kernels I and J in halo mode: with halos equal to the
                  wrapped rows they must equal the periodic kernels bit for
                  bit; with random halos (taller than the reach, strided;
                  and contiguous, J's 16-byte staging path, the halo below
                  d zero rows tall where the reach is 0) they are held
                  against their plain versions; R = 2H, narrow C and
                  strided views, four wavelets, three dtypes.
  2f. kernelsstage -- kernel N (levels 1 and 2 in one launch) against its
                  plain version: haar, cdf97, db4 (the strip form) and
                  coif4 (a long table: the first form), 1024^2, a ragged
                  1000 x 1544, a batch of 2 and 4 x 4, each strided (the
                  4-byte staging path) and contiguous (the 16-byte path),
                  LL2 into a scratch or into the packed corner, three
                  dtypes; whether it equals two launches of A bit for bit,
                  and the strip form its first form.  Then fresh bf16
                  draws from a seed of their own (4 x 4 eight times per
                  wavelet, and each shape once): N against its plain
                  version, which sums as A does, and bit for bit against
                  two A launches.
  2g. graphs   -- the 2-D driver's CUDA graphs (ops/graph.py): on the
                  level, stage and split routes, in f32, f64 and bf16, at
                  1024^2 L10 and 256^2 with B = 8 (and the level route at
                  16384^2 L8 in f32), 20 forward and 20 inverse calls of
                  each signature over 4 rotating inputs, every output kept
                  to the end, each bit for bit equal to the wrappers' output
                  for its input (a store that keeps no signature); one
                  more call on a side stream; one inside a caller's
                  torch.cuda.graph capture (it must run the wrappers, and
                  the caller's graph must replay to the same bits); and a
                  profiled stretch of replays whose kernels must equal the
                  rise of the launch counters.
  2h. kernelslevel3d -- the one-pass 3-D level (level3_fw, level3_inv,
                  csrc/level3d.cu) through the 3-D driver's one-pass route
                  against its A+I / J+B chain on the card, levels 1-3 of
                  512^3, 256^3 and (64, 32, 128) (haar lifting; haar as a
                  filter at the two smaller): bit for bit in float32 and
                  float64; in bfloat16 no further from the float64 chain
                  than the chain is.  dwt/idwt route haar to one launch a
                  level, cdf97 and db2 to the chain.
  3. main      -- dwt/idwt of the 16384^2 float32 image, cdf97 lifting, 8
                  levels, through the public entry points; the launch counts
                  show the route, the round trip is checked, and smaller
                  runs are held against float64 references.
  3b. main1d   -- the 1-D paths through the public dwt/idwt/wpt/iwpt:
                  batched (4096, 4096) db4 L8, single 2^20 db2 L20, single
                  2^24 cdf97 L8 and wpt 2^20 db4 L10; each with its launch
                  table, its f32 round trip and a plain float64 reference.
  3c. main3d   -- dwt/idwt of the 256^3 float32 volume, cdf97 lifting, 3
                  levels (kernels A then I per forward level, J then B per
                  inverse level), with its launch table, its f32 round
                  trip, the plain float64 version, and a float64 round trip
                  at 128^3; and haar lifting the same way (one level3_fw
                  and one level3_inv launch per level).
  3d. mainmodwt -- modwt/imodwt of (512, 8192) float32 rows, db4, 6 levels
                  (one modwt_fw_levels and one modwt_inv_levels launch), checked
                  the same way; and of (8, 2^20) rows, too long for the
                  plan (one K and one M per level).
  3e. mainsharded -- parallel.dwt2/idwt2 of the 16384^2 float32 image,
                  cdf97 lifting, 8 levels, over Mesh([cuda:0] * 4): the
                  launch table (E and I in halo mode per shard per level,
                  J in halo mode and F back), the fallback levels and the
                  copies; held against the single-card dwt, by its f32
                  round trip and by an f64 round trip at 2048^2.  Then
                  parallel.denoise (cdf97, L6) against the single-card
                  denoise, f32 and f64, on a signal plus noise.
  3f. mainthreshold -- the single-card denoise(cdf97, L=6, TI=True,
                  nspin=(4, 4)) of a 16384^2 signal plus noise and the
                  bestbasistree of the 2^20 signal (db4), each held against
                  a float64 run on the card.
  3g. mainroutes -- the public dwt/idwt of the 16384^2 image (cdf97, L8)
                  under each row of the JAX package's switch table
                  (transforms.routes2d, the environment set around the
                  calls): each route's launch table (stage: N, A x5, C;
                  split: (E + I) x7 and C, D and (J + F) x7), its result
                  against the default route's, an f64 round trip at 2048^2,
                  and db4 at 4096^2 the same way.
  4. times     -- CUDA-event times (median of three chained measurements) of
                  the 2-D main path in f32 and bf16, the same-run copy floor
                  and sol_fraction, the 2048^2 forward, and each 2-D kernel
                  beside its plain version and one PyTorch library call.
  4b. times1d  -- the same for the 1-D paths (f32, and bf16 for the batched
                  one), with the host's time to enqueue each call, and the
                  1-D kernels.
  4c. times3d, timesmodwt -- the same for the 3-D and MODWT paths (f32 and
                  bf16), and kernels I, J, K, M, modwt_fw_levels (beside
                  its plain version, the chain of K launches it replaces,
                  and L dilated conv1d calls plus a torch.stack) and
                  modwt_inv_levels (beside its plain version, the chain of
                  M launches it replaces and L dilated conv1d calls); for K
                  also the contiguous store and the permuted copy that the
                  column store replaces; level3_fw and level3_inv at 256^3
                  level 1 beside their plain versions, and by profiler time
                  at levels 1-3 of 512^3 and 256^3 beside the A + I and J +
                  B launches they replace (timeslevel3d).
  4d. timessharded -- the sharded forward and inverse on 4 shards and on 1,
                  the TI denoise (one spin at a time) and the best-basis
                  search (bench.py's inputs), with host times; I and J in
                  halo mode at one shard's level-1 shape (4096, 16384)
                  beside their plain versions and a conv2d over [above; x;
                  below] (the cat made beforehand, not timed); F over the
                  same shard's rows.
  4e. timesroutes -- each route of 3g forward and inverse: CUDA-event time,
                  host time per call, and device busy time and idle share
                  from a trace (N's kernel must appear in the stage
                  forward's); kernel N at 16384^2 levels 1-2 beside its
                  plain version and two conv2d calls; E, I, J and F at the
                  split route's level-1 shapes (cdf97 and db4), beside
                  their plain versions and conv1d / conv2d calls; the two A
                  launches that N replaces.
  5. trace     -- torch.profiler over five calls of each path (the sharded
                  forward and inverse included): the device time of each
                  launch of one call, the device's busy time, and its idle
                  share against the calls' time with the profiler off
                  (measured before and after the profiled calls).
  5b. timestails -- the tails C / D at one 128^2 level, device against
                  device: kernel and library call by profiler time, host
                  time, the launch floor and the cluster size; at B = 264,
                  128^2, L4; and with clusters of 8 and 16 blocks.
  5c. timesprofiled -- by profiler time: kernels A (f32, bf16) and B at
                  16384^2 level 1, kernel F at level 1 of the 2^24 signal,
                  of the 16384 rows of 16384 (cdf97, db4) and of one
                  shard's 4096 rows, and modwt_fw_levels at (512, 8192) db4 L6 (f32 and bf16, and
                  f32 with each cluster size that fits) beside the chain of
                  K launches and the library calls; kernels J, E and I at
                  their paths' level-1 shapes (J at 16384^2, in halo mode
                  at one shard's (4096, 16384), at 256^3; E at 2^24 and
                  over the 16384 rows of 16384, cdf97 and db4; I at
                  16384^2, in halo mode at one shard's level, at 256^3,
                  each in both forms), by profiler time and CUDA events;
                  kernel E's and kernel I's two forms by level size,
                  which set their size bounds; kernel N at
                  16384^2 levels 1-2 in both forms beside the two A
                  launches it replaces (and in bf16, and for db4), kernel
                  H at (4096, 4096) db4 L8 in both forms beside a chain of
                  eight polyphase conv1d calls, and H's forms by size;
                  kernel G the same way beside a chain of eight strided
                  conv1d calls, and G's forms by size; modwt_inv_levels at
                  (512, 8192) db4 L6 (f32 and bf16) beside the six M
                  launches it replaces and six dilated conv1d calls.
  5d. forms    -- which form of E, I, I and J in halo mode, J, N, G and
                  H each wavelet launches, read from the card by the
                  profiler: the tiled (N: strip, G and H: staged) form
                  below a span of 16 (E, I: also from FW1D_MIN_PAIRS /
                  FW_A0_MIN_PAIRS output pairs a level), the first form
                  otherwise.  It runs
                  after the traces: with these short profiler sessions in
                  phase 2, every later trace lost one launch.

Then the run's wall time, nvidia-smi's line again, the per-kernel JSON line
(a row per kernel, and one per TPU kernel that a route of 3g maps onto one
of them; "redesigned" names a kernel's Hopper form: "tiled", "cluster",
"strips", "staged" or "one pass"),
and last {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import re
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

import wavelets_tpu_torch as w
from wavelets_tpu_torch import parallel
from wavelets_tpu_torch import profiling as P
from wavelets_tpu_torch.parallel import mesh as pmesh, sharded as psharded
from wavelets_tpu_torch.ops import (axis0, bands, build, dwt1d, dwt3d, graph,
                                    level1d, level2d, level3d, lifting,
                                    modwt1d, pyramid2d, rowcol2d, stage2d,
                                    tail1d, tail2d)
from wavelets_tpu_torch.ops import modwt as modwt_ops
from wavelets_tpu_torch.ops import wpt as wpt_ops
from wavelets_tpu_torch.threshold import entropy as th_entropy
from wavelets_tpu_torch.ops.bands import tap_count as taps
from wavelets_tpu_torch.transforms import routes2d

WAVELETS = (("cdf97", "lifting"), ("haar", "lifting"), ("db4", "filter"))
TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SHAPES = ((2, 2), (4, 8), (16, 16), (96, 160), (64, 128), (128, 128),
          (2048, 2048))
SHAPES1D = (2, 8, 96, 4096, 1 << 14, 1 << 15)
BATCH = 3
# the dtypes in which C and D must equal chains of A and B launches bit for
# bit (the one-block kernels that the cluster kernels replaced did, in all
# three), and the wavelets that check C and D alone: a 24-tap table (the
# 32-tap template) and a 40-tap one (the generic one-block kernel)
TAIL_CHAIN_REQUIRED = ("float32", "float64", "bfloat16")
WAVELETS_TAIL = (("coif4", "filter"), ("db10", "filter"))
# kernel F's forms: windows of 8 (cdf97, db4) and 16 offsets (sym5), and
# the first form (db10)
INV1D_WAVELETS = (("cdf97", "lifting"), ("db4", "filter"),
                  ("sym5", "filter"), ("db10", "filter"))
# kernel E's forms: windows of 16 (cdf97, db4) and 8 offsets (haar), the
# first form (sym5, db10); kernel J's: windows of 8 (cdf97, db4) and 16
# offsets (coif4), the first form (db10)
FW1D_WAVELETS = (("cdf97", "lifting"), ("haar", "lifting"),
                 ("db4", "filter"), ("sym5", "filter"), ("db10", "filter"))
INV_A0_WAVELETS = (("cdf97", "lifting"), ("db4", "filter"),
                   ("coif4", "filter"), ("db10", "filter"))
# kernel H's forms: windows of 4 (db4) and 8 offsets (cdf97, sym5), the
# first form (db10); rows (B, n, L): short rows several to a block, the
# batched path's rows, rows of 2^11 through 11 levels, one row of 2^14
# through 14 (the 2^20 db2 L20 inverse's tail; 2^13 in f64)
TAIL_INV_WAVELETS = INV1D_WAVELETS
TAIL_INV_ROWS = ((700, 2, 1), (5, 8, 3), (3, 96, 5), (4096, 4096, 8),
                 (3, 1 << 11, 11), (1, 1 << 14, 14))
# kernel G's forms: windows of 8 (cdf97) and 4 output pairs (db4), the
# first form (sym5, db10: a span of 16 or more), on H's rows
TAIL_FW_WAVELETS = INV1D_WAVELETS
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
# axis-0 shapes (B, R, C): R = 2, narrow and ragged C, tall and wide
SHAPES_A0 = ((1, 2, 1), (3, 2, 5), (2, 8, 3), (5, 4, 40), (3, 96, 160),
             (64, 64, 64), (2, 2048, 512))
# MODWT rows (B, N, level j): a reach (taps - 1) 2^(j-1) above N, N = 1000
WAVELETS_MODWT = (("db4", "filter"), ("haar", "filter"), ("sym6", "filter"),
                  ("coif8", "filter"))
ROWS_MODWT = ((3, 5, 2), (3, 8, 3), (3, 1000, 1), (3, 1000, 9),
              (2, 8192, 6), (64, 4096, 1))
# the all-levels kernel: (B, N, L); N = 64 at L6 and N = 1000 at L9 reach
# several times round the row; clusters of 1 to 16 blocks; (3, 2^17, 13)
# and (8, 2^20, 6) do not fit the plan
ROWS_MODWT_LEVELS = ((1, 5, 1), (3, 5, 2), (1, 64, 1), (3, 64, 6),
                     (1, 1000, 9), (3, 1000, 5), (1, 8192, 6), (3, 8192, 1),
                     (64, 4096, 3), (512, 8192, 6))
ROWS_MODWT_UNPLANNED = ((3, 1 << 17, 13), (8, 1 << 20, 6))
MODWT_LONG, MODWT_LONG_LEVELS = (8, 1 << 20), 6
SIZE3D, LEVELS3D = 256, 3
MODWT_SHAPE, MODWT_LEVELS = (512, 8192), 6
# published H100 SXM rates (NVIDIA's data sheet): device memory, and FP32
# outside the tensor cores (every timed kernel computes in float32)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_F32 = 67e12
# a library call computes the kernel's function within this of the plain
# version (cuDNN sums in another order)
LIBRARY_TOL = 1e-4
MODULES = (level2d, tail2d, level1d, tail1d, axis0, modwt1d, stage2d,
           level3d)
# the one-pass 3-D level: the volumes held against the A+I / J+B chain at
# levels 1-3 (the smaller ones for haar as a filter too), and the cube
# sizes timed level by level
SHAPES_LEVEL3 = ((512, 512, 512), (256, 256, 256), (64, 32, 128))
SIZES_LEVEL3_TIMES = (512, 256)
# the halo mode: wavelets, and (B, R, C) shapes with R = 2H as "2H"
WAVELETS_HALO = WAVELETS + (("sym5", "filter"),)
SHAPES_HALO = ((1, "2H", 1), (3, "2H", 5), (2, 64, 3), (4, 96, 160),
               (1, 256, 512))
SHARDS = 4
# denoise: levels, spin grid; the sharded path's denoise levels
DENOISE_LEVELS, NSPIN = 6, (4, 4)
# kernel N: wavelets (coif4's long table takes a 16-quad tile), and
# (B, m, n) shapes, the ragged one read through a strided view
WAVELETS_STAGE = WAVELETS + (("coif4", "filter"),)
SHAPES_STAGE = ((1, 1024, 1024), (1, 1000, 1544), (2, 96, 160), (1, 4, 4))
# phase 2f's fresh bf16 draws: their seed, and the 4 x 4 draws per wavelet
STAGE_FRESH_SEED, STAGE_FRESH_4x4 = 61, 8
# the JAX package's 2-D switches (WAVELETS_TPU_<name>), and its switch
# table: a name, the switches, the port's (forward, inverse) routes
SWITCHES = ("MXU2D", "MXU_LS2", "FUSED2D", "FUSED_INV", "PACKED2D",
            "PACKED_DMA")
SWITCH_TABLE = (("default", {}, ("level", "level")),
                ("mxu_ls2", {"MXU_LS2": "1"}, ("stage", "level")),
                ("mxu2d_0", {"MXU2D": "0"}, ("level", "split")),
                ("mxu2d_0_packed2d", {"MXU2D": "0", "PACKED2D": "1"},
                 ("level", "split")),
                ("mxu2d_0_fused2d_0", {"MXU2D": "0", "FUSED2D": "0"},
                 ("split", "split")),
                ("mxu2d_0_fused_inv", {"MXU2D": "0", "FUSED_INV": "1"},
                 ("level", "level")))


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


def launch_form(site, wt, *parts, stream, **form):
    """One launch of a kernel in the form ``form`` asks for (``min_pairs``,
    ``staged``, ``strips``, a tail's or MODWT's ``plan``): the plan built
    by ``site.plan`` and not kept, called on ``parts``' tensors on the
    raw ``stream``; no launch is counted."""
    site.plan(wt, *parts, **form).call(site.order(*parts), stream)


def launched(name, fn):
    """Run fn, synchronise, and require exactly one launch of ``name``."""
    before = counts()[0][name]
    out = fn()
    torch.cuda.synchronize()
    require(counts()[0][name] == before + 1, f"{name} launched once")
    return out


def wavelet(name, kind):
    return w.wavelet(w.wt.ALL_CLASSES[name], kind)


def kernel_name(e):
    """A profiler event's kernel name without namespace, template
    arguments or parameters."""
    return e.name.split("<")[0].split("(")[0].split("::")[-1]


def kernel_names(fn):
    """The names of the device kernels that ``fn()`` launches, read from
    the card: a torch.profiler trace of three calls after one unprofiled
    call (the union of their names: the profiler can drop a trace's first
    launch).  It tells which form of a kernel a wrapper chose.  A trace
    that comes back without device events is taken again, with twice the
    calls, up to three times in all, as in device_us: one of two full
    runs lost every event of one of phase 5d's 43 short sessions."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    calls = 3
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {kernel_name(e) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
        calls *= 2
    require(names, "the profiler recorded the call's kernels")
    return names


def require_form(fn, want, what):
    """Require that ``fn()`` launches the kernel ``want`` and nothing
    else on the card; returns its name."""
    got = kernel_names(fn)
    require(got == {want}, f"{what} launches {want}: the card ran {got}")
    return want


@contextlib.contextmanager
def switched(switches):
    """The JAX package's 2-D switches set as given, the others unset, for
    the calls inside (the port reads them at every call)."""
    keys = ["WAVELETS_TPU_" + k for k in SWITCHES]
    saved = {k: os.environ.pop(k, None) for k in keys}
    os.environ.update({"WAVELETS_TPU_" + k: v for k, v in switches.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def route_launches(routes, m, n, L, wt, dtype):
    """The launches of one dwt and one idwt of an (m, n) image on the
    (forward, inverse) routes: the level launches above the tails."""
    kf = pyramid2d.kernel_levels(m, n, L, wt, dtype, False)
    ki = pyramid2d.kernel_levels(m, n, L, wt, dtype, True)
    fw, inv = routes
    out = {"tail_fw": int(kf < L), "tail_inv": int(ki < L)}
    if fw == "split":
        out.update(level1d_fw=kf, axis0_fw=kf)
    elif fw == "stage" and pyramid2d.stage_ok(1, m, n, L, wt, dtype):
        out.update(stage2_fw=1, level_fw=kf - 2)
    else:
        out.update(level_fw=kf)
    if inv == "split":
        out.update(axis0_inv=ki, level1d_inv=ki)
    else:
        out.update(level_inv=ki)
    return out


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


def _polyphase(wt):
    """The synthesis bands as polyphase filters: ``w[p, ch, k]`` is the tap
    of output parity p on channel ch (0 scaling, 1 detail) at offset
    ``smin + k``; returns ``(w, smin)``."""
    bands_ = bands.synthesis_bands(wt)
    smin = min(int(dl.min()) for dl, _ in bands_)
    w = np.zeros((2, 2, max(int(dl.max()) for dl, _ in bands_) - smin + 1))
    for p in (0, 1):
        for ch in (0, 1):
            dl, c = bands_[2 * p + ch]
            np.add.at(w[p, ch], dl - smin, c)
    return w, smin


def library_inv2d(quads, wt):
    """The polyphase form of the inverse 2-D level, one conv2d: the four
    quadrants ``(1, mh, nh)`` as input channels, wrapped beforehand; output
    channel 2p + q holds the samples (2i + p, 2j + q), ``(1, 4, mh, nh)``
    (interleave2d merges them).  cuDNN's conv_transpose2d took 1075-1572 ms
    for kernel B's level, so the transposed form is no yardstick."""
    w, smin = _polyphase(wt)
    K = w.shape[2]
    _, mh, nh = quads[0].shape
    dev = quads[0].device
    ri = _wrap_index(mh + K - 1, smin, mh, dev)
    ci = _wrap_index(nh + K - 1, smin, nh, dev)
    inp = torch.stack([q[0][ri][:, ci] for q in quads])[None].contiguous()
    wgt = torch.from_numpy(np.einsum("prk,qcl->pqrckl", w, w).reshape(
        4, 4, K, K)).to(quads[0])
    return lambda: F.conv2d(inp, wgt)


def interleave2d(o):
    """library_inv2d's ``(1, 4, mh, nh)`` as the merged ``(2mh, 2nh)``."""
    _, _, mh, nh = o.shape
    return o[0].view(2, 2, mh, nh).permute(2, 0, 3, 1).reshape(2 * mh, 2 * nh)


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


def library_axis0_fw(s, wt):
    """conv2d with a (taps, 1) kernel at stride (2, 1) on the rows of a
    contiguous ``s (R, m, n)`` wrapped beforehand: output ``(1, 2, R/2,
    m n)`` = (a, d) along axis 0."""
    h, dmin = analysis_filters(wt)
    R = s.shape[0]
    K = h.shape[1]
    sp = s.reshape(R, -1)[_wrap_index(R + K - 1, dmin, R, s.device)]
    sp = sp[None, None].contiguous()
    wgt = torch.from_numpy(h)[:, None, :, None].to(s)
    return lambda: F.conv2d(sp, wgt, stride=(2, 1))


def library_axis0_inv(a, d, wt):
    """The polyphase form of the inverse, one conv2d: the two planes
    ``(Rh, m, n)`` as two input channels, wrapped beforehand; output
    channel p holds the rows 2k + p, ``(1, 2, Rh, m n)``.  (cuDNN's
    conv_transpose2d took 1222 ms for kernel B's level, so the transposed
    form is no yardstick.)"""
    w, smin = _polyphase(wt)
    K = w.shape[2]
    Rh = a.shape[0]
    idx = _wrap_index(Rh + K - 1, smin, Rh, a.device)
    inp = torch.stack([a.reshape(Rh, -1)[idx], d.reshape(Rh, -1)[idx]])
    inp = inp[None].contiguous()
    wgt = torch.from_numpy(w[..., None]).to(a)
    return lambda: F.conv2d(inp, wgt)


def interleave_rows(o, shape):
    """The polyphase conv2d's ``(1, 2, Rh, m n)`` as the merged
    ``shape = (2Rh, m, n)``."""
    return torch.stack([o[0, 0], o[0, 1]], 1).reshape(shape)


def library_halo_fw(x, above, below, wt):
    """conv2d with a (taps, 1) kernel at stride (2, 1) over ``[above; x;
    below]`` of ``x (1, R, C)``, the cat made beforehand (not timed):
    output ``(1, 2, R/2, C)`` = (a, d)."""
    h, dmin = analysis_filters(wt)
    ha, R, K = above.shape[1], x.shape[1], h.shape[1]
    ext = torch.cat([above[0], x[0], below[0]])
    ext = ext[ha + dmin: ha + dmin + R - 2 + K][None, None].contiguous()
    wgt = torch.from_numpy(h)[:, None, :, None].to(x)
    return lambda: F.conv2d(ext, wgt, stride=(2, 1))


def library_halo_inv(a, d, halos, wt):
    """The polyphase conv2d of library_axis0_inv over ``[above; plane;
    below]`` of the two ``(1, Rh, C)`` planes, the cats made beforehand:
    output ``(1, 2, Rh, C)``, channel p the rows 2k + p."""
    w, smin = _polyphase(wt)
    K = w.shape[2]
    ia, Rh = halos[0].shape[1], a.shape[1]
    lo = ia + smin
    planes = [torch.cat([above[0], v[0], below[0]])[lo: lo + Rh + K - 1]
              for v, above, below in ((a, halos[0], halos[1]),
                                      (d, halos[2], halos[3]))]
    inp = torch.stack(planes)[None].contiguous()
    wgt = torch.from_numpy(w[..., None]).to(a)
    return lambda: F.conv2d(inp, wgt)


def library_inv1d_polyphase(s, d, wt):
    """The polyphase form of the 1-D inverse, one conv1d: (s, d) of ``(B,
    nh)`` as two input channels, wrapped beforehand; output channel p holds
    the samples 2k + p, ``(B, 2, nh)`` (interleave1d merges them)."""
    w_, smin = _polyphase(wt)
    K, nh = w_.shape[2], s.shape[1]
    idx = _wrap_index(nh + K - 1, smin, nh, s.device)
    inp = torch.stack([s[:, idx], d[:, idx]], 1).contiguous()
    wgt = torch.from_numpy(w_).to(s)
    return lambda: F.conv1d(inp, wgt)


def interleave1d(o):
    """library_inv1d_polyphase's ``(B, 2, nh)`` as the merged ``(B, 2nh)``."""
    return o.transpose(1, 2).reshape(o.shape[0], -1)


def _modwt_taps(wt):
    g, h = modwt_ops.modwt_filter_pair(wt)
    return g, h, len(g)


def library_modwt_fw(v, wt, j):
    """One dilated conv1d with 2 output channels on ``v (B, N)`` wrapped
    beforehand: output ``(B, 2, N)`` = (v1, w1)."""
    g, h, K = _modwt_taps(wt)
    B, N = v.shape
    dil = 2 ** (j - 1)
    reach = (K - 1) * dil
    vp = v[:, _wrap_index(N + reach, -reach, N, v.device)][:, None]
    vp = vp.contiguous()
    wgt = torch.from_numpy(np.stack([g[::-1], h[::-1]]).copy())[:, None]
    wgt = wgt.to(v)
    return lambda: F.conv1d(vp, wgt, dilation=dil)


def library_modwt_inv(v1, w1, wt, j):
    """One dilated conv1d with 2 input channels (v1, w1), wrapped
    beforehand: output ``(B, 1, N)``."""
    g, h, K = _modwt_taps(wt)
    B, N = v1.shape
    dil = 2 ** (j - 1)
    idx = _wrap_index(N + (K - 1) * dil, 0, N, v1.device)
    inp = torch.stack([v1[:, idx], w1[:, idx]], 1).contiguous()
    wgt = torch.from_numpy(np.stack([g, h]))[None].to(v1)
    return lambda: F.conv1d(inp, wgt, dilation=dil)


def library_modwt_levels(x, wt, L):
    """L dilated conv1d calls, one per level (each input the plain
    version's scaling band of the level before, wrapped beforehand), and
    the stack of their details and the last scaling band into (B, N,
    L+1)."""
    g, h = modwt_ops.modwt_filter_pair(wt)
    v, calls = x, []
    for j in range(1, L + 1):
        calls.append(library_modwt_fw(v, wt, j))
        v = modwt_ops.modwt_step(v, j, h, g)[0]

    def call():
        outs = [c() for c in calls]
        return torch.stack([o[:, 1] for o in outs] + [outs[-1][:, 0]], dim=-1)

    return call


def library_modwt_inv_levels(xw, wt):
    """L dilated conv1d calls, one per level, deepest first (each on the
    plain version's scaling band of the level before and the column w_j,
    wrapped and stacked beforehand): the last call's output ``(B, 1, N)``
    is the reconstruction."""
    g, h = modwt_ops.modwt_filter_pair(wt)
    L = xw.shape[2] - 1
    v, calls = xw[..., L], []
    for j in range(L, 0, -1):
        calls.append(library_modwt_inv(v, xw[..., j - 1], wt, j))
        v = modwt_ops.imodwt_step(v, xw[..., j - 1], j, h, g)

    def call():
        for c in calls:
            out = c()
        return out

    return call


def library_tail1d_fw(x, wt, L):
    """L strided conv1d calls, one per level (each on the plain version's
    scaling band of the level before, wrapped beforehand), and a function
    that packs their outputs as kernel G does."""
    v, calls = x, []
    for _ in range(L):
        calls.append(library_fw1d(v, wt))
        v = level1d.level1d_fw_plain(v, wt)[0]

    def pack(outs):
        y = torch.empty_like(x)
        nh = x.shape[1]
        for o in outs:
            nh //= 2
            y[:, nh: 2 * nh] = o[:, 1]
        y[:, :nh] = outs[-1][:, 0]
        return y

    return (lambda: [c() for c in calls]), pack


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
    return smi


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


def check_all(phase, errs, case, dt, tol, worst):
    """Require every error of one case within ``tol``; keep the worst per
    kernel and dtype."""
    for name, e in errs.items():
        require(e <= tol, f"{phase} {name} {case} {dt}: rel err {e:.3e} > "
                f"{tol:.1e}")
        key = f"{name}/{str(dt)[6:]}"
        worst[key] = max(worst.get(key, 0.0), e)


def phase_kernels(dev):
    rng = np.random.default_rng(1)
    worst, chain, clusters = {}, {}, set()
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
                # A's 4-byte staging path: x read through a view whose base
                # and row stride are not whole 16-byte words, into packed
                # planes
                xv = torch.from_numpy(rng.standard_normal(
                    (BATCH, m, n + 3))).to(dev).to(dt)[:, :, 1:n + 1]
                ref_v = level2d.level_fw_plain(xv, wt)
                yv = torch.full_like(y, float("nan"))
                planes_v = (torch.empty_like(ll), *level2d.detail_planes(yv, 2))
                launched("level_fw", lambda: level2d.level_fw(xv, wt,
                                                              planes_v))
                errs["level_fw_strided"] = max(map(rel_err, planes_v, ref_v))
                # B, reading the quadrants in place from the packed array
                ref_inv = level2d.level_inv_plain(*planes, wt)
                got_inv = launched("level_inv",
                                   lambda: level2d.level_inv(*planes, wt))
                errs["level_inv"] = rel_err(got_inv, ref_inv)
                # C and D, all the levels the shape allows, on the batch
                # and on one image (a cluster of blocks)
                if (tail2d.tail_fits(m, n, wt, dt)
                        and tail2d.tail_fits(m, n, wt, dt, inverse=True)):
                    for B in (BATCH, 1):
                        errs.update(check_tail(x[:B], wt, dt, chain,
                                               clusters))
                check_all("kernels", errs, (wname, m, n), dt, tol, worst)
                cases += 1
    # the longer tables: A's first form (coif4, db10: analysis spans of 16
    # or more), B's 16-offset window (coif4) and first form (db10); C and
    # D alone: coif4 (24 taps, the 32-tap template) and db10 (40 taps, the
    # one-block kernel with wrapped taps)
    for (wname, kind) in WAVELETS_TAIL:
        wt = wavelet(wname, kind)
        require(level2d.fw_window(wt) == 0, f"A's first form for {wname}")
        for dt, tol in TOL.items():
            for m, n in SHAPES:
                x = torch.from_numpy(rng.standard_normal((BATCH, m, n))).to(
                    dev).to(dt)
                ref = level2d.level_fw_plain(x, wt)
                got = launched("level_fw", lambda: level2d.level_fw(x, wt))
                errs = {"level_fw_quads": max(map(rel_err, got, ref))}
                ref_inv = level2d.level_inv_plain(*ref, wt)
                got_inv = launched("level_inv",
                                   lambda: level2d.level_inv(*ref, wt))
                errs["level_inv"] = rel_err(got_inv, ref_inv)
                if (tail2d.tail_fits(m, n, wt, dt)
                        and tail2d.tail_fits(m, n, wt, dt, inverse=True)):
                    for B in (BATCH, 1):
                        errs.update(check_tail(x[:B], wt, dt, chain,
                                               clusters))
                check_all("kernels", errs, (wname, m, n), dt, tol, worst)
                cases += 1
    chain_ok = {k: all(v) for k, v in chain.items()}
    for key in TAIL_CHAIN_REQUIRED:
        require(chain_ok[key], f"C and D bit-equal to chains of A and B "
                f"launches: {key}")
    emit({"phase": "kernels", "cases": cases, "batch": BATCH,
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst, "tail_bit_equal_to_chain": chain_ok,
          "tail_chain_cases": {k: len(v) for k, v in chain.items()},
          "tail_clusters": sorted(clusters)})


def chain_fw(x, wt, L):
    """L launches of kernel A, each on the LL of the one before: the packed
    result that C computes in one launch."""
    B, m, n = x.shape
    y = torch.empty_like(x)
    act = x
    for l in range(1, L + 1):
        ll = (y[:, : m >> l, : n >> l] if l == L else
              torch.empty((B, m >> l, n >> l), dtype=x.dtype, device=x.device))
        level2d.level_fw(act, wt, (ll, *level2d.detail_planes(y, l)))
        act = ll
    return y


def chain_inv(y, wt, L):
    """L launches of kernel B, deepest level first: what D computes."""
    _, m, n = y.shape
    act = y[:, : m >> L, : n >> L]
    for l in range(L, 0, -1):
        act = level2d.level_inv(act, *level2d.detail_planes(y, l), wt)
    return act


def check_tail(x, wt, dt, chain, clusters):
    """C and D on ``x (B, m, n)`` against their plain versions at every
    level the shape allows; whether they equal chains of A and B launches
    bit for bit (L = 1 .. 4 in f32 and f64, L = 1 in bf16: C keeps the LL
    between levels in the arithmetic type, A rounds it to the storage
    type); and, at 128^2 (64 x 128 in f64), in place."""
    B, m, n = x.shape
    Lt = w.maxtransformlevels((m, n))
    ref = tail2d.tail_fw_plain(x, wt, Lt)
    got = launched("tail_fw", lambda: tail2d.tail_fw(x, wt, Lt))
    ref_i = tail2d.tail_inv_plain(ref, wt, Lt)
    got_i = launched("tail_inv", lambda: tail2d.tail_inv(ref, wt, Lt))
    plans = [tail2d.tail_plan(B, m, n, Lt, wt, dt, inv) for inv in (0, 1)]
    clusters.update((B, m, n, p.cluster, p.split, p.taps) for p in plans)
    key = str(dt)[6:]
    for L in range(1, min(4, Lt) + 1) if dt != torch.bfloat16 else (1,):
        y = tail2d.tail_fw(x, wt, L)
        chain.setdefault(key, []).append(torch.equal(y, chain_fw(x, wt, L)))
        chain[key].append(torch.equal(tail2d.tail_inv(y, wt, L),
                                      chain_inv(y, wt, L)))
    if (m, n) == ((64, 128) if dt == torch.float64 else (128, 128)):
        xi = x.clone()
        tail2d.tail_fw(xi, wt, 4, out=xi)
        require(torch.equal(xi, tail2d.tail_fw(x, wt, 4)),
                f"C in place {(B, m, n)} {dt}")
        yi = xi.clone()
        tail2d.tail_inv(yi, wt, 4, out=yi)
        require(torch.equal(yi, tail2d.tail_inv(xi, wt, 4)),
                f"D in place {(B, m, n)} {dt}")
    return {f"tail_fw_b{B}": rel_err(got, ref),
            f"tail_inv_b{B}": rel_err(got_i, ref_i)}


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
                check_all("kernels1d", errs, (wname, B, n), dt, tol, worst)
                cases += 1
    cases += check_inv1d(dev, rng, worst)
    cases += check_fw1d(dev, rng, worst)
    cases += check_tail_inv(dev, rng, worst)
    cases += check_tail_fw(dev, rng, worst)
    emit({"phase": "kernels1d", "cases": cases,
          "rows": [list(r) for r in rows],
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst})


def check_inv1d(dev, rng, worst):
    """Kernel F's forms against its plain version: the window of 8 (cdf97,
    db4) and of 16 offsets (sym5) and the first form (db10), each on the
    16-byte staging path (planes whose bases, row strides and length are
    whole 16-byte words) and on the 4-byte path (views one element in,
    row strides of an odd count); rows of one pair as deep as an iwpt of
    2^20 samples goes (2^19 rows), short rows several to a tile, and
    long rows cut into tiles."""
    cases = 0
    rows = ((1 << 19, 2), (700, 2), (5, 1000), (3, 4096), (1, 1 << 20))
    for (wname, kind) in INV1D_WAVELETS:
        wt = wavelet(wname, kind)
        for dt, tol in TOL.items():
            for B, n in rows:
                h = n // 2
                errs = {}
                for path in ("16", "4"):
                    if path == "16":
                        s = torch.from_numpy(rng.standard_normal((B, h))).to(
                            dev).to(dt)
                        d = torch.from_numpy(rng.standard_normal((B, h))).to(
                            dev).to(dt)
                    else:
                        y = torch.from_numpy(rng.standard_normal(
                            (B, n + 3))).to(dev).to(dt)
                        s, d = y[:, 1:h + 1], y[:, h + 2:n + 2]
                    ref = level1d.level1d_inv_plain(s, d, wt)
                    got = launched("level1d_inv",
                                   lambda: level1d.level1d_inv(s, d, wt))
                    errs[f"level1d_inv_{path}byte"] = rel_err(got, ref)
                check_all("kernels1d", errs, (wname, B, n), dt, tol, worst)
                cases += 1
    return cases


def check_fw1d(dev, rng, worst):
    """Kernel E's forms against its plain version: the window of 16
    (cdf97, db4) and of 8 offsets (haar) and the first form (sym5, db10),
    on the 16-byte staging path (rows whose base, row stride and length
    are whole 16-byte words, into fresh planes) and on the 4-byte path
    (rows one element in, into the two halves of rows of odd width: the
    detail plane's base and row stride are no whole words, so it takes
    4-byte stores); the short rows of a deep packet depth (2^19 rows of 2
    samples, 700 of 2), several rows to a tile, and long rows cut into
    tiles.  A level of fewer than level1d.FW1D_MIN_PAIRS output pairs
    takes the first form through the wrapper; where the wavelet has a
    window, the tiled form (launched with a bound of 0 pairs) is held
    there too, so that both forms meet every shape (phase 5d reads from
    the card which form the wrapper launches)."""
    cases = 0
    nan = float("nan")
    rows = ((1 << 19, 2), (700, 2), (5, 1000), (3, 4096), (1, 1 << 20))
    stream = torch.cuda.current_stream().cuda_stream
    for (wname, kind) in FW1D_WAVELETS:
        wt = wavelet(wname, kind)
        tiled = bool(level1d.fw1d_window(wt))
        for dt, tol in TOL.items():
            for B, n in rows:
                h = n // 2
                errs = {}
                for path in ("16", "4"):
                    if path == "16":
                        x = torch.from_numpy(rng.standard_normal((B, n))).to(
                            dev).to(dt)
                        s = torch.empty((B, h), dtype=dt, device=dev)
                        d = torch.empty((B, h), dtype=dt, device=dev)
                    else:
                        x = torch.from_numpy(rng.standard_normal(
                            (B, n + 3))).to(dev).to(dt)[:, 1:n + 1]
                        y = torch.full((B, n + 1), nan, dtype=dt, device=dev)
                        s, d = y[:, :h], y[:, h + 1:]
                    rs, rd = level1d.level1d_fw_plain(x, wt)
                    launched("level1d_fw",
                             lambda: level1d.level1d_fw(x, wt, s, d))
                    errs[f"level1d_fw_{path}byte"] = max(rel_err(s, rs),
                                                         rel_err(d, rd))
                    if tiled and B * h < level1d.FW1D_MIN_PAIRS:
                        s.fill_(nan)
                        d.fill_(nan)
                        launch_form(level1d._FW, wt, x, s, d, stream=stream,
                                    min_pairs=0)
                        torch.cuda.synchronize()
                        errs[f"level1d_fw_tiled_{path}byte"] = max(
                            rel_err(s, rs), rel_err(d, rd))
                check_all("kernels1d", errs, (wname, B, n), dt, tol, worst)
                cases += 1
    return cases


def check_tail_inv(dev, rng, worst):
    """Kernel H's forms: the staged form through the wrapper (windows of 4:
    db4; of 8: cdf97, sym5) against its plain version and bit for bit
    against the first form (launched with staging off), over NaN-filled
    outputs and in place (out = y); db10 takes the first form.  On the
    16-byte staging path (contiguous rows) and the 4-byte path (rows one
    element in, an odd row stride); short rows several to a block (700
    rows of 2, (5, 8), (3, 96)), the main path's rows, rows of 2^11 and
    one row of 2^14 (the 2^20 db2 L20 inverse's tail; 2^13 in f64)."""
    cases = 0
    nan = float("nan")
    stream = torch.cuda.current_stream().cuda_stream
    for (wname, kind) in TAIL_INV_WAVELETS:
        wt = wavelet(wname, kind)
        staged = bool(tail1d.inv_window(wt))
        for dt, tol in TOL.items():
            for B, n, L in TAIL_INV_ROWS:
                if not tail1d.tail1d_fits(n, wt, dt, inverse=True):
                    n, L = n // 2, L - 1
                errs = {}
                for path in ("16", "4"):
                    y = torch.from_numpy(rng.standard_normal(
                        (B, n + 3) if path == "4" else (B, n))).to(dev).to(dt)
                    y = y[:, 1:n + 1] if path == "4" else y
                    plan = tail1d.inv_plan(y, wt, L)
                    want = 16 if path == "16" and n * y.element_size() % 16 \
                        == 0 else 4
                    require(plan.staging == (want if staged else 0),
                            f"H {wname} {(B, n)} {dt} stages by {want} bytes: "
                            f"{plan}")
                    ref = tail1d.tail1d_inv_plain(y, wt, L)
                    got = torch.full((B, n), nan, dtype=dt, device=dev)
                    launched("tail1d_inv",
                             lambda: tail1d.tail1d_inv(y, wt, L, out=got))
                    errs[f"tail1d_inv_{path}byte"] = rel_err(got, ref)
                    first = torch.full((B, n), nan, dtype=dt, device=dev)
                    launch_form(tail1d._INV, wt, L, y, first, stream=stream,
                                staged=False)
                    yy = y.clone()
                    tail1d.tail1d_inv(yy, wt, L, out=yy)
                    torch.cuda.synchronize()
                    require(torch.equal(got, first) and torch.equal(yy, got),
                            f"H {wname} {(B, n)} L{L} {dt} {path}-byte: "
                            "bit-equal to its first form and in place")
                check_all("kernels1d", errs, (wname, B, n, L), dt, tol, worst)
                cases += 1
    return cases


def check_tail_fw(dev, rng, worst):
    """Kernel G's forms: the staged form through the wrapper (windows of 8
    output pairs: cdf97; of 4: db4) against its plain version and bit for
    bit against the first form (launched with staging off), over
    NaN-filled outputs and in place (out = x); sym5 and db10 take the
    first form.  On the 16-byte staging path (contiguous rows) and the
    4-byte path (rows one element in, an odd row stride; their outputs
    take element stores where the row stride is no whole word); H's rows
    (TAIL_INV_ROWS: 700 rows of 2 to one row of 2^14, 2^13 in f64)."""
    cases = 0
    nan = float("nan")
    stream = torch.cuda.current_stream().cuda_stream
    for (wname, kind) in TAIL_FW_WAVELETS:
        wt = wavelet(wname, kind)
        staged = bool(tail1d.fw_window(wt))
        for dt, tol in TOL.items():
            for B, n, L in TAIL_INV_ROWS:
                if not tail1d.tail1d_fits(n, wt, dt):
                    n, L = n // 2, L - 1
                errs = {}
                for path in ("16", "4"):
                    x = torch.from_numpy(rng.standard_normal(
                        (B, n + 3) if path == "4" else (B, n))).to(dev).to(dt)
                    x = x[:, 1:n + 1] if path == "4" else x
                    plan = tail1d.fw_plan(x, wt, L)
                    want = 16 if path == "16" and n * x.element_size() % 16 \
                        == 0 else 4
                    require(plan.staging == (want if staged else 0),
                            f"G {wname} {(B, n)} {dt} stages by {want} bytes: "
                            f"{plan}")
                    ref = tail1d.tail1d_fw_plain(x, wt, L)
                    # the 4-byte path writes into rows of an odd stride
                    wide = torch.full((B, n + (path == "4")), nan, dtype=dt,
                                      device=dev)
                    got = wide[:, :n]
                    launched("tail1d_fw",
                             lambda: tail1d.tail1d_fw(x, wt, L, out=got))
                    errs[f"tail1d_fw_{path}byte"] = rel_err(got, ref)
                    first = torch.full((B, n), nan, dtype=dt, device=dev)
                    launch_form(tail1d._FW, wt, L, x, first, stream=stream,
                                staged=False)
                    xx = x.clone()
                    tail1d.tail1d_fw(xx, wt, L, out=xx)
                    torch.cuda.synchronize()
                    require(torch.equal(got, first) and torch.equal(xx, got),
                            f"G {wname} {(B, n)} L{L} {dt} {path}-byte: "
                            "bit-equal to its first form and in place")
                    require(bool(torch.isnan(wide[:, n:]).all()),
                            f"G {wname} {(B, n)} {dt} writes its rows only")
                check_all("kernels1d", errs, (wname, B, n, L), dt, tol, worst)
                cases += 1
    return cases


def check_inv_a0(dev, rng, worst):
    """Kernel J's forms against its plain version: the window of 8 (cdf97,
    db4) and of 16 offsets (coif4) and the first form (db10), on the
    16-byte staging path (contiguous planes, and the 3-D driver's permuted
    planes with a corner of its own layout; C a whole number of words)
    and on the 4-byte path (C not: the same calls), Rh = 1 and narrow C
    (several batch items to a strip) included; a corner whose width is no
    whole number of words takes the words across it element by
    element."""
    cases = 0
    shapes = ((1, 1, 8), (3, 1, 5), (5, 4, 3), (2, 4, 40), (3, 48, 160),
              (64, 32, 64), (2, 1024, 512))
    for (wname, kind) in INV_A0_WAVELETS:
        wt = wavelet(wname, kind)
        for dt, tol in TOL.items():
            for B, Rh, C in shapes:
                errs = {}
                a = torch.from_numpy(rng.standard_normal((B, Rh, C))).to(
                    dev).to(dt)
                d = torch.from_numpy(rng.standard_normal((B, Rh, C))).to(
                    dev).to(dt)
                ref = axis0.axis0_inv_plain(a, d, wt)
                got = launched("axis0_inv", lambda: axis0.axis0_inv(a, d, wt))
                errs["axis0_inv_contiguous"] = rel_err(got, ref)
                # the 3-D driver: a and d the halves of a (2 Rh, B, C)
                # sub-cube, the corner the deeper level's (Bc, Rh, Cc)
                # result in the same layout, the output a scratch
                y = torch.from_numpy(rng.standard_normal((2 * Rh, B, C))).to(
                    dev).to(dt)
                pa, pd = y[:Rh].permute(1, 0, 2), y[Rh:].permute(1, 0, 2)
                corner = torch.from_numpy(rng.standard_normal(
                    (Rh, (B + 1) // 2, C))).to(dev).to(dt)[
                        :, :, :C - C // 3].permute(1, 0, 2)
                out = torch.full((2 * Rh, B, C), float("nan"), dtype=dt,
                                 device=dev).permute(1, 0, 2)
                ref = axis0.axis0_inv_plain(pa, pd, wt, corner=corner)
                launched("axis0_inv", lambda: axis0.axis0_inv(
                    pa, pd, wt, out=out, corner=corner))
                errs["axis0_inv_3d_corner"] = rel_err(out, ref)
                check_all("kernels3d", errs, (wname, B, Rh, C), dt, tol,
                          worst)
                cases += 1
    return cases


def check_fw_a0(dev, rng, worst):
    """Kernel I's two forms, bit for bit: the tiled form (launched with a
    size bound of 0 pairs) against the first form (a bound above every
    level) over NaN-filled outputs, and against the plain version within
    TOL; cdf97 (window 16), haar (8) and db4 (16, the descending detail
    band) in three dtypes.  Levels: the 3-D driver's views (x its scratch
    as (m, d, n), a and d the halves of a wider packed volume), a strip
    cut short (C = 160 and 40), a view one element in and one column
    narrower (the 4-byte staging path, element stores),
    R = 2, small levels that take smaller items (8 output pairs) and
    narrow C with many batch items, and one big enough for full items.
    In halo mode: random halos (strided, taller than the reach), and the
    wrapped rows as halos, which must equal the periodic tiled level bit
    for bit."""
    cases = 0
    nan = float("nan")
    stream = torch.cuda.current_stream().cuda_stream
    shapes = ((1, 2, 1), (3, 2, 5), (5, 4, 40), (3, 96, 160), (64, 16, 12),
              (4100, 8, 3), (2, 4096, 512))

    def forms(x, a, d, halos=None):
        got = []
        for bound in (0, 1 << 40):
            a.fill_(nan)
            d.fill_(nan)
            launch_form(axis0._FW if halos is None else axis0._FW_HALO, wt,
                        x, a, d, *(halos or (None, None)), stream=stream,
                        min_pairs=bound)
            torch.cuda.synchronize()
            got.append((a.clone(), d.clone()))
        (ta, td), (fa, fd) = got
        require(torch.equal(ta, fa) and torch.equal(td, fd),
                f"I's tiled form equals its first form bit for bit: {wname} "
                f"{tuple(x.shape)} {dt} halos={halos is not None}")
        return ta, td

    for (wname, kind) in WAVELETS:
        wt = wavelet(wname, kind)
        fa_, fb_ = axis0.halo_reach(wt, False)
        for dt, tol in TOL.items():
            for B, R, C in shapes:
                errs = {}
                Rh = R // 2
                x = torch.from_numpy(rng.standard_normal((B, R, C))).to(
                    dev).to(dt)
                a, d = torch.empty((2, B, Rh, C), dtype=dt, device=dev)
                ra, rd = axis0.axis0_fw_plain(x, wt)
                ta, td = forms(x, a, d)
                errs["axis0_fw_tiled"] = max(rel_err(ta, ra), rel_err(td, rd))
                # the 3-D driver: x a (R, B, C) scratch, the outputs the
                # halves of a packed volume wider than C
                s = torch.from_numpy(rng.standard_normal((R, B, C))).to(
                    dev).to(dt)
                y = torch.full((R, B + 1, C + 8), nan, dtype=dt, device=dev)
                pa = y[:Rh, :B, :C].permute(1, 0, 2)
                pd = y[Rh:, :B, :C].permute(1, 0, 2)
                xs = s.permute(1, 0, 2)
                ra, rd = axis0.axis0_fw_plain(xs, wt)
                ta, td = forms(xs, pa, pd)
                errs["axis0_fw_tiled_3d"] = max(rel_err(ta, ra),
                                                rel_err(td, rd))
                # the 4-byte path: x one element in, ragged C - 1 wide,
                # the planes one element in (element stores)
                x4 = torch.from_numpy(rng.standard_normal(B * R * C + 1)).to(
                    dev).to(dt)[1:].view(B, R, C)[:, :, :max(C - 1, 1)]
                C4 = x4.shape[2]
                buf = torch.full((2 * B * Rh * C4 + 1,), nan, dtype=dt,
                                 device=dev)
                a4 = buf[1:1 + B * Rh * C4].view(B, Rh, C4)
                d4 = buf[1 + B * Rh * C4:].view(B, Rh, C4)
                ra, rd = axis0.axis0_fw_plain(x4, wt)
                ta, td = forms(x4, a4, d4)
                errs["axis0_fw_tiled_4byte"] = max(rel_err(ta, ra),
                                                   rel_err(td, rd))
                # halo mode: random strided halos, then the wrapped rows
                above = strided(rng, (B, fa_ + 2, C), dt, dev)
                below = strided(rng, (B, fb_ + 1, C), dt, dev)
                ra, rd = axis0.axis0_fw_plain(x, wt, above=above, below=below)
                ta, td = forms(x, a, d, (above, below))
                errs["axis0_fw_halo_tiled"] = max(rel_err(ta, ra),
                                                  rel_err(td, rd))
                if R >= max(fa_, fb_):
                    pa_, pd_ = forms(x, a, d)
                    ha, hd = forms(x, a, d, (x[:, R - fa_:], x[:, :fb_]))
                    require(torch.equal(ha, pa_) and torch.equal(hd, pd_),
                            f"I in halo mode with wrapped halos equals the "
                            f"periodic tiled level: {wname} {(B, R, C)} {dt}")
                check_all("kernels3d", errs, (wname, B, R, C), dt, tol, worst)
                cases += 1
    return cases


def phase_kernels3d(dev):
    rng = np.random.default_rng(3)
    worst = {}
    cases = 0
    nan = float("nan")
    for (wname, kind) in WAVELETS:
        wt = wavelet(wname, kind)
        for dt, tol in TOL.items():
            for B, R, C in SHAPES_A0:
                base = torch.from_numpy(rng.standard_normal(
                    (B, R + 3, C + 7))).to(dev).to(dt)
                x = base[:, 1:R + 1, 2:C + 2]   # gaps between rows, items
                # the outputs in the 3-D driver's layout: rows of (R/2, B, C)
                a = torch.full((R // 2, B, C), nan, dtype=dt,
                               device=dev).permute(1, 0, 2)
                d = torch.full((R // 2, B, C + 1), nan, dtype=dt,
                               device=dev)[:, :, :C].permute(1, 0, 2)
                errs = {}
                ra, rd = axis0.axis0_fw_plain(x, wt)
                launched("axis0_fw", lambda: axis0.axis0_fw(x, wt, a, d))
                errs["axis0_fw"] = max(rel_err(a, ra), rel_err(d, rd))
                ri = axis0.axis0_inv_plain(a, d, wt)
                gi = launched("axis0_inv", lambda: axis0.axis0_inv(a, d, wt))
                errs["axis0_inv"] = rel_err(gi, ri)
                corner = torch.from_numpy(rng.standard_normal(
                    ((B + 1) // 2, R // 2, (C + 1) // 2))).to(dev).to(dt)
                rc = axis0.axis0_inv_plain(a, d, wt, corner=corner)
                gc = launched("axis0_inv", lambda: axis0.axis0_inv(
                    a, d, wt, corner=corner))
                errs["axis0_inv_corner"] = rel_err(gc, rc)
                check_all("kernels3d", errs, (wname, B, R, C), dt, tol,
                          worst)
                cases += 1
    cases += check_inv_a0(dev, rng, worst)
    cases += check_fw_a0(dev, rng, worst)
    emit({"phase": "kernels3d", "cases": cases,
          "shapes": [list(r) for r in SHAPES_A0],
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst})


def same_bits(a, b):
    """Whether ``a`` and ``b`` hold the same bits (NaN and -0 included)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_kernelslevel3d(dev):
    """Phase 2h: the one-pass 3-D level against the A+I / J+B chain."""
    gen = torch.Generator(device=dev).manual_seed(8)
    cases, errs = 0, {}
    for shape in SHAPES_LEVEL3:
        x64 = torch.randn(shape, generator=gen, device=dev,
                          dtype=torch.float64)
        kinds = ("lifting",) if shape[0] >= 512 else ("lifting", "filter")
        for kind in kinds:
            wt = wavelet("haar", kind)
            for L in (1, 2, 3):
                for dt in (torch.float32, torch.float64):
                    x = x64.to(dt)
                    before = counts()[0]["level3_fw"]
                    y = dwt3d.one_pass_fw(x, wt, L)
                    torch.cuda.synchronize()
                    require(counts()[0]["level3_fw"] == before + L,
                            "one level3_fw launch a level")
                    yc = dwt3d.chain_fw(x, wt, L)
                    require(same_bits(y, yc), f"level3_fw {kind} {shape} "
                            f"L{L} {dt}: bit for bit the A+I chain")
                    xr = dwt3d.one_pass_inv(yc, wt, L)
                    xc = dwt3d.chain_inv(yc, wt, L)
                    require(same_bits(xr, xc), f"level3_inv {kind} {shape} "
                            f"L{L} {dt}: bit for bit the J+B chain")
                    del y, yc, xr, xc
                    cases += 1
                # bfloat16: no further from the float64 chain than the
                # chain, forward and inverse
                xb = x64.to(torch.bfloat16)
                ref = dwt3d.chain_fw(xb.double(), wt, L)
                yb, ycb = dwt3d.one_pass_fw(xb, wt, L), dwt3d.chain_fw(
                    xb, wt, L)
                e_fw, e_fw_chain = max_abs(yb, ref), max_abs(ycb, ref)
                refi = dwt3d.chain_inv(ycb.double(), wt, L)
                e_inv = max_abs(dwt3d.one_pass_inv(ycb, wt, L), refi)
                e_inv_chain = max_abs(dwt3d.chain_inv(ycb, wt, L), refi)
                require(e_fw <= e_fw_chain and e_inv <= e_inv_chain,
                        f"level3 bf16 {kind} {shape} L{L}: {e_fw:.3e} / "
                        f"{e_inv:.3e} against the chain's {e_fw_chain:.3e} "
                        f"/ {e_inv_chain:.3e}")
                errs[f"{kind}_{'x'.join(map(str, shape))}_L{L}"] = {
                    "fw": e_fw, "fw_chain": e_fw_chain, "inv": e_inv,
                    "inv_chain": e_inv_chain}
                del xb, ref, yb, ycb, refi
                cases += 1
        del x64
        torch.cuda.empty_cache()
    # the public route: haar one launch a level, cdf97 and db2 the chain
    x = torch.randn((32, 16, 64), generator=gen, device=dev)
    for (name, kind), route in ((("haar", "lifting"), {"level3_fw": 2,
                                                       "level3_inv": 2}),
                                (("haar", "filter"), {"level3_fw": 2,
                                                      "level3_inv": 2}),
                                (("cdf97", "lifting"), {
                                    "level_fw": 2, "axis0_fw": 2,
                                    "axis0_inv": 2, "level_inv": 2}),
                                (("db2", "filter"), {
                                    "level_fw": 2, "axis0_fw": 2,
                                    "axis0_inv": 2, "level_inv": 2})):
        wt = wavelet(name, kind)
        run_route(f"3d {name} {kind}", lambda v: w.dwt(v, wt, 2),
                  lambda v: w.idwt(v, wt, 2), x, route)
        cases += 1
    emit({"phase": "kernelslevel3d", "cases": cases,
          "shapes": [list(t) for t in SHAPES_LEVEL3],
          "f32_f64": "bit for bit the A+I / J+B chain",
          "bf16_max_abs_err_vs_f64_chain": errs})


def phase_kernelsmodwt(dev):
    rng = np.random.default_rng(4)
    worst = {}
    cases = 0
    for (wname, kind) in WAVELETS_MODWT:
        wt = wavelet(wname, kind)
        for dt, tol in TOL.items():
            for B, N, j in ROWS_MODWT:
                v = torch.from_numpy(rng.standard_normal((B, N))).to(
                    dev).to(dt)
                # the driver's layout: v1 into a row, w1 into a column
                cols = torch.full((B, N, 3), float("nan"), dtype=dt,
                                  device=dev)
                errs = {}
                rv, rw = modwt1d.modwt_fw_plain(v, wt, j)
                launched("modwt_fw", lambda: modwt1d.modwt_fw(
                    v, wt, j, cols[..., 2], cols[..., 0]))
                errs["modwt_fw"] = max(rel_err(cols[..., 2], rv),
                                       rel_err(cols[..., 0], rw))
                ri = modwt1d.modwt_inv_plain(cols[..., 2], cols[..., 0], wt, j)
                gi = launched("modwt_inv", lambda: modwt1d.modwt_inv(
                    cols[..., 2], cols[..., 0], wt, j))
                errs["modwt_inv"] = rel_err(gi, ri)
                check_all("kernelsmodwt", errs, (wname, B, N, j), dt, tol,
                          worst)
                cases += 1
    chain, plans = check_modwt_levels(dev, rng, worst)
    ichain, iplans = check_modwt_inv_levels(dev, rng, worst)
    emit({"phase": "kernelsmodwt", "cases": cases,
          "rows": [list(r) for r in ROWS_MODWT],
          "levels_rows": [list(r) for r in ROWS_MODWT_LEVELS],
          "levels_bit_equal_to_chain": {k: all(v) for k, v in chain.items()},
          "levels_chain_cases": {k: len(v) for k, v in chain.items()},
          "levels_cluster_sizes": sorted({p[-1] for p in plans}),
          "inv_levels_bit_equal_to_chain": {k: all(v)
                                            for k, v in ichain.items()},
          "inv_levels_chain_cases": {k: len(v) for k, v in ichain.items()},
          "inv_levels_cluster_sizes": sorted({p[-1] for p in iplans}),
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst})


def modwt_chain(x, wt, L):
    """L launches of kernel K into the (B, N, L+1) layout, each on the
    scaling band of the one before: what modwt_fw_levels computes in one
    launch."""
    B, N = x.shape
    out = torch.empty((B, N, L + 1), dtype=x.dtype, device=x.device)
    v = x
    for j in range(1, L + 1):
        v1 = out[..., L] if j == L else torch.empty((B, N), dtype=x.dtype,
                                                    device=x.device)
        modwt1d.modwt_fw(v, wt, j, v1, out[..., j - 1])
        v = v1
    return out


def check_modwt_levels(dev, rng, worst):
    """modwt_fw_levels on ROWS_MODWT_LEVELS for every wavelet and dtype:
    against its plain version, and whether it equals the chain of K
    launches bit for bit (required in all three dtypes); every cluster
    size 1-16 must occur; the rows of ROWS_MODWT_UNPLANNED must lie beyond
    the plan, and the wrapper must refuse them."""
    chain, plans = {}, set()
    for (wname, kind) in WAVELETS_MODWT:
        wt = wavelet(wname, kind)
        nt = len(modwt_ops.modwt_filter_pair(wt)[0])
        for dt, tol in TOL.items():
            key = str(dt)[6:]
            for B, N, L in ROWS_MODWT_LEVELS:
                plan = modwt1d.modwt_plan(N, L, nt, dt, B)
                require(plan.fits, f"modwt_plan fits {(B, N, L)} {wname} {dt}")
                plans.add((wname, B, N, L, key, plan.cluster))
                x = torch.from_numpy(rng.standard_normal((B, N))).to(dev).to(
                    dt)
                got = launched("modwt_fw_levels",
                               lambda: modwt1d.modwt_fw_levels(x, wt, L))
                check_all("kernelsmodwt", {
                    "modwt_fw_levels": rel_err(
                        got, modwt1d.modwt_fw_levels_plain(x, wt, L))},
                    (wname, B, N, L), dt, tol, worst)
                chain.setdefault(key, []).append(
                    torch.equal(got, modwt_chain(x, wt, L)))
            for B, N, L in ROWS_MODWT_UNPLANNED:
                require(not modwt1d.modwt_plan(N, L, nt, dt, B).fits,
                        f"{(B, N, L)} {wname} {dt} lies beyond the plan")
        # a strided input: every other sample of wider rows
        xv = torch.from_numpy(rng.standard_normal((3, 2000))).to(dev).float()
        got = modwt1d.modwt_fw_levels(xv[:, ::2], wt, 5)
        chain["float32"].append(torch.equal(got, modwt_chain(xv[:, ::2], wt,
                                                             5)))
    try:
        modwt1d.modwt_fw_levels(torch.zeros((3, 1 << 17), device=dev), wt, 13)
        refused = False
    except ValueError:
        refused = True
    require(refused, "modwt_fw_levels refuses a row beyond its plan")
    for key in ("float32", "float64", "bfloat16"):
        require(all(chain[key]), f"modwt_fw_levels bit-equal to chains of K "
                f"launches: {key}")
    sizes = sorted({p[-1] for p in plans})
    require(sizes == [1, 2, 4, 8, 16], f"cluster sizes {sizes}")
    return chain, plans


def modwt_inv_chain(xw, wt):
    """L launches of kernel M from ``xw (B, N, L+1)``, deepest level first,
    each on the scaling band of the one before: what modwt_inv_levels
    computes in one launch."""
    L = xw.shape[2] - 1
    v = xw[..., L]
    for j in range(L, 0, -1):
        v = modwt1d.modwt_inv(v, xw[..., j - 1], wt, j)
    return v


def check_modwt_inv_levels(dev, rng, worst):
    """modwt_inv_levels on ROWS_MODWT_LEVELS for every wavelet and dtype,
    over NaN-filled outputs: against its plain version, and whether it
    equals the chain of M launches bit for bit (required in all three
    dtypes); db4 reads every other item of a wider batch (a batch
    stride); every cluster size 1-16 must occur; the rows of
    ROWS_MODWT_UNPLANNED must lie beyond the plan, and the wrapper must
    refuse them."""
    chain, plans = {}, set()
    nan = float("nan")
    for (wname, kind) in WAVELETS_MODWT:
        wt = wavelet(wname, kind)
        nt = len(modwt_ops.modwt_filter_pair(wt)[0])
        step = 2 if wname == "db4" else 1
        for dt, tol in TOL.items():
            key = str(dt)[6:]
            for B, N, L in ROWS_MODWT_LEVELS:
                plan = modwt1d.modwt_inv_plan(N, L, nt, dt, B)
                require(plan.fits,
                        f"modwt_inv_plan fits {(B, N, L)} {wname} {dt}")
                plans.add((wname, B, N, L, key, plan.cluster))
                xw = torch.from_numpy(rng.standard_normal(
                    (step * B, N, L + 1))).to(dev).to(dt)[::step]
                got = torch.full((B, N), nan, dtype=dt, device=dev)
                launched("modwt_inv_levels",
                         lambda: modwt1d.modwt_inv_levels(xw, wt, got))
                check_all("kernelsmodwt", {
                    "modwt_inv_levels": rel_err(
                        got, modwt1d.modwt_inv_levels_plain(xw, wt))},
                    (wname, B, N, L), dt, tol, worst)
                chain.setdefault(key, []).append(
                    torch.equal(got, modwt_inv_chain(xw, wt)))
            for B, N, L in ROWS_MODWT_UNPLANNED:
                require(not modwt1d.modwt_inv_plan(N, L, nt, dt, B).fits,
                        f"{(B, N, L)} {wname} {dt} lies beyond the inverse's "
                        "plan")
    try:
        modwt1d.modwt_inv_levels(torch.zeros((3, 1 << 17, 14), device=dev),
                                 wt)
        refused = False
    except ValueError:
        refused = True
    require(refused, "modwt_inv_levels refuses a row beyond its plan")
    for key in ("float32", "float64", "bfloat16"):
        require(all(chain[key]), f"modwt_inv_levels bit-equal to chains of "
                f"M launches: {key}")
    sizes = sorted({p[-1] for p in plans})
    require(sizes == [1, 2, 4, 8, 16], f"inverse cluster sizes {sizes}")
    return chain, plans


def halo_height(wt):
    """H: the rows a level reads beyond the view, in either direction and
    for either pass (the inverse's on the half rows)."""
    fa, fb = axis0.halo_reach(wt, False)
    ia, ib = axis0.halo_reach(wt, True)
    return max(fa, fb, 2 * ia, 2 * ib, 1)


def strided(rng, shape, dt, dev):
    """A random ``shape`` view with gaps between its rows and items."""
    B, R, C = shape
    base = torch.from_numpy(rng.standard_normal((B, R + 3, C + 7))).to(
        dev).to(dt)
    return base[:, 1:R + 1, 2:C + 2]


def phase_kernelshalo(dev, shapes=SHAPES_HALO):
    rng = np.random.default_rng(5)
    worst = {}
    cases = 0
    for (wname, kind) in WAVELETS_HALO:
        wt = wavelet(wname, kind)
        fa, fb = axis0.halo_reach(wt, False)
        ia, ib = axis0.halo_reach(wt, True)
        H = halo_height(wt)
        for dt, tol in TOL.items():
            for B, R, C in shapes:
                R = 2 * H if R == "2H" else R
                Rh = R // 2
                x = strided(rng, (B, R, C), dt, dev)
                errs = {}
                # halos equal to the wrapped rows: bit for bit the periodic
                # kernels, forward and inverse
                a, d = launched("axis0_fw", lambda: axis0.axis0_fw(x, wt))
                ah, dh = launched("axis0_fw_halo", lambda: axis0.axis0_fw(
                    x, wt, above=x[:, R - fa:], below=x[:, :fb]))
                require(torch.equal(a, ah) and torch.equal(d, dh),
                        f"halo fw with wrapped halos equals the periodic "
                        f"kernel: {wname} {(B, R, C)} {dt}")
                xi = launched("axis0_inv", lambda: axis0.axis0_inv(a, d, wt))
                xh = launched("axis0_inv_halo", lambda: axis0.axis0_inv(
                    a, d, wt, halos=(a[:, Rh - ia:], a[:, :ib],
                                     d[:, Rh - ia:], d[:, :ib])))
                require(torch.equal(xi, xh),
                        f"halo inv with wrapped halos equals the periodic "
                        f"kernel: {wname} {(B, R, C)} {dt}")
                # random halos, taller than the reach, into the 3-D
                # driver's permuted output layout
                above = strided(rng, (B, fa + 2, C), dt, dev)
                below = strided(rng, (B, fb + 1, C), dt, dev)
                po = torch.full((Rh, B, 2 * C + 1), float("nan"), dtype=dt,
                                device=dev)
                pa = po[:, :, :C].permute(1, 0, 2)
                pd = po[:, :, C + 1:].permute(1, 0, 2)
                ra, rd = axis0.axis0_fw_plain(x, wt, above=above,
                                              below=below)
                launched("axis0_fw_halo", lambda: axis0.axis0_fw(
                    x, wt, pa, pd, above=above, below=below))
                errs["axis0_fw_halo"] = max(rel_err(pa, ra), rel_err(pd, rd))
                halos = (strided(rng, (B, ia + 1, C), dt, dev),
                         strided(rng, (B, ib + 2, C), dt, dev),
                         strided(rng, (B, ia + 1, C), dt, dev),
                         strided(rng, (B, ib, C), dt, dev))
                ri = axis0.axis0_inv_plain(pa, pd, wt, halos=halos)
                gi = launched("axis0_inv_halo", lambda: axis0.axis0_inv(
                    pa, pd, wt, halos=halos))
                errs["axis0_inv_halo"] = rel_err(gi, ri)
                # J's 16-byte staging path (where C is whole words):
                # contiguous planes and halos, the one below d zero rows
                # tall where the reach is 0 (haar)
                halos = tuple(
                    torch.empty((B, hgt, C), dtype=dt, device=dev).copy_(
                        torch.from_numpy(rng.standard_normal((B, hgt, C))))
                    for hgt in (ia + 1, ib + 2, ia + 1, ib))
                ri = axis0.axis0_inv_plain(a, d, wt, halos=halos)
                gi = launched("axis0_inv_halo", lambda: axis0.axis0_inv(
                    a, d, wt, halos=halos))
                errs["axis0_inv_halo_aligned"] = rel_err(gi, ri)
                check_all("kernelshalo", errs, (wname, B, R, C), dt, tol,
                          worst)
                cases += 1
    emit({"phase": "kernelshalo", "cases": cases,
          "shapes": [list(r) for r in shapes],
          "wrapped_halos_bit_equal": True,
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst})


def phase_kernelsstage(dev):
    """Kernel N through its wrapper (the strip form below a span of 16, the
    first form above: coif4) on strided views (the 4-byte staging path)
    and contiguous images (the 16-byte path), LL2 into a scratch and into
    the packed corner, over NaN-filled planes: against the plain version,
    bit for bit against two A launches (f32, bf16), and, where the strip
    form runs, bit for bit against the first form (launched with strips
    off) in every dtype."""
    rng = np.random.default_rng(6)
    worst, bit_equal, first_equal = {}, {}, {}
    cases = 0
    nan = float("nan")
    stream = torch.cuda.current_stream().cuda_stream
    for (wname, kind) in WAVELETS_STAGE:
        wt = wavelet(wname, kind)
        strips = bool(stage2d.stage_window(wt))
        for dt, tol in TOL.items():
            for B, m, n in SHAPES_STAGE:
                xs_ = strided(rng, (B, m, n), dt, dev)
                for path in ("4", "16"):
                    # both staging paths on the same image
                    x = xs_ if path == "4" else xs_.contiguous()
                    # 16-byte words where x's base, strides and n allow
                    # (not n = 4 in bf16)
                    want = 16 if path == "16" and n * x.element_size() % 16 \
                        == 0 else 4
                    plan = stage2d.stage_plan(x, wt)
                    require(plan.staging == (want if strips else 0),
                            f"N {wname} {(B, m, n)} {dt} stages by {want} "
                            f"bytes: {plan}")
                    ref = stage2d.stage2_fw_plain(x, wt)
                    errs = {}
                    # LL2 into a scratch of its own, or into the packed
                    # corner (a transform of two levels)
                    for mode in ("scratch", "corner"):
                        y = torch.full((B, m, n), nan, dtype=dt, device=dev)
                        ll2 = (y[:, : m >> 2, : n >> 2] if mode == "corner"
                               else torch.empty_like(ref[0]))
                        outs = (ll2, *level2d.detail_planes(y, 1),
                                *level2d.detail_planes(y, 2))
                        launched("stage2_fw", lambda: stage2d.stage2_fw(
                            x, wt, outs))
                        errs[f"stage2_fw_{mode}_{path}byte"] = max(
                            map(rel_err, outs, ref))
                        left = torch.isnan(y)
                        require(bool(left[:, : m >> 2, : n >> 2].all())
                                if mode == "scratch" else not bool(left.any()),
                                f"stage2_fw writes exactly its planes: {wname} "
                                f"{(B, m, n)} {dt} {mode} {path}-byte")
                    ll1, *d1 = level2d.level_fw(x, wt)
                    two = level2d.level_fw(ll1, wt)
                    key = str(dt)[6:]
                    bit_equal[key] = bit_equal.get(key, True) and all(
                        torch.equal(g, r) for g, r in zip(
                            outs, (two[0], *d1, *two[1:])))
                    if strips:
                        yf = torch.full((B, m, n), nan, dtype=dt, device=dev)
                        first = (yf[:, : m >> 2, : n >> 2],
                                 *level2d.detail_planes(yf, 1),
                                 *level2d.detail_planes(yf, 2))
                        launch_form(stage2d._SITE, wt, x, first,
                                    stream=stream, strips=False)
                        torch.cuda.synchronize()
                        first_equal[key] = first_equal.get(key, True) and \
                            torch.equal(yf, y)
                    check_all("kernelsstage", errs, (wname, B, m, n), dt, tol,
                              worst)
                    cases += 1
    fresh = stage_fresh_draws(dev)
    require(bit_equal["float32"] and bit_equal["bfloat16"],
            f"N bit-equal to two A launches in f32 and bf16: {bit_equal}")
    require(all(first_equal.values()),
            f"N's strip form bit-equal to its first form: {first_equal}")
    emit({"phase": "kernelsstage", "cases": cases, "fresh_bf16": fresh,
          "shapes": [list(r) for r in SHAPES_STAGE],
          "wavelets": [nm for nm, _ in WAVELETS_STAGE],
          "tolerance": {str(k)[6:]: v for k, v in TOL.items()},
          "worst_rel_err": worst, "bit_equal_to_two_A_launches": bit_equal,
          "strips_bit_equal_to_first_form": first_equal})


def stage_fresh_draws(dev):
    """Kernel N on fresh bf16 draws from a seed of their own
    (STAGE_FRESH_SEED): each wavelet of WAVELETS_STAGE on a 4 x 4 image
    STAGE_FRESH_4x4 times and on each shape of SHAPES_STAGE once, strided
    and contiguous, against its plain version (which sums as kernel A
    does, so LL1 rounds from A's value) within 2^-7, and bit for bit
    against two A launches."""
    rng = np.random.default_rng(STAGE_FRESH_SEED)
    dt, tol = torch.bfloat16, TOL[torch.bfloat16]
    cases, worst, equal = 0, 0.0, True
    shapes = ((1, 4, 4),) * STAGE_FRESH_4x4 + SHAPES_STAGE
    for (wname, kind) in WAVELETS_STAGE:
        wt = wavelet(wname, kind)
        for B, m, n in shapes:
            xs_ = strided(rng, (B, m, n), dt, dev)
            for x in (xs_, xs_.contiguous()):
                outs = launched("stage2_fw", lambda: stage2d.stage2_fw(x, wt))
                e = max(map(rel_err, outs, stage2d.stage2_fw_plain(x, wt)))
                require(e <= tol, f"N fresh bf16 draw {wname} {(B, m, n)}: "
                        f"rel err {e:.3e} > {tol:.1e}")
                worst = max(worst, e)
                ll1, *d1 = level2d.level_fw(x, wt)
                two = level2d.level_fw(ll1, wt)
                equal = equal and all(torch.equal(g, r) for g, r in zip(
                    outs, (two[0], *d1, *two[1:])))
                cases += 1
    require(equal, "N bit-equal to two A launches on the fresh bf16 draws")
    return {"seed": STAGE_FRESH_SEED, "cases": cases, "worst_rel_err": worst,
            "bit_equal_to_two_A_launches": equal}


# the graph store's cases: (B, m, n, L), each on every route and dtype but
# the last, which runs once (level route, f32)
GRAPH_CASES = ((1, 1024, 1024, 10), (8, 256, 256, 6))
GRAPH_BIG = (1, SIZE, SIZE, LEVELS)
GRAPH_CALLS, GRAPH_INPUTS = 20, 4


@contextlib.contextmanager
def graph_store(limit):
    """The 2-D driver with a store of its own, keeping at most ``limit``
    signatures (0: every call runs the wrappers), and a counter of its
    own; yields the counter."""
    saved = pyramid2d._graphs
    counter = dict.fromkeys(pyramid2d.GRAPHS, 0)
    pyramid2d._graphs = graph.Store(counter, "pyramid2d.replay", limit)
    try:
        yield counter
    finally:
        pyramid2d._graphs = saved


def graph_signature(fn, xs, wt, L, route):
    """``GRAPH_CALLS`` calls of ``fn`` over the rotating inputs ``xs``,
    every output kept, each held bit for bit against the wrappers' output
    for its input; then one call on a side stream.  Returns the rise of
    the store's counter and the number of outputs checked."""
    counter = pyramid2d._graphs.counter
    with graph_store(0):
        refs = [fn(x, wt, L, route=route) for x in xs]
    before = dict(counter)
    outs = [fn(xs[i % len(xs)], wt, L, route=route)
            for i in range(GRAPH_CALLS)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outs.append(fn(xs[1], wt, L, route=route))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for i, o in enumerate(outs):
        ref = refs[1 if i == GRAPH_CALLS else i % len(xs)]
        require(torch.equal(o, ref),
                f"graph call {i} equals the wrappers' output bit for bit")
    rise = {k: counter[k] - before[k] for k in before}
    return rise, len(outs)


def graph_user_capture(xs, wt, L):
    """A forward call inside a caller's torch.cuda.graph capture runs the
    wrappers, and the caller's graph replays to the wrappers' bits."""
    counter = pyramid2d._graphs.counter
    with graph_store(0):
        refs = [pyramid2d.dwt2(x, wt, L) for x in xs[:2]]
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up, as torch asks
        pyramid2d.dwt2(static, wt, L)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    before = dict(counter)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = pyramid2d.dwt2(static, wt, L)
    rise = {k: counter[k] - before[k] for k in before}
    require(rise == {"captures": 0, "replays": 0, "fallbacks": 0,
                     "plain": 1},
            f"a call under a caller's capture runs the wrappers: {rise}")
    for i in (1, 0):
        static.copy_(xs[i])
        g.replay()
        torch.cuda.synchronize()
        require(torch.equal(got, refs[i]),
                "the caller's graph replays to the wrappers' bits")
    return rise


def graph_trace(xs, wt, L):
    """Replays under the profiler: the program's kernels in the trace
    equal the rise of the launch counters."""
    counter = pyramid2d._graphs.counter
    for x in xs:
        pyramid2d.idwt2(pyramid2d.dwt2(x, wt, L), wt, L)
    torch.cuda.synchronize()
    launches0 = sum(counts()[0].values())
    before = dict(counter)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for x in xs * 5:
            pyramid2d.idwt2(pyramid2d.dwt2(x, wt, L), wt, L)
        torch.cuda.synchronize()
    rise = sum(counts()[0].values()) - launches0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    replays = counter["replays"] - before["replays"]
    require(replays == 2 * len(xs) * 5, f"every call replayed: {replays}")
    require(len(kernels) == rise,
            f"the trace holds {len(kernels)} kernels where the launch "
            f"counters rose by {rise}")
    return {"replays": replays, "kernels": len(kernels), "launches": rise}


def phase_graphs(dev):
    """Phase 2g (the module docstring), on a store of its own."""
    with graph_store(graph.GRAPH_LIMIT) as counter:
        graph_cases(dev, counter)


def graph_cases(dev, counter):
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows, checked = [], 0
    cases = [(c, dt, route) for c in GRAPH_CASES
             for dt in (torch.float32, torch.float64, torch.bfloat16)
             for route in pyramid2d.ROUTES]
    cases.append((GRAPH_BIG, torch.float32, "level"))
    wt = wavelet("cdf97", "lifting")
    for (B, m, n, L), dt, route in cases:
        xs = [torch.randn((B, m, n), generator=gen, device=dev).to(dt)
              for _ in range(GRAPH_INPUTS)]
        for name, fn, r in (("dwt2", pyramid2d.dwt2, route),
                            ("idwt2", pyramid2d.idwt2,
                             "level" if route == "stage" else route)):
            rise, n_out = graph_signature(fn, xs, wt, L, r)
            # a signature's first call runs the wrappers, its second
            # captures; a signature met before (the stage route's
            # inverse is the level route's) replays from its first
            fresh = not (name == "idwt2" and route == "stage")
            want = {"captures": int(fresh), "replays":
                    GRAPH_CALLS + 1 - 2 * fresh, "fallbacks": 0,
                    "plain": int(fresh)}
            refused = [e.refused for e in pyramid2d._graphs.entries.values()
                       if e.refused is not None]
            require(rise == want, f"{name} {route} {dt} {(B, m, n, L)}: "
                    f"calls by path {rise}, expected {want}; refused: "
                    f"{refused}")
            checked += n_out
            rows.append(f"{name}/{r}/{str(dt)[6:]}/{B}x{m}x{n}/L{L}")
        del xs
        torch.cuda.empty_cache()
    xs = [torch.randn((1, 1024, 1024), generator=gen, device=dev)
          for _ in range(GRAPH_INPUTS)]
    user = graph_user_capture(xs, wt, 10)
    traced = graph_trace(xs, wt, 10)
    emit({"phase": "graphs", "signatures": rows, "outputs_checked": checked,
          "calls_by_path": dict(counter), "user_capture": user,
          "trace": traced})


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
    expected = {k: 0 for k in launches}
    expected.update({"level_fw": k_fw, "tail_fw": int(k_fw < LEVELS),
                     "level_inv": k_inv, "tail_inv": int(k_inv < LEVELS)})
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
    """The inputs of the 1-D, MODWT and 3-D paths, drawn as
    bench.py:180-193 draws them from default_rng(1) (the 2^20 signal, the
    (512, 8192) rows, the 256^3 volume, the (4096, 4096) rows), and the
    2^24 signal drawn next."""
    rng = np.random.default_rng(1)
    shapes = ((1 << 20,), MODWT_SHAPE, (SIZE3D,) * 3, (4096, 4096),
              (1 << 24,))
    return {shape: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev) for shape in shapes}


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


def run_route(name, fw, inv, x, route):
    """One forward and one inverse call with the counts set to 0 just
    before and read just after: the launches must be ``route`` (every
    other kernel 0) and no plain version may run."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = fw(x)
    xr = inv(y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = counts()
    expected = {k: 0 for k in launches}
    expected.update(route)
    require(launches == expected, f"{name} route {launches}")
    require(not any(plain.values()), f"{name}: no plain version ran")
    require(bool(torch.isfinite(y).all()), f"{name} finite")
    rt = (xr - x).abs().max().item()
    require(rt <= 1e-3, f"{name} f32 round trip {rt:.3e} <= 1e-3")
    return y, launches, wall, rt


def phase_main1d(xs):
    total = {}
    for name, shape, (wname, kind), L, packet in PATHS1D:
        wt = wavelet(wname, kind)
        x = xs[shape]
        fw, inv = path_fns(shape, wt, L, packet)
        y, launches, wall, rt = run_route(name, fw, inv, x, ROUTES1D[name])
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        require(y.shape == x.shape and y.dtype == x.dtype, f"{name} shape")
        pfw, _ = path_fns(shape, wt, L, packet, plain=True)
        e64 = rel_err(y, pfw(x.double()))
        require(e64 <= 1e-3, f"{name} f32 vs plain f64 {e64:.3e} <= 1e-3")
        out = {"phase": "main1d", "path": name, "shape": list(shape),
               "levels": L, "dtype": "float32", "launches": ROUTES1D[name],
               "plain_calls": 0, "wall_s_first_call_pair": wall,
               "roundtrip_max_abs_err": rt, "f32_vs_plain_f64_rel_err": e64}
        if name == "single_2e20_db2_L20":
            x64 = x.double()
            rt64 = (inv(fw(x64)) - x64).abs().max().item()
            require(rt64 <= 1e-12, f"{name} f64 round trip {rt64:.3e}")
            out["f64_roundtrip_max_abs_err"] = rt64
        emit(out)
    return total


def phase_main3d(x3):
    wt = wavelet("cdf97", "lifting")
    L = LEVELS3D
    route = {"level_fw": L, "axis0_fw": L, "axis0_inv": L, "level_inv": L}
    y, launches, wall, rt = run_route(
        "3d", lambda v: w.dwt(v, wt, L), lambda v: w.idwt(v, wt, L), x3,
        route)
    require(y.shape == x3.shape and y.dtype == x3.dtype, "3d packed shape")
    y64 = dwt3d.dwt3(x3.double(), wt, L, plain=True)
    e32 = rel_err(y, y64)
    require(e32 <= 1e-3, f"256^3 f32 vs plain f64 {e32:.3e} <= 1e-3")
    del y, y64
    x128 = x3[:128, :128, :128].double()
    rt64 = (w.idwt(w.dwt(x128, wt, L), wt, L) - x128).abs().max().item()
    require(rt64 <= 1e-12, f"128^3 f64 round trip {rt64:.3e} <= 1e-12")
    xs = x3[:32, :32, :32].double()
    es = rel_err(w.dwt(xs, wt, L), lifting.dwt_nd_lifting(xs, wt, L, 3))
    require(es <= 1e-12, f"32^3 f64 vs lifting engine {es:.3e} <= 1e-12")
    # haar: one launch of the one-pass level a level
    haar = wavelet("haar", "lifting")
    route_h = {"level3_fw": L, "level3_inv": L}
    yh, launches_h, wall_h, rt_h = run_route(
        "3d haar", lambda v: w.dwt(v, haar, L), lambda v: w.idwt(v, haar, L),
        x3, route_h)
    eh = rel_err(yh, dwt3d.dwt3(x3.double(), haar, L, plain=True))
    require(eh <= 1e-5, f"256^3 haar f32 vs plain f64 {eh:.3e} <= 1e-5")
    del yh
    rth = (w.idwt(w.dwt(x128, haar, L), haar, L) - x128).abs().max().item()
    require(rth <= 1e-12, f"128^3 haar f64 round trip {rth:.3e} <= 1e-12")
    emit({"phase": "main3d", "shape": list(x3.shape), "levels": L,
          "dtype": "float32", "launches": route,
          "wall_s_first_call_pair": wall, "roundtrip_max_abs_err": rt,
          "f32_vs_plain_f64_rel_err": e32,
          "f64_roundtrip_128_max_abs_err": rt64,
          "f64_vs_lifting_engine_32_rel_err": es,
          "haar": {"launches": route_h, "wall_s_first_call_pair": wall_h,
                   "roundtrip_max_abs_err": rt_h,
                   "f32_vs_plain_f64_rel_err": eh,
                   "f64_roundtrip_128_max_abs_err": rth}})
    return {**launches, **{k: v for k, v in launches_h.items() if v}}


def phase_mainmodwt(xm, xlong):
    wt = wavelet("db4", "filter")
    L = MODWT_LEVELS
    route = {"modwt_fw_levels": 1, "modwt_inv_levels": 1}
    W, launches, wall, rt = run_route(
        "modwt", lambda v: w.modwt(v, wt, L), lambda v: w.imodwt(v, wt), xm,
        route)
    require(W.shape == (*xm.shape, L + 1) and W.dtype == xm.dtype,
            "modwt output shape")
    W64 = modwt1d.modwt(xm.double(), wt, L, plain=True)
    e32 = rel_err(W, W64)
    require(e32 <= 1e-3, f"modwt f32 vs plain f64 {e32:.3e} <= 1e-3")
    del W, W64
    x64 = xm.double()
    rt64 = (w.imodwt(w.modwt(x64, wt, L), wt) - x64).abs().max().item()
    require(rt64 <= 1e-12, f"modwt f64 round trip {rt64:.3e} <= 1e-12")
    xs = x64[:8]
    es = rel_err(w.modwt(xs, wt, L), modwt_ops.modwt(xs, wt, L))
    require(es <= 1e-12, f"modwt f64 vs torch engine {es:.3e} <= 1e-12")
    emit({"phase": "mainmodwt", "shape": list(xm.shape), "levels": L,
          "dtype": "float32", "launches": route,
          "wall_s_first_call_pair": wall, "roundtrip_max_abs_err": rt,
          "f32_vs_plain_f64_rel_err": e32,
          "f64_roundtrip_max_abs_err": rt64,
          "f64_vs_torch_engine_rel_err": es})
    # rows too long for the plan: one K and one M launch per level
    Ll = MODWT_LONG_LEVELS
    require(not modwt1d.modwt_plan(xlong.shape[1], Ll, len(wt.qmf),
                                   xlong.dtype, xlong.shape[0]).fits,
            "the long rows lie beyond the plan")
    long_route = {"modwt_fw": Ll, "modwt_inv": Ll}
    Wl, long_launches, wall_l, rt_l = run_route(
        "modwt_long", lambda v: w.modwt(v, wt, Ll), lambda v: w.imodwt(v, wt),
        xlong, long_route)
    require(Wl.shape == (*xlong.shape, Ll + 1), "long modwt output shape")
    el = rel_err(Wl, modwt1d.modwt(xlong.double(), wt, Ll, plain=True))
    require(el <= 1e-3, f"long modwt f32 vs plain f64 {el:.3e} <= 1e-3")
    del Wl
    emit({"phase": "mainmodwt", "shape": list(xlong.shape), "levels": Ll,
          "dtype": "float32", "launches": long_route,
          "wall_s_first_call_pair": wall_l, "roundtrip_max_abs_err": rt_l,
          "f32_vs_plain_f64_rel_err": el})
    launches["modwt_fw"] = long_launches["modwt_fw"]
    launches["modwt_inv"] = long_launches["modwt_inv"]
    return launches


def rel_l2(got, ref):
    got, ref = got.double(), ref.double()
    return ((got - ref).norm() / ref.norm()).item()


def signal_image(x):
    """A denoising input of ``x``'s size: the HeaviSine test function's
    outer sum plus 0.1 x (x is standard normal noise)."""
    h = torch.from_numpy(w.testfunction(x.shape[0], "HeaviSine")).to(x)
    return h[:, None] + h[None, :] + 0.1 * x


def reset_parallel():
    for d in (psharded.STATS, pmesh.COPIES):
        for k in d:
            d[k] = 0


def level_table(fn, x, L):
    """Launches per level: the counts of ``fn(x, l)`` for l = 1 .. L, each
    less the one before."""
    table, before = [], {}
    for level in range(1, L + 1):
        reset_counts()
        fn(x, level)
        torch.cuda.synchronize()
        now = {k: v for k, v in counts()[0].items() if v}
        table.append({k: v - before.get(k, 0) for k, v in now.items()
                      if v - before.get(k, 0)})
        before = now
    return table


def phase_mainsharded(x, xsig):
    dev = x.device
    wt = w.wavelet(w.wt.cdf97, "lifting")
    mesh = parallel.Mesh([dev] * SHARDS, ("x",))
    reset_counts()
    reset_parallel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ys = parallel.dwt2(x, wt, LEVELS, mesh)
    xr = parallel.idwt2(ys, wt, LEVELS, mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = counts()
    stats, copies = dict(psharded.STATS), dict(pmesh.COPIES)
    expected = {k: 0 for k in launches}
    expected.update({k: SHARDS * LEVELS for k in (
        "level1d_fw", "axis0_fw_halo", "axis0_inv_halo", "level1d_inv")})
    require(launches == expected, f"sharded route {launches}")
    require(not any(plain.values()), f"sharded: no plain version ran {plain}")
    require(stats == {"sharded_levels": 2 * LEVELS, "fallback_levels": 0,
                      "clones": 1}, f"sharded levels {stats}")
    y = ys.gather(dev)
    require(y.shape == x.shape and y.dtype == x.dtype, "sharded shape")
    e32 = rel_err(y, w.dwt(x, wt, LEVELS))
    require(e32 <= 1e-5, f"sharded vs single-card dwt {e32:.3e} <= 1e-5")
    rt = (xr.gather(dev) - x).abs().max().item()
    require(rt <= 1e-3, f"sharded f32 round trip {rt:.3e} <= 1e-3")
    del y, ys, xr
    x2 = x[:2048, :2048].double()
    rt64 = (parallel.idwt2(parallel.dwt2(x2, wt, LEVELS, mesh), wt, LEVELS,
                           mesh).gather(dev) - x2).abs().max().item()
    require(rt64 <= 1e-12, f"sharded f64 round trip {rt64:.3e} <= 1e-12")
    # rank-1 shards (I/J with B = C = 1): a 2^20 signal, 8 levels
    x1 = x.reshape(-1)[: 1 << 20]
    y1 = parallel.dwt1(x1, wt, LEVELS, mesh)
    e1 = rel_err(y1.gather(dev), w.dwt(x1, wt, LEVELS))
    require(e1 <= 1e-5, f"sharded 1-D vs single-card dwt {e1:.3e} <= 1e-5")
    rt1 = (parallel.idwt1(y1, wt, LEVELS, mesh).gather(dev) - x1).abs() \
        .max().item()
    require(rt1 <= 1e-3, f"sharded 1-D f32 round trip {rt1:.3e} <= 1e-3")
    del y1
    fw_table = level_table(lambda v, l: parallel.dwt2(v, wt, l, mesh), x,
                           LEVELS)
    inv_table = level_table(lambda v, l: parallel.idwt2(
        v, wt, l, mesh), x, LEVELS)
    # the distributed denoise against the single card's, on one input
    dn = {}
    for tag, xt in (("f32", xsig), ("f64", xsig.double())):
        got = parallel.denoise(xt, wt, L=DENOISE_LEVELS, mesh=mesh).gather(
            dev)
        ref = w.denoise(xt, wt, L=DENOISE_LEVELS)
        require(bool(torch.isfinite(got).all()), f"denoise {tag} finite")
        dn[tag] = rel_l2(got, ref) if tag == "f32" else rel_err(got, ref)
        del got, ref
    require(dn["f32"] <= 1e-4, f"sharded denoise f32 rel l2 {dn['f32']:.3e}")
    require(dn["f64"] <= 1e-10, f"sharded denoise f64 {dn['f64']:.3e}")
    emit({"phase": "mainsharded", "shape": [SIZE, SIZE], "levels": LEVELS,
          "shards": SHARDS, "mesh": str(mesh), "dtype": "float32",
          "launches": {k: v for k, v in launches.items() if v},
          "launches_per_level_fw": fw_table,
          "launches_per_level_inv": inv_table,
          "levels_run": stats, "copies": copies,
          "wall_s_first_call_pair": wall,
          "vs_single_card_rel_err": e32, "roundtrip_max_abs_err": rt,
          "f64_roundtrip_2048_max_abs_err": rt64,
          "dwt1_2e20_vs_single_card_rel_err": e1,
          "dwt1_2e20_roundtrip_max_abs_err": rt1,
          "denoise_L6_vs_single_card_f32_rel_l2": dn["f32"],
          "denoise_L6_vs_single_card_f64_rel_err": dn["f64"]})
    return launches


def basis_cost(tree, y, wt):
    """The Shannon entropy of the basis that ``tree`` selects for ``y``:
    the before-entropies of its leaves, in y's dtype on y's device."""
    n = y.numel()
    et = w.ShannonEntropy()
    nrm = torch.linalg.norm(y)
    x, cost = y, 0.0
    reached = np.ones(1, dtype=bool)
    D = (len(tree) + 1).bit_length() - 1
    for d in range(D):
        segs = x.reshape(2 ** d, -1)
        e = th_entropy._coef_terms(segs, et, nrm).sum(-1).cpu().numpy()
        split = tree[2 ** d - 1: 2 ** (d + 1) - 1]
        cost += e[reached & ~split].sum()
        reached = np.repeat(reached & split, 2)
        x = wpt_ops.packet_level(segs, wt, True).reshape(n)
    # a split bottom node costs its two children's entropy
    terms = th_entropy._coef_terms(x.reshape(2 ** (D - 1), -1), et,
                                   nrm).sum(-1)
    return cost + terms.cpu().numpy()[reached[::2]].sum()


def phase_mainthreshold(xsig, x1):
    cdf = w.wavelet(w.wt.cdf97, "lifting")
    db4 = wavelet("db4", "filter")
    reset_counts()
    dn = w.denoise(xsig, cdf, L=DENOISE_LEVELS, TI=True, nspin=NSPIN)
    torch.cuda.synchronize()
    launches_ti, plain = counts()
    require(not any(plain.values()), "TI denoise: no plain version ran")
    require(dn.shape == xsig.shape and bool(torch.isfinite(dn).all()),
            "TI denoise shape, finite")
    e_ti = rel_l2(dn, w.denoise(xsig.double(), cdf, L=DENOISE_LEVELS,
                                TI=True, nspin=NSPIN))
    require(e_ti <= 1e-4, f"TI denoise f32 vs f64 rel l2 {e_ti:.3e}")
    del dn
    reset_counts()
    tree = w.bestbasistree(x1, db4)
    launches_bb, plain = counts()
    require(not any(plain.values()), "bestbasistree: no plain version ran")
    tree64 = w.bestbasistree(x1.double(), db4)
    require(w.isvalidtree(x1.numel(), tree), "bestbasistree: a valid tree")
    x64 = x1.double()
    cost, cost64 = basis_cost(tree, x64, db4), basis_cost(tree64, x64, db4)
    e_bb = abs(cost - cost64) / abs(cost64)
    require(e_bb <= 1e-6, f"best basis f32 vs f64 cost {e_bb:.3e}")
    emit({"phase": "mainthreshold",
          "ti_denoise": {"shape": list(xsig.shape), "levels": DENOISE_LEVELS,
                         "nspin": list(NSPIN), "dtype": "float32",
                         "launches": {k: v for k, v in launches_ti.items()
                                      if v},
                         "vs_f64_rel_l2": e_ti},
          "bestbasistree": {"n": x1.numel(), "wavelet": "db4",
                            "launches": {k: v for k, v in launches_bb.items()
                                         if v},
                            "nodes_equal_to_f64": float(np.mean(
                                tree == tree64)),
                            "basis_cost_f32_tree": cost,
                            "basis_cost_f64_tree": cost64,
                            "cost_rel_diff": e_bb}})


def phase_mainroutes(x):
    """Each row of the switch table through the public dwt/idwt: 16384^2
    cdf97 and 4096^2 db4, L8, f32.  Returns the launches of each route's
    run, by switch-table name and input."""
    cdf, db4 = wavelet("cdf97", "lifting"), wavelet("db4", "filter")
    inputs = (("cdf97_16384", cdf, x),
              ("db4_4096", db4, x[:4096, :4096].contiguous()))
    x2 = x[:2048, :2048].double()
    ref, launches, out = {}, {}, {}
    for name, switches, routes in SWITCH_TABLE:
        launches[name], rec = {}, {"switches": switches,
                                   "routes": list(routes)}
        with switched(switches):
            require(routes2d() == routes, f"{name}: routes {routes2d()}")
            for tag, wt, xt in inputs:
                fw = lambda v: w.dwt(v, wt, LEVELS)       # noqa: E731
                inv = lambda v: w.idwt(v, wt, LEVELS)     # noqa: E731
                expected = route_launches(routes, *xt.shape, LEVELS, wt,
                                          xt.dtype)
                y, got, wall, rt = run_route(f"{name} {tag}", fw, inv, xt,
                                             expected)
                launches[name][tag] = {k: v for k, v in got.items() if v}
                if name == "default":
                    ref[tag] = (y, inv(y))
                e_fw = rel_err(y, ref[tag][0])
                e_inv = rel_err(inv(ref[tag][0]), ref[tag][1])
                require(e_fw <= TOL[torch.float32] and
                        e_inv <= TOL[torch.float32],
                        f"{name} {tag} against the default route: "
                        f"{e_fw:.3e}, {e_inv:.3e}")
                rec[tag] = {"launches": launches[name][tag],
                            "wall_s_first_call_pair": wall,
                            "roundtrip_max_abs_err": rt,
                            "fw_vs_default_rel_err": e_fw,
                            "inv_vs_default_rel_err": e_inv}
                del y
            rt64 = (w.idwt(w.dwt(x2, cdf, LEVELS), cdf, LEVELS) - x2).abs() \
                .max().item()
            require(rt64 <= 1e-12, f"{name} f64 round trip {rt64:.3e}")
            rec["f64_roundtrip_2048_max_abs_err"] = rt64
        out[name] = rec
    require(launches["mxu_ls2"]["cdf97_16384"].get("stage2_fw") == 1,
            "the stage route ran kernel N")
    emit({"phase": "mainroutes", "shape": [SIZE, SIZE], "levels": LEVELS,
          "dtype": "float32", "tolerance_vs_default": TOL[torch.float32],
          "routes": out})
    return launches


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


def path_times(fw, inv, xt, geometric, iters=10):
    """A path's forward and inverse times (med3), host times, rates and
    sol_fraction against the same-run copy floor of ``xt``."""
    fw_s = P.med3(fw, xt, iters)
    yt = fw(xt)
    inv_s = P.med3(inv, yt, iters)
    copy_s, bw = P.copy_bandwidth(xt, iters)
    out = {"fw_ms": fw_s * 1e3, "inv_ms": inv_s * 1e3,
           "fw_host_ms": P.enqueue_time(fw, xt) * 1e3,
           "inv_host_ms": P.enqueue_time(inv, yt) * 1e3,
           "fw_gsps": xt.numel() / fw_s / 1e9,
           "inv_gsps": xt.numel() / inv_s / 1e9,
           "copy_ms": copy_s * 1e3, "copy_gbps": bw / 1e9,
           "fw_sol_fraction": P.sol_fraction(fw_s, xt, bw, geometric),
           "inv_sol_fraction": P.sol_fraction(inv_s, xt, bw, geometric)}
    del yt
    return out


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
        TOL[x.dtype], library_inv2d(planes, wt),
        lambda o: [interleave2d(o)])
    # one tail level is one periodic 2-D level: the same library calls
    rows["tail_fw"] = kernel_row(
        "tail_fw", lambda: tail2d.tail_fw(small, wt, 1, out=ys),
        lambda: tail2d.tail_fw_plain(small, wt, 1, out=ys), (ys,),
        TOL[x.dtype], library_fw2d(small, wt), lambda o: [packed_of(o)])
    rows["tail_inv"] = kernel_row(
        "tail_inv", lambda: tail2d.tail_inv(ys, wt, 1, out=xs),
        lambda: tail2d.tail_inv_plain(ys, wt, 1, out=xs), (xs,),
        TOL[x.dtype], library_inv2d(quads_of(ys), wt),
        lambda o: [interleave2d(o)])
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


def device_us(fn, calls=20):
    """Device microseconds per call of ``fn()`` from torch.profiler: the
    summed duration of its device events over ``calls`` calls, divided by
    ``calls`` (host overhead between launches does not count).  A trace
    that comes back without device events is taken again, with twice the
    calls, up to three times in all, before the check fails: the profiler
    returned such traces of short sessions (20 calls of a kernel or cuDNN
    call of a few microseconds) in two of three otherwise equal runs."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            break
        calls *= 2
    require(ev, "the profiler recorded device events")
    return sum(e.time_range.end - e.time_range.start for e in ev) / calls


def tail_times(x, rows):
    """The tails beside their yardsticks, device against device: one 128^2
    level of one image (the cluster path) with the device time of kernel
    and library call from the profiler, the host's time per call and the
    launch floor (a chained ``small + 1`` of the same size), added to the
    tail rows of phase 4; then :func:`tail_batch_times` and
    :func:`tail_cluster_times`.  It runs after phase 5, whose trace it
    leaves as it was."""
    dev, wt = x.device, w.wavelet(w.wt.cdf97, "lifting")
    small = x[None, :128, :128].contiguous()
    ys = tail2d.tail_fw(small, wt, 1)
    xs = torch.empty_like(small)
    lib_fw, lib_inv = library_fw2d(small, wt), library_inv2d(quads_of(ys),
                                                               wt)
    floor_ms = P.med3(lambda v: v + 1, small, 20) * 1e3
    for name, kern, lib, inv in (
            ("tail_fw", lambda: tail2d.tail_fw(small, wt, 1, out=ys), lib_fw,
             False),
            ("tail_inv", lambda: tail2d.tail_inv(ys, wt, 1, out=xs), lib_inv,
             True)):
        rows[name].update(
            device_us=device_us(kern), library_device_us=device_us(lib),
            host_ms=P.enqueue_time(lambda _: kern(), small) * 1e3,
            floor_ms=floor_ms,
            cluster=tail2d.tail_plan(1, 128, 128, 1, wt, small.dtype,
                                     inv).cluster)
    emit({"phase": "timestails", "card": torch.cuda.get_device_name(0),
          "b1_128_L1": {k: {f: rows[k][f] for f in (
              "ms", "device_us", "library_ms", "library_device_us",
              "host_ms", "floor_ms", "cluster")}
              for k in ("tail_fw", "tail_inv")}, **tail_batch_times(dev, wt),
          "cluster_sizes": tail_cluster_times(dev, wt)})


def j_e_times(x, xs):
    """Kernels J, E and I at their paths' level-1 shapes, by profiler time
    (device us per call) and CUDA events (ms): J at 16384^2 (the split
    inverse's call: the packed level's halves into a scratch), J in halo
    mode at one shard's level (4096, 16384) with the wrapped rows as
    halos, J at level 1 of the 256^3 volume (the 3-D inverse's layout),
    E at level 1 of the 2^24 signal and over the 16384 rows of 16384
    (cdf97 and db4, the split forward's call: [s | d] per row); I in both
    forms (``_first``: launched with a size bound above the level) at
    16384^2 (the split forward's call: down the row pass's scratch into
    the packed level's halves; cdf97, and db4 in the tiled form), in halo
    mode at one shard's level with the wrapped rows as halos, and at
    level 1 of the 256^3 volume (the 3-D forward's layout), there also
    in bf16."""
    cdf, db4 = w.wavelet(w.wt.cdf97, "lifting"), wavelet("db4", "filter")
    out, h = {}, SIZE // 2
    stream = torch.cuda.current_stream().cuda_stream
    first = 1 << 40

    def timed(tag, fn, xt):
        fn()
        torch.cuda.synchronize()
        out[tag] = {"device_us": device_us(fn),
                    "ms": P.med3(lambda _: fn(), xt, 10) * 1e3}

    y = x[None]
    sc = torch.empty_like(y)
    timed("J_16384x16384_level1", lambda: axis0.axis0_inv(
        y[:, :h], y[:, h:], cdf, out=sc), y)
    rows_ = SIZE // SHARDS
    ia, ib = axis0.halo_reach(cdf, True)
    a, d = y[:, :rows_ // 2], y[:, h:h + rows_ // 2]
    halos = (a[:, rows_ // 2 - ia:], a[:, :ib], d[:, rows_ // 2 - ia:],
             d[:, :ib])
    xr = sc[:, :rows_]
    timed("J_halo_4096x16384", lambda: axis0.axis0_inv(
        a, d, cdf, out=xr, halos=halos), xr)
    x3 = xs[(SIZE3D,) * 3]
    D = x3.shape[0]
    s3 = torch.empty_like(x3)
    timed("J_256cubed_level1", lambda: axis0.axis0_inv(
        dwt3d._rows(x3[: D // 2]), dwt3d._rows(x3[D // 2:]), cdf,
        out=dwt3d._rows(s3)), x3)
    del s3
    x24 = xs[(1 << 24,)][None]
    s24, d24 = torch.empty_like(x24[:, ::2]), torch.empty_like(x24[:, ::2])
    timed("E_2e24_level1", lambda: level1d.level1d_fw(x24, cdf, s24, d24),
          x24)
    del s24, d24
    for tag, wt in (("cdf97", cdf), ("db4", db4)):
        timed(f"E_16384x16384_{tag}", lambda: level1d.level1d_fw(
            x, wt, sc[0, :, :h], sc[0, :, h:]), x)
    # I: the split forward's column pass, sc (the row pass's [s | d]) into
    # the halves of y
    yo = torch.empty_like(y)
    for tag, bound in (("", None), ("_first", first)):
        timed(f"I_16384x16384_level1{tag}", lambda: launch_form(
            axis0._FW, cdf, sc, yo[:, :h], yo[:, h:], None, None,
            stream=stream, min_pairs=bound), y)
    timed("I_16384x16384_db4", lambda: axis0.axis0_fw(
        sc, db4, yo[:, :h], yo[:, h:]), y)
    fa, fb = axis0.halo_reach(cdf, False)
    xh = sc[:, :rows_]
    ha = (xh[:, rows_ - fa:], xh[:, :fb])
    for tag, bound in (("", None), ("_first", first)):
        timed(f"I_halo_4096x16384{tag}", lambda: launch_form(
            axis0._FW_HALO, cdf, xh, yo[:, :rows_ // 2],
            yo[:, h:h + rows_ // 2], *ha, stream=stream, min_pairs=bound),
            xh)
    del sc, yo
    s3 = torch.empty_like(x3)
    for dt in (torch.float32, torch.bfloat16):
        x3t, s3t = x3.to(dt), s3.to(dt)
        pa, pd = dwt3d._rows(s3t[: D // 2]), dwt3d._rows(s3t[D // 2:])
        for tag, bound in (("", None), ("_first", first)):
            if dt == torch.bfloat16 and bound:
                continue
            dtag = "_bf16" if dt == torch.bfloat16 else ""
            timed(f"I_256cubed_level1{tag}{dtag}", lambda: launch_form(
                axis0._FW, cdf, dwt3d._rows(x3t), pa, pd, None, None,
                stream=stream, min_pairs=bound), x3t)
    del s3, x3t, s3t
    torch.cuda.empty_cache()
    return out


def i_form_times(dev):
    """Kernel I's two forms by level size, device us per call from the
    profiler: the tiled form (launched with a size bound of 0 pairs) and
    the first form (a bound above every level) over square levels (1, n,
    n), n = 64 to 4096 (the split forward's deep levels: 2^11 to 2^23
    output pairs), and cubes (n, n, n), n = 16 to 128, in the 3-D
    driver's layout (its deep levels), cdf97 (window 16) and haar
    (window 8), f32; each the less of two readings, taken tiled, first,
    tiled, first.  ``crossover_pairs`` gives, for each series, the
    smallest size of the sweep from which the tiled form is no slower at
    that size and every larger one (None: slower at the largest), beside
    the bound the wrapper uses (axis0.FW_A0_MIN_PAIRS)."""
    rng = np.random.default_rng(11)
    stream = torch.cuda.current_stream().cuda_stream
    out, cross = {}, {}
    for wname, kind in (("cdf97", "lifting"), ("haar", "lifting")):
        wt = wavelet(wname, kind)
        for shape in ("square", "cube"):
            series = []
            sizes = (64, 128, 256, 512, 1024, 2048, 4096) if shape == \
                "square" else (16, 32, 64, 128)
            for n in sizes:
                v = torch.from_numpy(rng.standard_normal(
                    (n, n) if shape == "square" else (n, n, n)).astype(
                    np.float32)).to(dev)
                xv = v[None] if shape == "square" else dwt3d._rows(v)
                B, R, C = xv.shape
                a, d = axis0.axis0_fw_plain(xv, wt)
                us = [device_us(lambda: launch_form(
                    axis0._FW, wt, xv, a, d, None, None, stream=stream,
                    min_pairs=bound))
                    for bound in (0, 1 << 40, 0, 1 << 40)]
                series.append([B * (R // 2) * C, min(us[0::2]),
                               min(us[1::2])])
            at = len(series)
            while at and series[at - 1][1] <= series[at - 1][2]:
                at -= 1
            tag = f"{wname}_{shape}"
            out[tag] = series
            cross[tag] = series[at][0] if at < len(series) else None
    return {"pairs_tiled_us_first_us": out, "crossover_pairs": cross,
            "FW_A0_MIN_PAIRS": axis0.FW_A0_MIN_PAIRS}


def e_form_times(dev):
    """Kernel E's two forms by level size, device us per call from the
    profiler: the tiled form (launched with a size bound of 0 pairs) and
    the first form (a bound above every level) over levels of 2^12 to
    2^20 output pairs, as one row and as rows of 64 samples (the packet
    transform's middle depths), cdf97 (window 16) and haar (window 8),
    f32; each the less of two readings, taken tiled, first, tiled, first
    (single readings jumped by up to 1.5x between neighbouring sizes).
    ``crossover_pairs`` gives, for each series, the smallest size of the
    sweep from which the tiled form is no slower at that size and every
    larger one (None: slower at the largest), beside the bound the
    wrapper uses (level1d.FW1D_MIN_PAIRS)."""
    rng = np.random.default_rng(9)
    stream = torch.cuda.current_stream().cuda_stream
    out, cross = {}, {}
    for wname, kind in (("cdf97", "lifting"), ("haar", "lifting")):
        wt = wavelet(wname, kind)
        for width in (None, 64):
            series = []
            for k in range(12, 21):
                pairs = 1 << k
                B, n = (1, 2 * pairs) if width is None else (
                    2 * pairs // width, width)
                x = torch.from_numpy(rng.standard_normal((B, n)).astype(
                    np.float32)).to(dev)
                s, d = level1d.level1d_fw_plain(x, wt)
                us = [device_us(lambda: launch_form(
                    level1d._FW, wt, x, s, d, stream=stream,
                    min_pairs=bound))
                    for bound in (0, 1 << 40, 0, 1 << 40)]
                series.append([pairs, min(us[0::2]), min(us[1::2])])
            at = len(series)
            while at and series[at - 1][1] <= series[at - 1][2]:
                at -= 1
            tag = f"{wname}_{'row' if width is None else 'rows_of_64'}"
            out[tag] = series
            cross[tag] = series[at][0] if at < len(series) else None
    return {"pairs_tiled_us_first_us": out, "crossover_pairs": cross,
            "FW1D_MIN_PAIRS": level1d.FW1D_MIN_PAIRS}


def phase_forms(dev):
    """Phase 5d: which form of kernels E, I, J, N, G and H each wavelet
    launches, read from the card (the kernel's name in a profiler trace),
    against what the C selectors should pick.  E (FW1D_WAVELETS) on one
    2^20 row, the tiled form for a window (cdf97, haar, db4), the first
    form otherwise (sym5, db10), and on (3, 4096), below FW1D_MIN_PAIRS,
    the first form for every wavelet (the tiled one with a bound of 0
    pairs); I (FW1D_WAVELETS) the same way on a (2, 2048, 512) level,
    of FW_A0_MIN_PAIRS output pairs (the first form with a bound above
    the level), and on (3, 96, 160), below it (the tiled form with a
    bound of 0 pairs); I in halo mode (WAVELETS_HALO and db10) on a (2,
    1024, 1024) level with its wrapped rows as halos, which must equal
    the periodic I bit for bit; J
    (INV_A0_WAVELETS) on a (2, 1024, 512) level, the tiled form for
    cdf97, db4 and coif4, the first for db10; J in halo mode
    (WAVELETS_HALO and db10) on a (2, 48, 160) level with its wrapped
    rows as halos, which must equal the periodic J bit for bit; N
    (WAVELETS_STAGE) on a 512^2 image, the strip form below a span of 16
    (cdf97, haar, db4), the first form for coif4; H (TAIL_INV_WAVELETS) on
    (64, 4096) L8, the staged form below a span of 16 (cdf97, db4, sym5),
    the first form for db10 and with staging off; G (TAIL_FW_WAVELETS) the
    same way, the staged form for cdf97 and db4, the first form for sym5
    and db10 (a span of 16 or more) and with staging off; imodwt of
    (64, 4096) db4 L6 rows one modwt_inv_levels launch."""
    rng = np.random.default_rng(8)
    stream = torch.cuda.current_stream().cuda_stream
    forms = {}

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)
    first, tiled_name = "level1d_fw_kernel", "level1d_fw_tiled_kernel"
    for (wname, kind) in FW1D_WAVELETS:
        wt = wavelet(wname, kind)
        tiled = bool(level1d.fw1d_window(wt))
        for B, n in ((1, 1 << 20), (3, 4096)):
            x = randn(B, n)
            s, d = level1d.level1d_fw(x, wt)
            big = B * n // 2 >= level1d.FW1D_MIN_PAIRS
            forms[f"E {wname} {(B, n)}"] = require_form(
                lambda: level1d.level1d_fw(x, wt, s, d),
                tiled_name if tiled and big else first, f"E {wname} {(B, n)}")
            if tiled and not big:
                forms[f"E {wname} {(B, n)} bound 0"] = require_form(
                    lambda: launch_form(level1d._FW, wt, x, s, d,
                                        stream=stream, min_pairs=0),
                    tiled_name, f"E {wname} {(B, n)} with a bound of 0")
    first, tiled_name = "axis0_fw_kernel", "axis0_fw_tiled_kernel"
    for (wname, kind) in FW1D_WAVELETS:
        wt = wavelet(wname, kind)
        tiled = bool(axis0.fw_window(wt))
        for B, R, C in ((2, 2048, 512), (3, 96, 160)):
            xi = randn(B, R, C)
            a, d = axis0.axis0_fw(xi, wt)
            big = B * (R // 2) * C >= axis0.FW_A0_MIN_PAIRS
            tag = f"I {wname} {(B, R, C)}"
            forms[tag] = require_form(
                lambda: axis0.axis0_fw(xi, wt, a, d),
                tiled_name if tiled and big else first, tag)
            bound = 1 << 40 if big else 0
            forms[f"{tag} bound {bound}"] = require_form(
                lambda: launch_form(axis0._FW, wt, xi, a, d, None, None,
                                    stream=stream, min_pairs=bound),
                first if big or not tiled else tiled_name,
                f"{tag} with a bound of {bound} pairs")
    for (wname, kind) in WAVELETS_HALO + (("db10", "filter"),):
        wt = wavelet(wname, kind)
        fa, fb = axis0.halo_reach(wt, False)
        xi = randn(2, 1024, 1024)
        a, d = axis0.axis0_fw(xi, wt)
        forms[f"I-halo {wname}"] = require_form(
            lambda: axis0.axis0_fw(xi, wt, above=xi[:, 1024 - fa:],
                                   below=xi[:, :fb]),
            tiled_name if axis0.fw_window(wt) else first, f"I-halo {wname}")
        ah, dh = axis0.axis0_fw(xi, wt, above=xi[:, 1024 - fa:],
                                below=xi[:, :fb])
        require(torch.equal(ah, a) and torch.equal(dh, d),
                f"halo fw with wrapped halos equals the periodic kernel: "
                f"{wname} (2, 1024, 1024)")
    for (wname, kind) in INV_A0_WAVELETS:
        wt = wavelet(wname, kind)
        a, d = randn(2, 1024, 512), randn(2, 1024, 512)
        forms[f"J {wname}"] = require_form(
            lambda: axis0.axis0_inv(a, d, wt),
            "axis0_inv_tiled_kernel" if axis0.inv_window(wt)
            else "axis0_inv_kernel", f"J {wname}")
    for (wname, kind) in WAVELETS_HALO + (("db10", "filter"),):
        wt = wavelet(wname, kind)
        ia, ib = axis0.halo_reach(wt, True)
        a, d = randn(2, 48, 160), randn(2, 48, 160)
        halos = (a[:, 48 - ia:], a[:, :ib], d[:, 48 - ia:], d[:, :ib])
        forms[f"J-halo {wname}"] = require_form(
            lambda: axis0.axis0_inv(a, d, wt, halos=halos),
            "axis0_inv_tiled_kernel" if axis0.inv_window(wt)
            else "axis0_inv_kernel", f"J-halo {wname}")
        require(torch.equal(axis0.axis0_inv(a, d, wt, halos=halos),
                            axis0.axis0_inv(a, d, wt)),
                f"halo inv with wrapped halos equals the periodic kernel: "
                f"{wname} (2, 48, 160)")
    for (wname, kind) in WAVELETS_STAGE:
        wt = wavelet(wname, kind)
        xi = randn(1, 512, 512)
        o = stage2d.stage2_fw(xi, wt)
        forms[f"N {wname}"] = require_form(
            lambda: stage2d.stage2_fw(xi, wt, o),
            "stage2_strip_kernel" if stage2d.stage_window(wt)
            else "stage2_fw_kernel", f"N {wname}")
    for (wname, kind) in TAIL_INV_WAVELETS:
        wt = wavelet(wname, kind)
        yi = randn(64, 4096)
        o = torch.empty_like(yi)
        forms[f"H {wname}"] = require_form(
            lambda: tail1d.tail1d_inv(yi, wt, 8, out=o),
            "tail1d_inv_staged_kernel" if tail1d.inv_window(wt)
            else "tail1d_inv_kernel", f"H {wname}")
        forms[f"H {wname} staging off"] = require_form(
            lambda: launch_form(tail1d._INV, wt, 8, yi, o, stream=stream,
                                staged=False),
            "tail1d_inv_kernel", f"H {wname} with staging off")
    for (wname, kind) in TAIL_FW_WAVELETS:
        wt = wavelet(wname, kind)
        xi = randn(64, 4096)
        o = torch.empty_like(xi)
        forms[f"G {wname}"] = require_form(
            lambda: tail1d.tail1d_fw(xi, wt, 8, out=o),
            "tail1d_fw_staged_kernel" if tail1d.fw_window(wt)
            else "tail1d_fw_kernel", f"G {wname}")
        forms[f"G {wname} staging off"] = require_form(
            lambda: launch_form(tail1d._FW, wt, 8, xi, o, stream=stream,
                                staged=False),
            "tail1d_fw_kernel", f"G {wname} with staging off")
    db4 = wavelet("db4", "filter")
    xw = modwt1d.modwt(randn(64, 4096), db4, 6)
    forms["imodwt db4 (64, 4096) L6"] = require_form(
        lambda: w.imodwt(xw, db4), "modwt_inv_levels_kernel",
        "imodwt of rows its plan fits")
    emit({"phase": "forms", "forms": forms})


def profiled_times(x, xs, rows):
    """Phase 5c, after the trace: kernels A (f32, bf16) and B at 16384^2
    level 1 by profiler time, F at level 1 of the 2^24 signal, of the 16384
    rows of 16384 (cdf97, db4) and of one shard's rows, and modwt_fw_levels at (512, 8192) db4 L6 beside the chain of K
    launches and the library calls, in f32 and bf16, and in f32 with every
    cluster size that fits (the plan takes one)."""
    cdf, db4 = w.wavelet(w.wt.cdf97, "lifting"), wavelet("db4", "filter")
    xb = x[None]
    ll = torch.empty((1, SIZE // 2, SIZE // 2), dtype=x.dtype, device=x.device)
    planes = (ll, *level2d.detail_planes(torch.empty_like(xb), 1))
    level2d.level_fw(xb, cdf, planes)
    xr = torch.empty_like(xb)
    rows["level_inv"]["device_us"] = device_us(
        lambda: level2d.level_inv(*planes, cdf, out=xr))
    rows["level_fw"]["device_us"] = device_us(
        lambda: level2d.level_fw(xb, cdf, planes))
    xh = xb.to(torch.bfloat16)
    planes_h = tuple(p.to(torch.bfloat16) for p in planes)
    fw_bf16_us = device_us(lambda: level2d.level_fw(xh, cdf, planes_h))
    del ll, planes, xr, xh, planes_h
    # F: level 1 of the 2^24 signal, the 16384 rows of 16384 (cdf97,
    # db4), and one shard's 4096 rows of 16384
    x24 = xs[(1 << 24,)][None]
    s24, d24 = level1d.level1d_fw(x24, cdf)
    o24 = torch.empty_like(x24)
    f_us = {"2e24": device_us(lambda: level1d.level1d_inv(s24, d24, cdf,
                                                          out=o24))}
    del s24, d24, o24
    h = SIZE // 2
    for tag, wt, nrows in (("16384x16384_cdf97", cdf, SIZE),
                           ("16384x16384_db4", db4, SIZE),
                           ("4096x16384_cdf97", cdf, SIZE // SHARDS)):
        sd = torch.empty_like(x[:nrows])
        level1d.level1d_fw(x[:nrows], wt, sd[:, :h], sd[:, h:])
        xr = torch.empty_like(sd)
        f_us[tag] = device_us(lambda: level1d.level1d_inv(
            sd[:, :h], sd[:, h:], wt, out=xr))
        del sd, xr
    rows["level1d_inv"]["device_us"] = f_us["2e24"]
    je = j_e_times(x, xs)
    rows["axis0_inv"]["device_us"] = je["J_256cubed_level1"]["device_us"]
    rows["axis0_inv_halo"]["device_us"] = je["J_halo_4096x16384"]["device_us"]
    for name, tag in (("axis0_fw", "I_256cubed_level1"),
                      ("axis0_fw_halo", "I_halo_4096x16384")):
        rows[name]["device_us"] = je[tag]["device_us"]
        rows[name]["first_form_ms"] = je[tag + "_first"]["ms"]
        rows[name]["first_form_device_us"] = je[tag + "_first"]["device_us"]
    rows["level1d_fw"]["device_us"] = je["E_2e24_level1"]["device_us"]
    xm, L = xs[MODWT_SHAPE], MODWT_LEVELS
    B, N = xm.shape
    W = modwt1d.modwt_fw_levels(xm, db4, L)
    r = rows["modwt_fw_levels"]
    r["device_us"] = device_us(lambda: modwt1d.modwt_fw_levels(xm, db4, L, W))
    r["chain_device_us"] = device_us(lambda: modwt_chain(xm, db4, L))
    r["library_device_us"] = device_us(library_modwt_levels(xm, db4, L))
    xh = xm.to(torch.bfloat16)
    Wh = modwt1d.modwt_fw_levels(xh, db4, L)
    bf16_us = device_us(lambda: modwt1d.modwt_fw_levels(xh, db4, L, Wh))
    sizes, Wp = {}, torch.empty_like(W)
    for Pc in (1, 2, 4, 8, 16):
        plan = modwt1d.cluster_plan(Pc, N, L, len(db4.qmf), xm.dtype)
        if plan is None:
            continue
        fn = lambda: launch_form(                   # noqa: E731
            modwt1d._LEVELS, db4, L, xm, Wp,
            stream=torch.cuda.current_stream().cuda_stream, plan=plan)
        fn()
        torch.cuda.synchronize()
        require(torch.equal(Wp, W), f"modwt_fw_levels with a cluster of {Pc}")
        sizes[f"P{Pc}"] = device_us(fn)
    # the all-levels inverse beside the six M launches and six conv1d calls
    ri = rows["modwt_inv_levels"]
    xi = torch.empty_like(xm)
    ri["device_us"] = device_us(lambda: modwt1d.modwt_inv_levels(W, db4, xi))
    ri["chain_device_us"] = device_us(lambda: modwt_inv_chain(W, db4))
    ri["library_device_us"] = device_us(library_modwt_inv_levels(W, db4))
    xhi = torch.empty_like(xh)
    inv_bf16_us = device_us(lambda: modwt1d.modwt_inv_levels(Wh, db4, xhi))
    del xi, xhi
    nh_times = n_h_times(x, xs, rows)
    emit({"phase": "timesprofiled", "card": torch.cuda.get_device_name(0),
          **nh_times,
          "level_inv_16384_level1_device_us": rows["level_inv"]["device_us"],
          "level_fw_16384_level1_device_us": rows["level_fw"]["device_us"],
          "level_fw_16384_level1_bf16_device_us": fw_bf16_us,
          "level1d_inv_level1_device_us": f_us,
          "j_e_level1": je,
          "e_forms_by_size": e_form_times(x.device),
          "i_forms_by_size": i_form_times(x.device),
          "modwt_fw_levels_512x8192_L6": {
              "f32_device_us": r["device_us"], "bf16_device_us": bf16_us,
              "chain_device_us": r["chain_device_us"],
              "library_device_us": r["library_device_us"],
              "cluster": r["cluster"], "cluster_sizes_device_us": sizes},
          "modwt_inv_levels_512x8192_L6": {
              "f32_device_us": ri["device_us"], "bf16_device_us": inv_bf16_us,
              "chain_device_us": ri["chain_device_us"],
              "library_device_us": ri["library_device_us"],
              "cluster": ri["cluster"]}})


def n_h_times(x, xs, rows):
    """Phase 5c: kernels N, G and H in both forms by profiler time (device
    us per call) and CUDA events (ms).  N at 16384^2 levels 1-2, cdf97 f32:
    the strip form (the wrapper's), its first form (launched with strips
    off, stage_tile's tile) and the two A launches it replaces, into the
    same planes; the strip form in bf16 and for db4.  H over the (4096,
    4096) db4 L8 rows: the staged form, the first form (staging off), and
    the chain of eight polyphase conv1d calls that computes the same
    levels (one per level, on inputs prepared beforehand: a library
    yardstick, not one call); and H's forms by size (``h_forms_by_size``):
    one row of 2^14 and of 2^11 through every level (db2; the first is the
    2^20 db2 L20 inverse's tail), and 1 to 4096 rows of 4096 (db4 L8),
    each the less of two readings taken staged, first, staged, first.  G
    the same way (``g_forms_by_size``), beside a chain of eight strided
    conv1d calls at (4096, 4096) db4 L8, and its staged form there in
    bf16."""
    stream = torch.cuda.current_stream().cuda_stream
    cdf, db4 = w.wavelet(w.wt.cdf97, "lifting"), wavelet("db4", "filter")
    out = {}
    xb = x[None]
    y = torch.empty_like(xb)
    outs = (torch.empty((1, SIZE // 4, SIZE // 4), dtype=x.dtype,
                        device=x.device),
            *level2d.detail_planes(y, 1), *level2d.detail_planes(y, 2))
    ll1 = torch.empty((1, SIZE // 2, SIZE // 2), dtype=x.dtype,
                      device=x.device)
    fns = {"strips": lambda: stage2d.stage2_fw(xb, cdf, outs),
           "first_form": lambda: launch_form(stage2d._SITE, cdf, xb, outs,
                                             stream=stream, strips=False),
           "two_A": lambda: (level2d.level_fw(xb, cdf, (ll1, *outs[1:4])),
                             level2d.level_fw(ll1, cdf,
                                              (outs[0], *outs[4:])))}
    n = {k: {"device_us": device_us(f, calls=10),
             "ms": P.med3(lambda _: f(), xb, 10) * 1e3}
         for k, f in fns.items()}
    for tag, xt, wt in (("bf16", xb.to(torch.bfloat16), cdf),
                        ("db4", xb, db4)):
        o = stage2d.stage2_fw(xt, wt)
        f = lambda: stage2d.stage2_fw(xt, wt, o)    # noqa: E731
        n[f"strips_{tag}"] = {"device_us": device_us(f, calls=10),
                              "ms": P.med3(lambda _: f(), xt, 10) * 1e3}
        del o, xt
    del y, outs, ll1
    r = rows["stage2_fw"]
    r["device_us"] = n["strips"]["device_us"]
    r["first_form_ms"] = n["first_form"]["ms"]
    r["first_form_device_us"] = n["first_form"]["device_us"]
    out["stage2_fw_16384_levels12"] = n

    xb, L = xs[(4096, 4096)], 8
    yb, xr, xf = (torch.empty_like(xb) for _ in range(3))
    tail1d.tail1d_fw(xb, db4, L, out=yb)
    nh = xb.shape[1] >> L
    v, lib = yb[:, :nh], []
    for l in range(L, 0, -1):
        d = yb[:, nh: 2 * nh]
        lib.append(library_inv1d_polyphase(v, d, db4))
        v = level1d.level1d_inv_plain(v, d, db4)
        nh *= 2
    chain = lambda: [f() for f in lib]              # noqa: E731
    ref = tail1d.tail1d_inv(yb, db4, L, out=xr)
    lrel = rel_err(interleave1d(lib[-1]()), ref)
    require(lrel <= LIBRARY_TOL, f"H's library chain: rel err {lrel:.3e}")
    fns = {"staged": lambda: tail1d.tail1d_inv(yb, db4, L, out=xr),
           "first_form": lambda: launch_form(tail1d._INV, db4, L, yb, xf,
                                             stream=stream, staged=False),
           "library_chain": chain}
    h = {k: {"device_us": device_us(f), "ms": P.med3(lambda _: f(), xb, 20)
             * 1e3} for k, f in fns.items()}
    require(torch.equal(xf, xr), "H's forms agree at (4096, 4096) db4 L8")
    del lib
    r = rows["tail1d_inv"]
    r["device_us"] = h["staged"]["device_us"]
    r["first_form_ms"] = h["first_form"]["ms"]
    r["first_form_device_us"] = h["first_form"]["device_us"]
    r["library_chain_ms"] = h["library_chain"]["ms"]
    r["library_chain_device_us"] = h["library_chain"]["device_us"]
    r["library_calls"] = "a chain of 8 polyphase conv1d calls, one per level"
    out["tail1d_inv_4096x4096_db4_L8"] = h

    # G over the same rows: the staged form, the first form and a chain of
    # eight strided conv1d calls (one per level, inputs prepared beforehand)
    xb, L = xs[(4096, 4096)], 8
    yg, yf = torch.empty_like(xb), torch.empty_like(xb)
    lib, pack = library_tail1d_fw(xb, db4, L)
    ref = tail1d.tail1d_fw(xb, db4, L, out=yg)
    lrel = rel_err(pack(lib()), ref)
    require(lrel <= LIBRARY_TOL, f"G's library chain: rel err {lrel:.3e}")
    fns = {"staged": lambda: tail1d.tail1d_fw(xb, db4, L, out=yg),
           "first_form": lambda: launch_form(tail1d._FW, db4, L, xb, yf,
                                             stream=stream, staged=False),
           "library_chain": lib}
    g = {k: {"device_us": device_us(f), "ms": P.med3(lambda _: f(), xb, 20)
             * 1e3} for k, f in fns.items()}
    require(torch.equal(yf, yg), "G's forms agree at (4096, 4096) db4 L8")
    xh = xb.to(torch.bfloat16)
    yh = torch.empty_like(xh)
    g["staged_bf16"] = {"device_us": device_us(
        lambda: tail1d.tail1d_fw(xh, db4, L, out=yh))}
    del lib, yf, xh, yh
    r = rows["tail1d_fw"]
    r["device_us"] = g["staged"]["device_us"]
    r["first_form_ms"] = g["first_form"]["ms"]
    r["first_form_device_us"] = g["first_form"]["device_us"]
    r["library_chain_ms"] = g["library_chain"]["ms"]
    r["library_chain_device_us"] = g["library_chain"]["device_us"]
    r["library_calls"] = "a chain of 8 strided conv1d calls, one per level"
    out["tail1d_fw_4096x4096_db4_L8"] = g

    db2 = wavelet("db2", "filter")
    rng = np.random.default_rng(10)
    sweep, gsweep = [], []
    for B, n_, wt, L in ((1, 1 << 14, db2, 14), (1, 1 << 11, db2, 11),
                         (1, 4096, db4, 8), (16, 4096, db4, 8),
                         (256, 4096, db4, 8), (4096, 4096, db4, 8)):
        yt = torch.from_numpy(rng.standard_normal((B, n_)).astype(
            np.float32)).to(x.device)
        ot = torch.empty_like(yt)
        us = [device_us(lambda: launch_form(tail1d._INV, wt, L, yt, ot,
                                            stream=stream, staged=st))
              for st in (True, False, True, False)]
        sweep.append({"rows": B, "n": n_, "wavelet": wt.name, "levels": L,
                      "staged_us": min(us[0::2]), "first_us": min(us[1::2])})
        us = [device_us(lambda: launch_form(tail1d._FW, wt, L, yt, ot,
                                            stream=stream, staged=st))
              for st in (True, False, True, False)]
        gsweep.append({"rows": B, "n": n_, "wavelet": wt.name, "levels": L,
                       "staged_us": min(us[0::2]), "first_us": min(us[1::2])})
    out["h_forms_by_size"] = sweep
    out["g_forms_by_size"] = gsweep
    return out


def tail_cluster_times(dev, wt):
    """C and D by device time with clusters of 8 and of 16 blocks per
    image, on one image through one 128^2 level and on eight through four:
    the measurement behind tail_plan's WIDE_BATCH."""
    out = {}
    rng = np.random.default_rng(8)
    for B, L in ((1, 1), (8, 4)):
        x = torch.from_numpy(rng.standard_normal((B, 128, 128)).astype(
            np.float32)).to(dev)
        y, z = torch.empty_like(x), torch.empty_like(x)
        for P in (8, 16):
            pf, pi = (tail2d.cluster_plan(P, 128, 128, L, wt, x.dtype, inv)
                      for inv in (False, True))
            fw = lambda: launch_form(
                tail2d._FW, wt, L, x, y,
                stream=torch.cuda.current_stream().cuda_stream, plan=pf)
            inv = lambda: launch_form(
                tail2d._INV, wt, L, y, z,
                stream=torch.cuda.current_stream().cuda_stream, plan=pi)
            row = {"fw_device_us": device_us(fw),
                   "inv_device_us": device_us(inv)}
            rel = max(rel_err(y, tail2d.tail_fw_plain(x, wt, L)),
                      rel_err(z, tail2d.tail_inv_plain(y, wt, L)))
            require(rel <= TOL[torch.float32], f"cluster of {P}: {rel:.3e}")
            out[f"b{B}_L{L}_P{P}"] = row
    return out


def tail_batch_times(dev, wt):
    """C and D on 264 images of 128^2 through 4 levels (two images per SM):
    event and device time, host time, the cluster size."""
    out = {}
    xb = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (264, 128, 128)).astype(np.float32)).to(dev)
    yb, xr = torch.empty_like(xb), torch.empty_like(xb)
    for name, kern, plain, o in (
            ("tail_fw", lambda: tail2d.tail_fw(xb, wt, 4, out=yb),
             lambda: tail2d.tail_fw_plain(xb, wt, 4), yb),
            ("tail_inv", lambda: tail2d.tail_inv(yb, wt, 4, out=xr),
             lambda: tail2d.tail_inv_plain(yb, wt, 4), xr)):
        ms = P.med3(lambda _: kern(), xb, 20) * 1e3
        rel = rel_err(o, plain())
        require(rel <= TOL[torch.float32], f"{name} B=264 L4: {rel:.3e}")
        out[f"{name}_b264_L4"] = {
            "ms": ms, "device_us": device_us(kern), "rel_err": rel,
            "host_ms": P.enqueue_time(lambda _: kern(), xb) * 1e3,
            "cluster": tail2d.tail_plan(264, 128, 128, 4, wt, xb.dtype,
                                        name == "tail_inv").cluster}
    return out


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
            entry[tag] = path_times(*path_fns(shape, wt, L, packet), xt,
                                    geometric)
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


def phase_times3d(x3):
    wt = wavelet("cdf97", "lifting")
    L = LEVELS3D
    fw = lambda v: w.dwt(v, wt, L)          # noqa: E731
    inv = lambda v: w.idwt(v, wt, L)        # noqa: E731
    out = {"phase": "times3d", "shape": list(x3.shape), "levels": L}
    for tag, xt in (("f32", x3), ("bf16", x3.to(torch.bfloat16))):
        out[tag] = path_times(fw, inv, xt, P.geometric3d(L))
    haar = wavelet("haar", "lifting")
    out["f32_haar"] = path_times(lambda v: w.dwt(v, haar, L),
                                 lambda v: w.idwt(v, haar, L), x3,
                                 P.geometric3d(L))
    out["f32"]["plain_fw_ms"] = P.time_fn(
        lambda v: dwt3d.dwt3(v, wt, L, plain=True), x3, 1, chain=False) * 1e3
    y = fw(x3)
    out["f32"]["plain_inv_ms"] = P.time_fn(
        lambda v: dwt3d.idwt3(v, wt, L, plain=True), y, 1, chain=False) * 1e3
    emit(out)

    # I and J at level 1 of the 256^3 volume, in the driver's layout: I
    # from the contiguous scratch s (kernel A's quadrants of x3) into the
    # two halves of y, J back
    D = x3.shape[0]
    s = torch.empty_like(x3)
    level2d.level_fw(x3, wt, dwt3d._quads(s))
    yl = torch.empty_like(x3)
    a, d = dwt3d._rows(yl[: D // 2]), dwt3d._rows(yl[D // 2:])
    sr = torch.empty_like(x3)
    rows = {}
    rows["axis0_fw"] = kernel_row(
        "axis0_fw", lambda: axis0.axis0_fw(dwt3d._rows(s), wt, a, d),
        lambda: axis0.axis0_fw_plain(dwt3d._rows(s), wt, a, d), (a, d),
        TOL[x3.dtype], library_axis0_fw(s, wt),
        lambda o: [dwt3d._rows(o[0, i].view(D // 2, *x3.shape[1:]))
                   for i in (0, 1)])
    rows["axis0_inv"] = kernel_row(
        "axis0_inv", lambda: axis0.axis0_inv(a, d, wt, out=dwt3d._rows(sr)),
        lambda: axis0.axis0_inv_plain(a, d, wt, out=dwt3d._rows(sr)),
        (dwt3d._rows(sr),), TOL[x3.dtype],
        library_axis0_inv(yl[: D // 2], yl[D // 2:], wt),
        lambda o: [dwt3d._rows(interleave_rows(o, x3.shape))])
    # the one-pass level at level 1 (haar), into the packed layout of one
    # volume and back
    rows["level3_fw"] = kernel_row(
        "level3_fw", lambda: level3d.level3_fw(x3, haar, yl),
        lambda: level3d.level3_fw_plain(x3, haar, yl), (yl,),
        TOL[x3.dtype])
    rows["level3_inv"] = kernel_row(
        "level3_inv", lambda: level3d.level3_inv(yl, haar, sr),
        lambda: level3d.level3_inv_plain(yl, haar, sr), (sr,),
        TOL[x3.dtype])
    nbytes = 2 * x3.numel() * 4
    for name, inverse, w_ in (("axis0_fw", False, wt), ("axis0_inv", True, wt),
                              ("level3_fw", False, haar),
                              ("level3_inv", True, haar)):
        passes = 3 if name.startswith("level3") else 1
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(
            nbytes, passes * taps(w_, inverse) * x3.numel())
        rows[name]["copy_bound_ms"] = out["f32"]["copy_ms"]
    level3_times(x3.device, rows)
    return rows


def level3_times(dev, rows):
    """Phase 4c's timeslevel3d: device microseconds (profiler) of
    level3_fw and level3_inv at levels 1-3 of float32 cubes of
    SIZES_LEVEL3_TIMES, beside the two launches each replaces on the same
    views (A + I, J + B), the level's bytes at 3.35 TB/s and at the run's
    copy rate; 256^3 level 1 goes into the kernels' rows."""
    wt = wavelet("haar", "lifting")
    out = {"phase": "timeslevel3d", "dtype": "float32", "wavelet": "haar"}
    for size in SIZES_LEVEL3_TIMES:
        x = torch.randn((size,) * 3, device=dev)
        _, bw = P.copy_bandwidth(x, 10)
        y, s, back = (torch.empty_like(x) for _ in range(3))
        lll = torch.empty(x.numel() // 8, device=dev)
        levels = []
        for l in (1, 2, 3):
            d = size >> (l - 1)
            levels.append(level3_level_times(x, y, s, back, lll, d, l == 3,
                                             wt, bw))
        out[f"{size}^3"] = levels
        if size == 256:
            first = levels[0]
            for key in ("fw", "inv"):
                rows[f"level3_{key}"].update(
                    device_us=first[f"{key}_us"],
                    chain_device_us=first[f"{key}_chain_us"])
        del x, y, s, back, lll
        torch.cuda.empty_cache()
    emit(out)


def level3_level_times(x, y, s, back, lll, d, deepest, wt, bw):
    """One level's device times: the active (d, d, d) cube (contiguous,
    as the driver's scratch holds it), its octants in the packed ``y``
    (the scaling one in ``lll`` above the deepest level), A's scratch and
    J's output in ``s``, the level's result in ``back``."""
    act = x.view(-1)[: d ** 3].view(d, d, d)
    sub = y[:d, :d, :d]
    lll = None if deepest else lll[: (d // 2) ** 3].view(d // 2, d // 2,
                                                       d // 2)
    sv = s.view(-1)[: d ** 3].view(d, d, d)
    res = back.view(-1)[: d ** 3].view(d, d, d)
    halves = dwt3d._rows(sub[: d // 2]), dwt3d._rows(sub[d // 2:])
    corner = None if deepest else dwt3d._rows(lll)

    def chain_fw():
        level2d.level_fw(act, wt, dwt3d._quads(sv))
        axis0.axis0_fw(dwt3d._rows(sv), wt, *halves)

    def chain_inv():
        axis0.axis0_inv(*halves, wt, out=dwt3d._rows(sv), corner=corner)
        level2d.level_inv(*dwt3d._quads(sv), wt, out=res)

    nbytes = 2 * d ** 3 * 4
    return {"d": d,
            "fw_us": device_us(lambda: level3d.level3_fw(act, wt, y, lll)),
            "fw_chain_us": device_us(chain_fw),
            "inv_us": device_us(lambda: level3d.level3_inv(y, wt, res, lll)),
            "inv_chain_us": device_us(chain_inv),
            "bound_us": nbytes / PEAK_BYTES_S * 1e6,
            "copy_rate_us": nbytes / bw * 1e6}


def phase_timesmodwt(xm):
    wt = wavelet("db4", "filter")
    L = MODWT_LEVELS
    fw = lambda v: w.modwt(v, wt, L)        # noqa: E731
    inv = lambda v: w.imodwt(v, wt)         # noqa: E731
    out = {"phase": "timesmodwt", "shape": list(xm.shape), "levels": L}
    for tag, xt in (("f32", xm), ("bf16", xm.to(torch.bfloat16))):
        out[tag] = path_times(fw, inv, xt, P.geometric_modwt(L))
    out["f32"]["plain_fw_ms"] = P.time_fn(
        lambda v: modwt1d.modwt(v, wt, L, plain=True), xm, 1,
        chain=False) * 1e3
    W = fw(xm)
    out["f32"]["plain_inv_ms"] = P.time_fn(
        lambda v: modwt1d.imodwt(v, wt, plain=True), W, 1, chain=False) * 1e3

    # K and M at level 1, in the driver's layout: K from x into a scratch
    # row (v1) and W's column 0 (w1, element stride L+1); M back
    v1 = torch.empty_like(xm)
    w1 = W[..., 0]
    xr = torch.empty_like(xm)
    rows = {}
    rows["modwt_fw"] = kernel_row(
        "modwt_fw", lambda: modwt1d.modwt_fw(xm, wt, 1, v1, w1),
        lambda: modwt1d.modwt_fw_plain(xm, wt, 1, v1, w1), (v1, w1),
        TOL[xm.dtype], library_modwt_fw(xm, wt, 1),
        lambda o: [o[:, 0], o[:, 1]])
    rows["modwt_inv"] = kernel_row(
        "modwt_inv", lambda: modwt1d.modwt_inv(v1, w1, wt, 1, out=xr),
        lambda: modwt1d.modwt_inv_plain(v1, w1, wt, 1, out=xr), (xr,),
        TOL[xm.dtype], library_modwt_inv(v1, w1, wt, 1),
        lambda o: [o[:, 0]])
    # the column store against its alternative: K into a contiguous plane,
    # and the permuted copy of (L+1, B, N) planes into (B, N, L+1)
    wc = torch.empty_like(xm)
    planes = torch.empty((L + 1, *xm.shape), dtype=xm.dtype, device=xm.device)
    out["f32"]["modwt_fw_level1_contiguous_ms"] = P.med3(
        lambda _: modwt1d.modwt_fw(xm, wt, 1, v1, wc), xm, 20) * 1e3
    out["f32"]["modwt_fw_level1_column_ms"] = rows["modwt_fw"]["ms"]
    out["f32"]["permuted_copy_ms"] = P.med3(
        lambda _: W.copy_(planes.permute(1, 2, 0)), xm, 20) * 1e3
    # the all-levels kernel beside its plain version, the chain of K
    # launches it replaces, and L dilated conv1d calls plus the stack into
    # (B, N, L+1)
    Wf = torch.empty_like(W)
    rows["modwt_fw_levels"] = kernel_row(
        "modwt_fw_levels", lambda: modwt1d.modwt_fw_levels(xm, wt, L, Wf),
        lambda: modwt1d.modwt_fw_levels_plain(xm, wt, L, Wf), (Wf,),
        TOL[xm.dtype], library_modwt_levels(xm, wt, L), lambda o: [o])
    rows["modwt_fw_levels"].update(
        library_calls=L + 1, chain_ms=P.med3(
            lambda _: modwt_chain(xm, wt, L), xm, 10) * 1e3,
        cluster=modwt1d.modwt_plan(xm.shape[1], L, len(wt.qmf), xm.dtype,
                                   xm.shape[0]).cluster)
    xb = xm.to(torch.bfloat16)
    Wb = torch.empty(W.shape, dtype=xb.dtype, device=xb.device)
    out["bf16"]["modwt_fw_levels_ms"] = P.med3(
        lambda _: modwt1d.modwt_fw_levels(xb, wt, L, Wb), xb, 20) * 1e3
    out["f32"]["modwt_fw_levels_ms"] = rows["modwt_fw_levels"]["ms"]
    out["f32"]["modwt_fw_chain_ms"] = rows["modwt_fw_levels"]["chain_ms"]
    # the all-levels inverse beside its plain version, the chain of M
    # launches it replaces and L dilated conv1d calls (inputs prepared
    # beforehand)
    Wi, xi = fw(xm), torch.empty_like(xm)
    rows["modwt_inv_levels"] = kernel_row(
        "modwt_inv_levels", lambda: modwt1d.modwt_inv_levels(Wi, wt, xi),
        lambda: modwt1d.modwt_inv_levels_plain(Wi, wt, xi), (xi,),
        TOL[xm.dtype], library_modwt_inv_levels(Wi, wt), lambda o: [o[:, 0]])
    rows["modwt_inv_levels"].update(
        library_calls=L, chain_ms=P.med3(
            lambda _: modwt_inv_chain(Wi, wt), xm, 10) * 1e3,
        cluster=modwt1d.modwt_inv_plan(xm.shape[1], L, len(wt.qmf), xm.dtype,
                                       xm.shape[0]).cluster)
    Wbi, xbi = Wi.to(torch.bfloat16), torch.empty_like(xb)
    out["bf16"]["modwt_inv_levels_ms"] = P.med3(
        lambda _: modwt1d.modwt_inv_levels(Wbi, wt, xbi), xb, 20) * 1e3
    out["f32"]["modwt_inv_levels_ms"] = rows["modwt_inv_levels"]["ms"]
    out["f32"]["modwt_inv_chain_ms"] = rows["modwt_inv_levels"]["chain_ms"]
    del Wbi, xbi
    emit(out)
    nbytes = 3 * xm.numel() * 4
    for name in ("modwt_fw", "modwt_inv"):
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(
            nbytes, 4 * len(wt.qmf) * xm.numel())
        rows[name]["copy_bound_ms"] = out["f32"]["copy_ms"] * 1.5
    # the transform's least traffic: x read once, L+1 planes written once
    # (the inverse: L+1 planes read once, x written once)
    for name in ("modwt_fw_levels", "modwt_inv_levels"):
        r = rows[name]
        r["bound_ms"], r["bound_by"] = bound(
            (L + 2) * xm.numel() * 4, 4 * len(wt.qmf) * L * xm.numel())
        r["copy_bound_ms"] = out["f32"]["copy_ms"] * (L + 2) / 2
    return rows


def phase_timessharded(x, x1, x24):
    dev = x.device
    wt = w.wavelet(w.wt.cdf97, "lifting")
    db4 = wavelet("db4", "filter")
    out = {"phase": "timessharded", "shape": [SIZE, SIZE], "levels": LEVELS}
    for tag, nd in (("shards_4", SHARDS), ("shards_1", 1)):
        mesh = parallel.Mesh([dev] * nd, ("x",))
        fw = lambda v: parallel.dwt2(v, wt, LEVELS, mesh)      # noqa: E731
        ys = fw(x)
        inv = lambda _: parallel.idwt2(ys, wt, LEVELS, mesh)   # noqa: E731
        out[tag] = {"fw_ms": P.med3(fw, x, 5) * 1e3,
                    "inv_ms": P.med3(inv, x, 5) * 1e3,
                    "fw_host_ms": P.enqueue_time(fw, x, 5) * 1e3,
                    "inv_host_ms": P.enqueue_time(inv, x, 5) * 1e3}
        del ys
    out["single_card_fw_ms"] = P.med3(lambda v: w.dwt(v, wt, LEVELS), x,
                                      10) * 1e3
    mesh4 = parallel.Mesh([dev] * SHARDS, ("x",))
    # rank-1 shards: the 2^24 signal, 8 levels (I/J with B = C = 1)
    fw1 = lambda v: parallel.dwt1(v, wt, LEVELS, mesh4)        # noqa: E731
    y1 = fw1(x24)
    out["dwt1_2e24_4shards"] = {
        "fw_ms": P.med3(fw1, x24, 3) * 1e3,
        "inv_ms": P.med3(lambda _: parallel.idwt1(y1, wt, LEVELS, mesh4),
                         x24, 3) * 1e3,
        "fw_host_ms": P.enqueue_time(fw1, x24, 3) * 1e3,
        "single_card_fw_ms": P.med3(lambda v: w.dwt(v, wt, LEVELS, ndt=1),
                                    x24, 10) * 1e3}
    del y1
    out["parallel_denoise_L6_4shards_ms"] = P.time_fn(
        lambda v: parallel.denoise(v, wt, L=DENOISE_LEVELS, mesh=mesh4), x,
        3, chain=False) * 1e3
    ti = lambda v: w.denoise(v, wt, L=DENOISE_LEVELS, TI=True,  # noqa: E731
                             nspin=NSPIN)
    out["ti_denoise_16k_L6_16spin_ms"] = P.time_fn(ti, x, 2,
                                                   chain=False) * 1e3
    out["ti_denoise_host_ms"] = P.enqueue_time(ti, x, 2) * 1e3
    bb = lambda v: w.bestbasistree(v, db4)                    # noqa: E731
    out["bestbasis_2e20_ms"] = P.time_fn(bb, x1, 3, chain=False) * 1e3
    torch.cuda.empty_cache()

    # I and J in halo mode at one shard's level-1 shape: shard 0 of the
    # 4-shard mesh, its halos the ring neighbours' rows
    fa, fb = axis0.halo_reach(wt, False)
    ia, ib = axis0.halo_reach(wt, True)
    rows_ = SIZE // SHARDS
    xs = x[None, :rows_]
    above, below = x[None, SIZE - fa:], x[None, rows_: rows_ + fb]
    a = torch.empty((1, rows_ // 2, SIZE), dtype=x.dtype, device=dev)
    d = torch.empty_like(a)
    xr = torch.empty_like(xs)
    halos = (a[:, rows_ // 2 - ia:], a[:, :ib], d[:, rows_ // 2 - ia:],
             d[:, :ib])
    rows = {}
    rows["axis0_fw_halo"] = kernel_row(
        "axis0_fw_halo", lambda: axis0.axis0_fw(xs, wt, a, d, above=above,
                                                below=below),
        lambda: axis0.axis0_fw_plain(xs, wt, a, d, above=above, below=below),
        (a, d), TOL[x.dtype], library_halo_fw(xs, above, below, wt),
        lambda o: [o[:, 0], o[:, 1]])
    rows["axis0_inv_halo"] = kernel_row(
        "axis0_inv_halo", lambda: axis0.axis0_inv(a, d, wt, out=xr,
                                                  halos=halos),
        lambda: axis0.axis0_inv_plain(a, d, wt, out=xr, halos=halos), (xr,),
        TOL[x.dtype], library_halo_inv(a, d, halos, wt),
        lambda o: [interleave_rows(o, xs.shape[1:])])
    copy_s, bw = P.copy_bandwidth(xs, 10)
    out["level1_shard_copy_ms"] = copy_s * 1e3
    # F over one shard's rows, [s | d] per row as the sharded inverse
    # reads them (parallel/sharded.py, _local_inv_kernel)
    h = SIZE // 2
    sd, xr1 = torch.empty_like(xs[0]), torch.empty_like(xs[0])
    level1d.level1d_fw(xs[0], wt, sd[:, :h], sd[:, h:])
    shard = kernel_row(
        "level1d_inv_shard", lambda: level1d.level1d_inv(
            sd[:, :h], sd[:, h:], wt, out=xr1),
        lambda: level1d.level1d_inv_plain(sd[:, :h], sd[:, h:], wt, out=xr1),
        (xr1,), TOL[x.dtype], library_inv1d_polyphase(sd[:, :h], sd[:, h:],
                                                      wt),
        lambda o: [interleave1d(o)])
    shard["bound_ms"], shard["bound_by"] = bound(
        2 * xs.numel() * x.element_size(), taps(wt, True) * xs.numel())
    shard["copy_bound_ms"] = copy_s * 1e3
    out["level1d_inv_shard_4096x16384"] = shard
    del sd, xr1
    for name, inverse, nhalo in (("axis0_fw_halo", False, fa + fb),
                                 ("axis0_inv_halo", True, 2 * (ia + ib))):
        nbytes = (2 * rows_ + nhalo) * SIZE * x.element_size()
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(
            nbytes, taps(wt, inverse) * xs.numel())
        rows[name]["copy_bound_ms"] = nbytes / bw * 1e3
    emit(out)
    return rows


def phase_timesroutes(x):
    """Each route's times, and kernel N and the split level's kernels
    beside their plain versions and library calls."""
    cdf, db4 = wavelet("cdf97", "lifting"), wavelet("db4", "filter")
    out = {"phase": "timesroutes", "shape": [SIZE, SIZE], "levels": LEVELS,
           "wavelet": "cdf97", "dtype": "float32"}
    fw = lambda v: w.dwt(v, cdf, LEVELS)        # noqa: E731
    inv = lambda v: w.idwt(v, cdf, LEVELS)      # noqa: E731
    for name, switches, routes in SWITCH_TABLE:
        with switched(switches):
            rec = path_times(fw, inv, x, 4 / 3)
            yt = fw(x)
            tf, ti = trace(fw, x), trace(inv, yt)
            del yt
        rec.update(fw_busy_us=tf["busy_us_per_call"],
                   fw_idle_share=tf["idle_share"],
                   inv_busy_us=ti["busy_us_per_call"],
                   inv_idle_share=ti["idle_share"])
        rec.update(fw_launch_us=tf["launch_us"],
                   inv_launch_us=ti["launch_us"])
        if routes[0] == "stage":
            # N's form for cdf97: the strip form (stage2d.stage_window)
            want = ("stage2_strip_kernel" if stage2d.stage_window(cdf)
                    else "stage2_fw_kernel")
            require(want in tf["kernels"],
                    f"the stage forward's trace shows kernel N ({want}): "
                    f"{tf['kernels']}")
        out[name] = rec
    copy_ms = out["default"]["copy_ms"]

    # N at 16384^2 levels 1-2, beside two conv2d calls (levels 1 and 2)
    xb = x[None]
    y = torch.empty_like(xb)
    outs = (torch.empty((1, SIZE // 4, SIZE // 4), dtype=x.dtype,
                        device=x.device),
            *level2d.detail_planes(y, 1), *level2d.detail_planes(y, 2))
    lib1 = library_fw2d(xb, cdf)
    lib2 = library_fw2d(level2d.level_fw(xb, cdf)[0], cdf)
    rows = {}
    rows["stage2_fw"] = kernel_row(
        "stage2_fw", lambda: stage2d.stage2_fw(xb, cdf, outs),
        lambda: stage2d.stage2_fw_plain(xb, cdf, outs), outs, TOL[x.dtype],
        lambda: (lib1(), lib2()),
        lambda o: [o[1][:, 0], o[0][:, 1], o[0][:, 2], o[0][:, 3],
                   o[1][:, 1], o[1][:, 2], o[1][:, 3]])
    rows["stage2_fw"]["library_calls"] = "conv2d at level 1 + conv2d at level 2"
    # the two A launches that N replaces, into the same planes
    ll1 = torch.empty((1, SIZE // 2, SIZE // 2), dtype=x.dtype,
                      device=x.device)
    two_a = lambda: (level2d.level_fw(xb, cdf, (ll1, *outs[1:4])),  # noqa: E731
                     level2d.level_fw(ll1, cdf, (outs[0], *outs[4:])))
    rows["stage2_fw"]["chain_ms"] = P.med3(lambda _: two_a(), xb, 10) * 1e3
    rows["stage2_fw"]["chain_device_us"] = device_us(two_a, calls=10)
    del ll1
    out["stage2_fw_plan"] = stage2d.stage_plan(xb, cdf, outs)._asdict()
    del lib1, lib2

    # E, I, J and F at the split route's level-1 shapes: E over the 16384
    # rows into the scratch [s | d], I down it into y's halves, J back
    # into a scratch, F over its rows
    h = SIZE // 2
    sc, sc2, xr = (torch.empty_like(xb) for _ in range(3))
    s_, d_ = sc[0, :, :h], sc[0, :, h:]
    a_, dd_ = y[:, :h], y[:, h:]
    s2, d2 = sc2[0, :, :h], sc2[0, :, h:]
    for key, wt in (("lifting", cdf), ("filter", db4)):
        rows[f"{key}_row_fw"] = kernel_row(
            f"{key}_row_fw", lambda: level1d.level1d_fw(x, wt, s_, d_),
            lambda: level1d.level1d_fw_plain(x, wt, s_, d_), (s_, d_),
            TOL[x.dtype], library_fw1d(x, wt), lambda o: [o[:, 0], o[:, 1]])
        rows[f"{key}_col_fw"] = kernel_row(
            f"{key}_col_fw", lambda: axis0.axis0_fw(sc, wt, a_, dd_),
            lambda: axis0.axis0_fw_plain(sc, wt, a_, dd_), (a_, dd_),
            TOL[x.dtype], library_axis0_fw(sc[0].view(SIZE, 1, SIZE), wt),
            lambda o: [o[0, i].view(1, h, SIZE) for i in (0, 1)])
        rows[f"{key}_col_inv"] = kernel_row(
            f"{key}_col_inv", lambda: axis0.axis0_inv(a_, dd_, wt, out=sc2),
            lambda: axis0.axis0_inv_plain(a_, dd_, wt, out=sc2), (sc2,),
            TOL[x.dtype], library_axis0_inv(y[0, :h], y[0, h:], wt),
            lambda o: [interleave_rows(o, (SIZE, 1, SIZE)).view(1, SIZE,
                                                                SIZE)])
        rows[f"{key}_row_inv"] = kernel_row(
            f"{key}_row_inv", lambda: level1d.level1d_inv(s2, d2, wt,
                                                          out=xr[0]),
            lambda: level1d.level1d_inv_plain(s2, d2, wt, out=xr[0]),
            (xr[0],), TOL[x.dtype], library_inv1d_polyphase(s2, d2, wt),
            lambda o: [interleave1d(o)])
    emit(out)
    nbytes = 2 * x.numel() * x.element_size()
    rows["stage2_fw"]["bound_ms"], rows["stage2_fw"]["bound_by"] = bound(
        nbytes, 2 * taps(cdf, False) * x.numel() * 1.25)
    rows["stage2_fw"]["copy_bound_ms"] = copy_ms
    for key, wt in (("lifting", cdf), ("filter", db4)):
        for part in ("row_fw", "col_fw", "col_inv", "row_inv"):
            r = rows[f"{key}_{part}"]
            r["bound_ms"], r["bound_by"] = bound(
                nbytes, taps(wt, part.endswith("inv")) * x.numel())
            r["copy_bound_ms"] = copy_ms
    return rows


def trace(fn, x, calls=5):
    """torch.profiler over ``calls`` calls of ``fn(x)``: the device time of
    each of this repo's kernel launches in the last call (the profiler can
    drop a trace's first launch: a full run once missed the first call's
    kernel N), the names of all its kernels, and the device's busy time
    per call (the union of its events).  The idle share is one
    less the busy time over the same calls' time with the profiler off
    (CUDA events), since the profiler slows the host: the mean of one
    measurement just before the profiled calls and one just after.  The
    busy time must lie within the slower of the two; where it does not,
    the three are taken once more before the check fails: the card's
    clocks can fall between two measurements (a full run once took a
    route's calls 17% longer than the same card takes them alone, and its
    profiled calls 34% longer)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(2):
        before_us = P.time_fn(fn, x, calls, chain=False) * 1e6
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn(x)
            torch.cuda.synchronize()
        after_us = P.time_fn(fn, x, calls, chain=False) * 1e6
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
        if busy / calls <= 1.05 * max(before_us, after_us):
            break
    ours = [e for e in ev if "_kernel" in e.name]
    require(ours, "the profiler recorded this repo's kernels")
    require(busy / calls <= 1.05 * max(before_us, after_us),
            f"device busy {busy / calls:.1f} us per call within the call's "
            f"{before_us:.1f} / {after_us:.1f} us")
    call_us = (before_us + after_us) / 2

    # the last call's launches (a dropped launch shortens the trace by one)
    last = ours[len(ours) - -(-len(ours) // calls):]
    return {"launch_us": [[kernel_name(e), round(e.time_range.end
                                                 - e.time_range.start, 2)]
                          for e in last],
            "kernels": sorted({kernel_name(e) for e in ours}),
            "busy_us_per_call": busy / calls, "call_us": call_us,
            "call_us_before_after": [before_us, after_us],
            "idle_share": 1 - busy / calls / call_us}


def phase_trace(x, xs):
    cdf = w.wavelet(w.wt.cdf97, "lifting")
    db4 = wavelet("db4", "filter")
    x2 = x[:2048, :2048].contiguous()
    runs = [("2d_16384_cdf97_L8", x, (lambda v: w.dwt(v, cdf, LEVELS),
                                      lambda v: w.idwt(v, cdf, LEVELS))),
            ("2d_2048_cdf97_L8", x2, (lambda v: w.dwt(v, cdf, LEVELS),
                                      lambda v: w.idwt(v, cdf, LEVELS)))]
    for name, shape, (wname, kind), L, packet in PATHS1D:
        runs.append((name, xs[shape],
                     path_fns(shape, wavelet(wname, kind), L, packet)))
    runs.append(("3d_256_cdf97_L3", xs[(SIZE3D,) * 3],
                 (lambda v: w.dwt(v, cdf, LEVELS3D),
                  lambda v: w.idwt(v, cdf, LEVELS3D))))
    runs.append(("modwt_512x8192_db4_L6", xs[MODWT_SHAPE],
                 (lambda v: w.modwt(v, db4, MODWT_LEVELS),
                  lambda v: w.imodwt(v, db4))))
    mesh = parallel.Mesh([x.device] * SHARDS, ("x",))
    runs.append(("sharded_2d_16384_cdf97_L8_4shards", x,
                 (lambda v: parallel.dwt2(v, cdf, LEVELS, mesh), None)))
    for name, xt, (fw, inv) in runs:
        rec = {"phase": "trace", "path": name, "fw": trace(fw, xt)}
        if inv is not None:
            yt = fw(xt)
            rec["inv"] = trace(inv, yt)
            del yt
        elif name.startswith("sharded"):
            # the sharded inverse reads a Sharded, not a tensor: one
            # forward's result, the argument unused
            ys = fw(xt)
            rec["inv"] = trace(
                lambda _: parallel.idwt2(ys, cdf, LEVELS, mesh), xt)
            del ys
        emit(rec)


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_kernels(dev)
    phase_kernels1d(dev)
    phase_kernels3d(dev)
    phase_kernelslevel3d(dev)
    phase_kernelsmodwt(dev)
    phase_kernelshalo(dev)
    phase_kernelsstage(dev)
    phase_graphs(dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (SIZE, SIZE)).astype(np.float32)).to(dev)
    # each kernel's launches on its own main path
    launches = phase_main(x)
    xs = inputs1d(dev)
    launches.update({k: v for k, v in phase_main1d(xs).items()
                     if k.endswith(("1d_fw", "1d_inv"))})
    launches.update({k: v for k, v in phase_main3d(xs[(SIZE3D,) * 3]).items()
                     if k in ("axis0_fw", "axis0_inv", "level3_fw",
                              "level3_inv")})
    xlong = xs[(1 << 24,)].view(-1, MODWT_LONG[1])[:MODWT_LONG[0]]
    launches.update({k: v for k, v in phase_mainmodwt(xs[MODWT_SHAPE],
                                                      xlong).items()
                     if k.startswith("modwt")})
    xsig = signal_image(x)
    launches.update({k: v for k, v in phase_mainsharded(x, xsig).items()
                     if k.endswith("_halo")})
    torch.cuda.empty_cache()
    phase_mainthreshold(xsig, xs[(1 << 20,)])
    del xsig
    torch.cuda.empty_cache()
    by_route = phase_mainroutes(x)
    launches["stage2_fw"] = by_route["mxu_ls2"]["cdf97_16384"]["stage2_fw"]
    torch.cuda.empty_cache()
    require(all(v > 0 for v in launches.values()),
            f"every kernel launched on its main path: {launches}")
    rows = phase_times(dev, x)
    torch.cuda.empty_cache()
    rows.update(phase_times1d(xs))
    torch.cuda.empty_cache()
    rows.update(phase_times3d(xs[(SIZE3D,) * 3]))
    rows.update(phase_timesmodwt(xs[MODWT_SHAPE]))
    torch.cuda.empty_cache()
    rows.update(phase_timessharded(x, xs[(1 << 20,)], xs[(1 << 24,)]))
    torch.cuda.empty_cache()
    rows.update(phase_timesroutes(x))
    torch.cuda.empty_cache()
    phase_trace(x, xs)
    tail_times(x, rows)
    profiled_times(x, xs, rows)
    phase_forms(dev)
    src = {"level_fw": "level2d.cu", "level_inv": "level2d.cu",
           "tail_fw": "tail2d.cu", "tail_inv": "tail2d.cu",
           "level1d_fw": "level1d.cu", "level1d_inv": "level1d.cu",
           "tail1d_fw": "tail1d.cu", "tail1d_inv": "tail1d.cu",
           "axis0_fw": "axis0.cu", "axis0_inv": "axis0.cu",
           "modwt_fw": "modwt1d.cu", "modwt_inv": "modwt1d.cu",
           "modwt_fw_levels": "modwt1d.cu", "modwt_inv_levels": "modwt1d.cu",
           "axis0_fw_halo": "axis0.cu", "axis0_inv_halo": "axis0.cu",
           "stage2_fw": "stage2d.cu", "level3_fw": "level3d.cu",
           "level3_inv": "level3d.cu"}
    replaces = {"level_fw": "wavelets_tpu/ops/pallas/mxu2d.py:1610",
                "level_inv": "wavelets_tpu/ops/pallas/mxu2d.py:1236",
                "tail_fw": "wavelets_tpu/ops/pallas/tail2d.py:52",
                "tail_inv": "wavelets_tpu/ops/pallas/tail2d.py:82",
                "level1d_fw": "wavelets_tpu/ops/pallas/dwt1d.py:356",
                "level1d_inv": "wavelets_tpu/ops/pallas/dwt1d.py:379",
                "tail1d_fw": "wavelets_tpu/ops/pallas/pyramid1d.py:236",
                "tail1d_inv": "wavelets_tpu/ops/pallas/pyramid1d.py:400",
                "axis0_fw": "wavelets_tpu/ops/pallas/axis0.py:173",
                "axis0_inv": "wavelets_tpu/ops/pallas/axis0.py:214",
                "modwt_fw": "wavelets_tpu/ops/pallas/modwt1d.py:85",
                "modwt_inv": "wavelets_tpu/ops/pallas/modwt1d.py:93",
                "modwt_fw_levels": "wavelets_tpu/ops/pallas/modwt1d.py:85",
                "modwt_inv_levels": "wavelets_tpu/ops/pallas/modwt1d.py:93",
                "axis0_fw_halo": "wavelets_tpu/ops/pallas/axis0.py:318",
                "axis0_inv_halo": "wavelets_tpu/ops/pallas/axis0.py:417",
                "stage2_fw": "wavelets_tpu/ops/pallas/stage2d.py:154",
                "level3_fw": "wavelets_tpu/ops/pallas/dwt3d.py:56",
                "level3_inv": "wavelets_tpu/ops/pallas/dwt3d.py:86"}
    # the kernels redesigned for Hopper and their form: persistent blocks
    # staging 16-byte tiles with the bands in registers ("tiled", where
    # the span is below 16), a thread-block cluster per image or row, N's
    # persistent strips walked downward ("strips") and G's and H's rows
    # staged once ("staged"), all below a span of 16
    redesigned = {"tail_fw": "cluster", "tail_inv": "cluster",
                  "modwt_fw_levels": "cluster",
                  "modwt_inv_levels": "cluster", "level_fw": "tiled",
                  "level_inv": "tiled", "level1d_fw": "tiled",
                  "level1d_inv": "tiled", "axis0_inv": "tiled",
                  "axis0_inv_halo": "tiled", "axis0_fw": "tiled",
                  "axis0_fw_halo": "tiled", "stage2_fw": "strips",
                  "tail1d_fw": "staged", "tail1d_inv": "staged",
                  "level3_fw": "one pass", "level3_inv": "one pass"}
    # the TPU kernels that a route of phase 3g runs on a kernel above: its
    # name, the kernel, the row of measurements, the TPU kernel, and its
    # launches on that route
    pallas = "wavelets_tpu/ops/pallas/"
    mapped = [
        ("fused2d_quad_fw", "level_fw", "level_fw", "fused2d.py:229",
         by_route["mxu2d_0"]["cdf97_16384"]["level_fw"]),
        ("fused2d_packed_fw", "level_fw", "level_fw", "fused2d.py:274",
         by_route["mxu2d_0_packed2d"]["cdf97_16384"]["level_fw"]),
        ("fused2d_inv", "level_inv", "level_inv", "fused2d.py:420",
         by_route["mxu2d_0_fused_inv"]["cdf97_16384"]["level_inv"])]
    for key, mod, tag, lines in (
            ("lifting", "lifting2d", "cdf97_16384", (165, 172, 202, 246)),
            ("filter", "filter2d", "db4_4096", (104, 119, 152, 198))):
        split = by_route["mxu2d_0_fused2d_0"][tag]
        for (part, kern), line in zip(
                (("row_fw", "level1d_fw"), ("row_inv", "level1d_inv"),
                 ("col_fw", "axis0_fw"), ("col_inv", "axis0_inv")), lines):
            mapped.append((f"{mod}_{part}", kern, f"{key}_{part}",
                           f"{mod}.py:{line}", split[kern]))
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    # the card's name and power limit again, beside the numbers below
    print(smi, flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"wavelets_tpu_torch/csrc/{src[name]}",
         "replaces": replaces[name], "launches": launches[name],
         **({"redesigned": redesigned[name]} if name in redesigned else {}),
         **{k: rows[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms", "copy_bound_ms",
                                        "library_calls", "device_us",
                                        "library_device_us", "host_ms",
                                        "floor_ms", "cluster", "chain_ms",
                                        "chain_device_us", "first_form_ms",
                                        "first_form_device_us",
                                        "library_chain_ms",
                                        "library_chain_device_us")
            if k in rows[name]}}
        for name in src] + [
        {"name": name, "route": "cuda",
         "source": f"wavelets_tpu_torch/csrc/{src[kern]}",
         "replaces": pallas + where, "launches": n, "runs_on": kern,
         **({"redesigned": redesigned[kern]} if kern in redesigned else {}),
         **{k: rows[row][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms", "copy_bound_ms")}}
        for name, kern, row, where, n in mapped]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
