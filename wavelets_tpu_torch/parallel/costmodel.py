"""α-β communication cost model for the sharded multi-level drivers.

A copy of ``wavelets_tpu/parallel/costmodel.py``, function for function, so
that both packages pick the same deep-tail switch level for the same
shape.  Per-level halo exchanges cost t = α + bytes/β; the model compares,
per level of a rows-sharded transform (parallel/sharded.py):

  halo:      t = 2α + 2·h·rowbytes/β   + t_comp/nd
  gather:    t = α·ceil(log2 nd) + (nd-1)/nd·m_l·rowbytes/β + t_comp
             (every shard computes the whole active band: the global
             fallback's cost shape)
  replicate: gather once at the switch level, then no communication at
             full redundant compute.

The transport presets ``ici`` and ``dcn`` and the per-chip ``hbm_Bps`` and
``passes`` are the JAX package's values, kept as they are so that the
switch matches; they were set for another machine and are not rates of
this port or of any card.  A preset for one host of CUDA cards waits for a
measurement across cards (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["Scenario", "SCENARIOS", "fit_alpha_beta", "level_times",
           "project", "tail_switch_level"]


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    alpha_s: float          # per-message latency (seconds)
    beta_Bps: float         # link bandwidth (bytes/second)
    hbm_Bps: float = 650e9  # per-chip streaming rate (the JAX package's)
    passes: float = 2.3     # HBM passes per level (kernel traffic model)


SCENARIOS = {
    "ici": Scenario("ici", alpha_s=1e-6, beta_Bps=9e10),
    "dcn": Scenario("dcn", alpha_s=3e-5, beta_Bps=2.5e10),
}


def fit_alpha_beta(levels, n_cols, itemsize, halo_rows):
    """Least-squares fit of t_halo = α + bytes/β over the per-level halo
    measurements ``levels`` = [{"t_halo_only_ms": .., ...}, ...] (the
    layout of the JAX package's MULTIHOST2P records).  The halo message size is constant across
    levels (h rows × local cols), so the fit degenerates to α-only with
    β unidentifiable — returned as (alpha_s, None) in that case; callers
    fall back to preset β.  Returns (alpha_s, beta_Bps|None, residuals)."""
    ts = [lv["t_halo_only_ms"] * 1e-3 for lv in levels]
    sizes = [2 * halo_rows * n_cols * itemsize for _ in levels]
    if len(set(sizes)) == 1:
        # constant message size: α absorbs the whole mean; β from spread
        # is noise, not signal
        alpha = sum(ts) / len(ts) / 2.0     # 2 messages per level
        resid = [t - 2 * alpha for t in ts]
        return alpha, None, resid
    # general case (varying sizes): classic linear fit
    n = len(ts)
    sx = sum(sizes)
    sy = sum(ts)
    sxx = sum(s * s for s in sizes)
    sxy = sum(s * t for s, t in zip(sizes, ts))
    denom = n * sxx - sx * sx
    inv_beta = (n * sxy - sx * sy) / denom
    alpha = (sy - inv_beta * sx) / n / 2.0
    beta = 1.0 / inv_beta if inv_beta > 0 else None
    resid = [t - (2 * alpha + s * inv_beta) for s, t in zip(ts, sizes)]
    return alpha, beta, resid


def level_times(m_l, n_cols, itemsize, halo_rows, nd, sc: Scenario):
    """(t_halo, t_gather, t_comp_sharded) seconds for one level with
    ``m_l`` active rows on an ``nd``-way rows-sharded mesh."""
    rowbytes = n_cols * itemsize
    t_comp = sc.passes * m_l * rowbytes / sc.hbm_Bps
    t_halo = 2 * sc.alpha_s + 2 * halo_rows * rowbytes / sc.beta_Bps \
        + t_comp / nd
    t_gather = (sc.alpha_s * math.ceil(math.log2(nd))
                + (nd - 1) / nd * m_l * rowbytes / sc.beta_Bps
                + t_comp)
    return t_halo, t_gather, t_comp / nd


def tail_switch_level(m, n_cols, itemsize, halo_rows, nd, L,
                      sc: Scenario) -> int:
    """First level (1-indexed) at which the model prefers gather over
    halo; L+1 when halo wins everywhere.  The structural bound (shard
    smaller than the halo reach) still applies on top of this in the
    driver.

    This is the pure model: the WAVELETS_TPU_SHARD_TAIL_LEVEL override
    lives in the sharded driver (sharded.tail_switch_for), not here."""
    for lvl in range(1, L + 1):
        m_l = m >> (lvl - 1)
        if m_l // nd < max(2, halo_rows):
            return lvl                       # structural: halo impossible
        t_h, t_g, _ = level_times(m_l, n_cols, itemsize, halo_rows, nd, sc)
        if t_g < t_h:
            return lvl
    return L + 1


def project(m, n_cols, L, itemsize, halo_rows, nd, sc: Scenario):
    """Per-level policy table + weak-scaling efficiency projection.

    Weak scaling: the global image is (nd·m_single, n) so each host
    holds one single-host problem; efficiency = single-host time over
    the projected sharded time of the same per-host work."""
    switch = tail_switch_level(m, n_cols, itemsize, halo_rows, nd, L, sc)
    rows = []
    t_total = 0.0
    t_single = 0.0
    for lvl in range(1, L + 1):
        m_l = m >> (lvl - 1)
        t_h, t_g, t_c = level_times(m_l, n_cols, itemsize, halo_rows,
                                    nd, sc)
        policy = "halo" if lvl < switch else "gather"
        t = t_h if policy == "halo" else t_g
        t_total += t
        # the single-host reference does this level's per-host share
        t_single += sc.passes * (m_l // nd) * n_cols * itemsize / sc.hbm_Bps
        rows.append({"level": lvl, "rows": m_l, "policy": policy,
                     "t_halo_ms": t_h * 1e3, "t_gather_ms": t_g * 1e3,
                     "t_ms": t * 1e3})
    return {"scenario": sc.name, "alpha_s": sc.alpha_s,
            "beta_GBps": sc.beta_Bps / 1e9, "nd": nd,
            "global_shape": [m, n_cols], "levels": rows,
            "switch_level": switch,
            "t_sharded_ms": t_total * 1e3,
            "t_single_host_ms": t_single * 1e3,
            "weak_scaling_efficiency": t_single / t_total}
