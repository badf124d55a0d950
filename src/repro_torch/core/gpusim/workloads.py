"""Workload profiles for the reproduction simulator.

Each profile parameterizes one benchmark of the paper's evaluation
(Ispass/Rodinia/Polybench/Mars suites) with the characteristics the paper
reports for it:

* ``mem_frac`` / ``branch_frac`` — instruction mix (load/store rate and
  control rate of Table 2's features).
* ``coalesce_base`` — actual-memory-access rate after coalescing on a
  32-wide warp (Fig 4/16: fraction of the instruction's accesses that
  survive coalescing; lower = better coalescing).
* ``coalesce_gain`` — multiplier on that rate when the warp doubles
  (Fig 4: fused SMs coalesce across what used to be two SMs).
* ``l1_miss`` / ``loc_alpha`` — L1D miss rate at 16 KB and its capacity
  sensitivity (miss ~ (16KB/cap_eff)^alpha); alpha=0 is streaming.
* ``share`` — cross-SM L1 sharing rate (Fig 5): fusion dedups shared lines,
  cap_eff = 2 x 16KB x (1 + share).
* ``l1i_miss`` — I-cache miss rate; fusion shares the I-cache (Fig 14).
* ``div_base/div_amp/div_period`` — divergent-warp fraction over time
  (Fig 6/13/19); the square-wave phase structure drives dynamic splitting.
* ``mlp`` — memory-level parallelism demand (MSHR pressure of Table 2).

Values are calibrated so the reproduction matches the paper's §5 headline
results (SM 4.25x, MUM 2.11x, ~47% geomean, regroup ~16% over direct
split, ~27% over DWS) — see benchmarks/fig12_performance.py.

Counterpart of ``repro/core/gpusim/workloads.py``: the same profiles, and
variants drawn with the same numpy calls in the same order, so they are
equal field for field.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Workload:
    name: str
    mem_frac: float            # memory instructions / all instructions
    branch_frac: float         # control instructions / all instructions
    coalesce_base: float       # actual access rate after coalescing (32-wide)
    coalesce_gain: float       # x on the rate when fused (64-wide warp)
    l1_miss: float             # L1D miss rate at 16 KB
    loc_alpha: float           # capacity sensitivity exponent (0 = streaming)
    share: float               # cross-SM L1 sharing rate
    l1i_miss: float            # L1I miss rate (split SMs)
    div_base: float            # baseline divergent-warp fraction
    div_amp: float             # phase amplitude of divergence
    div_period: int            # epochs per divergence phase cycle
    mlp: float                 # in-flight memory requests demanded per warp
    ctas: int = 8              # concurrent CTAs per SM
    div_phase: float = 0.0     # phase offset (fraction of period) of bursts


# ---------------------------------------------------------------------------
# The 12 benchmarks of Fig. 12 (calibrated to the paper's reported behavior)
# ---------------------------------------------------------------------------

WORKLOADS: Dict[str, Workload] = {
    # SM (Mars string-match): L1-capacity-bound; sharing makes fusion huge
    # (paper: L1D miss -70%, speedup 4.25x).
    "SM": Workload("SM", mem_frac=0.42, branch_frac=0.04,
                   coalesce_base=0.55, coalesce_gain=0.60,
                   l1_miss=0.82, loc_alpha=1.00, share=0.35, l1i_miss=0.10,
                   div_base=0.04, div_amp=0.02, div_period=60, mlp=12.0),
    # MUM (MUMmer): NoC/memory bound, poor locality, strong coalescing gain
    # (paper: 2.11x).
    "MUM": Workload("MUM", mem_frac=0.50, branch_frac=0.08,
                    coalesce_base=0.75, coalesce_gain=0.68,
                    l1_miss=0.65, loc_alpha=0.45, share=0.28, l1i_miss=0.14,
                    div_base=0.10, div_amp=0.08, div_period=50, mlp=10.0),
    # BFS: irregular, MSHR/L1I-sensitive, divergence bursts -> dynamic wins.
    "BFS": Workload("BFS", mem_frac=0.20, branch_frac=0.16,
                    coalesce_base=0.60, coalesce_gain=0.92,
                    l1_miss=0.40, loc_alpha=1.1, share=0.12, l1i_miss=0.18,
                    div_base=0.18, div_amp=0.30, div_period=36, mlp=9.0),
    # RAY: scale-up trend with late divergence phases (Fig 8 / Fig 19).
    "RAY": Workload("RAY", mem_frac=0.15, branch_frac=0.13,
                    coalesce_base=0.60, coalesce_gain=0.92,
                    l1_miss=0.35, loc_alpha=1.3, share=0.15, l1i_miss=0.12,
                    div_base=0.10, div_amp=0.38, div_period=48, mlp=6.0),
    # LIB: scale-out trend (Fig 8), mild everything.
    "LIB": Workload("LIB", mem_frac=0.18, branch_frac=0.07,
                    coalesce_base=0.38, coalesce_gain=1.00,
                    l1_miss=0.30, loc_alpha=0.05, share=0.01, l1i_miss=0.05,
                    div_base=0.20, div_amp=0.10, div_period=40, mlp=4.0),
    # CP: compute-dense, scales out (Fig 3 with perfect NoC).
    "CP": Workload("CP", mem_frac=0.12, branch_frac=0.05,
                   coalesce_base=0.25, coalesce_gain=0.98,
                   l1_miss=0.22, loc_alpha=0.15, share=0.01, l1i_miss=0.03,
                   div_base=0.12, div_amp=0.06, div_period=44, mlp=3.0),
    # SC (streamcluster): scale-out, streaming L1.
    "SC": Workload("SC", mem_frac=0.26, branch_frac=0.06,
                   coalesce_base=0.30, coalesce_gain=0.96,
                   l1_miss=0.50, loc_alpha=0.05, share=0.01, l1i_miss=0.04,
                   div_base=0.18, div_amp=0.08, div_period=52, mlp=16.0),
    # 3MM (polybench): dense GEMM chain, prefers scale-out.
    "3MM": Workload("3MM", mem_frac=0.18, branch_frac=0.02,
                    coalesce_base=0.16, coalesce_gain=0.99,
                    l1_miss=0.28, loc_alpha=0.10, share=0.01, l1i_miss=0.02,
                    div_base=0.06, div_amp=0.03, div_period=64, mlp=3.0),
    # ATAX: bandwidth-streaming polybench kernel, scale-out.
    "ATAX": Workload("ATAX", mem_frac=0.30, branch_frac=0.02,
                     coalesce_base=0.20, coalesce_gain=0.99,
                     l1_miss=0.60, loc_alpha=0.03, share=0.00, l1i_miss=0.02,
                     div_base=0.10, div_amp=0.02, div_period=64, mlp=16.0),
    # FWT: insensitive to scaling (paper).
    "FWT": Workload("FWT", mem_frac=0.14, branch_frac=0.04,
                    coalesce_base=0.28, coalesce_gain=0.93,
                    l1_miss=0.25, loc_alpha=0.12, share=0.02, l1i_miss=0.03,
                    div_base=0.08, div_amp=0.04, div_period=56, mlp=4.0),
    # KM (kmeans): insensitive.
    "KM": Workload("KM", mem_frac=0.16, branch_frac=0.05,
                   coalesce_base=0.24, coalesce_gain=0.94,
                   l1_miss=0.28, loc_alpha=0.10, share=0.02, l1i_miss=0.04,
                   div_base=0.09, div_amp=0.05, div_period=48, mlp=4.0),
    # WP: phase-heavy divergence — static fusion backfires (paper: WP
    # degrades under static fuse; dynamic recovers).
    "WP": Workload("WP", mem_frac=0.12, branch_frac=0.14,
                   coalesce_base=0.55, coalesce_gain=0.85,
                   l1_miss=0.35, loc_alpha=0.4, share=0.05, l1i_miss=0.08,
                   div_base=0.22, div_amp=0.42, div_period=28, mlp=7.0,
                   div_phase=0.5),
}


def workload_variants(base: Workload, n: int, seed: int) -> Tuple[Workload, ...]:
    """Randomized perturbations of a profile — the offline training corpus
    for the scalability predictor ('a large amount of offline experimental
    data', §4.1.3)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        f = lambda v, lo=0.0, hi=1.0: float(
            np.clip(v * rng.uniform(0.6, 1.5), lo, hi))
        out.append(replace(
            base,
            name=f"{base.name}#{i}",
            mem_frac=f(base.mem_frac, 0.02, 0.6),
            branch_frac=f(base.branch_frac, 0.0, 0.3),
            coalesce_base=f(base.coalesce_base, 0.05, 1.0),
            coalesce_gain=f(base.coalesce_gain, 0.4, 1.0),
            l1_miss=f(base.l1_miss, 0.02, 0.95),
            loc_alpha=f(base.loc_alpha, 0.0, 3.0),
            share=f(base.share, 0.0, 0.5),
            l1i_miss=f(base.l1i_miss, 0.0, 0.3),
            div_base=f(base.div_base, 0.0, 0.5),
            div_amp=f(base.div_amp, 0.0, 0.5),
            mlp=f(base.mlp, 1.0, 24.0),
        ))
    return tuple(out)
