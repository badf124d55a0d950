"""Cycle-approximate AMOEBA simulator (Table 1 machine, §4-§5 mechanisms).

The machine is the paper's baseline: 48 scale-out SMs (24 neighbor pairs),
SIMD width 8, warp 32, 64 MSHRs/SM, 16 KB L1/SM, 8 MCs behind a 2-stage
mesh NoC with two subnets.  Fusing a pair (paper Fig 9) merges L1s
(capacity doubles, +1 cycle), merges coalescing units (the 64-wide warp
coalesces across the former SM boundary), bypasses one NoC router (network
shrinks), and couples both datapaths behind one scheduler (divergence now
stalls a 64-wide pipe).

Dynamic splitting (Fig 10/11) decouples only the *issue* paths: "we do not
split the shared resources, such as L1 cache, register files, and NoC
interface" — so a pair has three states:

  SPLIT_BASE  — never fused: 2 narrow SMs, private L1s, 2 NoC ports.
  FUSED       — 1 wide SM: shared L1 (+1 cycle), merged coalescer, 1 port.
  QSPLIT      — split *from* fused: 2 narrow issue paths (divergent warps
                quarantined on one), but L1/MSHR/NoC stay merged; the
                64-wide coalescing gain is lost (warps are 32-wide again).

``direct_split`` cuts divergent warps in the middle (imperfect segregation);
``warp_regroup`` sorts threads into an all-slow warp and backfills idle
slots on the slow half with fast warps.

Per epoch each pair's throughput is the min of three bounds — issue
(divergence/fetch-limited), memory (MSHR Little's-law), and NoC (MC
bandwidth + interface caps) — solved to a fixed point since NoC latency
depends on injected traffic.  This three-bound structure is the same
compute/memory/collective roofline the mesh-level controller uses; the
simulator is the paper's world, the mesh is ours.

Counterpart of ``repro/core/gpusim/sim.py``, on the port's control plane
(``repro_torch.control``).  It stays numpy on the host and does the
reference's operations in the reference's order, so every ``SimResult``
(its per-epoch trace included) is equal to the reference's bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.configs.paper_gpu import PAPER_GPU
from repro_torch.control import (ConfigSpace, OraclePolicy, PredictorPolicy,
                           hysteresis_toggle, n_parts)
from repro_torch.core.gpusim.workloads import WORKLOADS, Workload

# -- machine constants (derived from Table 1) -------------------------------
N_PAIRS = PAPER_GPU.num_sms // 2           # 24
ISSUE_PER_PAIR = 2 * PAPER_GPU.simd_width  # 16 issue slots/cycle/pair
LINE_BYTES = 64.0
CHAN_BYTES = PAPER_GPU.noc_channel_bits / 8          # 16 B/cycle/port
# 2 subnets (request/reply), MC side clocked at 924/700 of the core clock
NOC_CAPACITY = PAPER_GPU.num_memory_controllers * CHAN_BYTES * 2 \
    * (PAPER_GPU.mem_clock_mhz / PAPER_GPU.core_clock_mhz)
L2_LAT = PAPER_GPU.l2_latency_cycles
DRAM_LAT = PAPER_GPU.dram_latency_cycles
L2_MISS = 0.45                              # fraction of L1 misses hitting DRAM

# -- pair states -------------------------------------------------------------
SPLIT_BASE, FUSED, QSPLIT = 0, 1, 2

# -- divergence penalties (§3.1(3): wide pipes stall ~2x) --------------------
P_NARROW = 0.55
P_WIDE = 1.15
I_PEN = 0.55                                # fetch-stall weight of L1I misses
DWS_FACTOR = 0.45                           # intra-SM subdivision residual
REGROUP_Q = 0.92                            # warp_regroup segregation quality
DIRECT_Q = 0.50                             # direct mid-split segregation
BACKFILL = 0.40                             # fast-warp backfill into slow SM
SWITCH_COST = 0.06                          # epoch fraction lost per toggle
MSHR_IMBALANCE = 0.93                       # split MSHR domains pack worse

EPOCHS = 160
FEATURE_NAMES = (
    "noc_throughput", "noc_latency", "coalesce_rate", "l1d_miss",
    "l1i_miss", "l1c_miss", "mshr_rate", "inactive_rate",
    "load_insn_rate", "store_insn_rate", "concurrent_cta",
)


def _divergence(w: Workload, t: np.ndarray, jitter: np.ndarray) -> np.ndarray:
    """Divergent-warp fraction per (epoch, pair): square-wave phases."""
    off = getattr(w, "div_phase", 0.0) * w.div_period
    phase = ((t[:, None] + jitter[None, :] + off) % w.div_period) / w.div_period
    wave = (phase < 0.45).astype(np.float64)
    return np.clip(w.div_base + w.div_amp * wave, 0.0, 0.95)


def _issue_eff(w: Workload, d: np.ndarray, st: np.ndarray,
               quarantine: float, dws: bool) -> np.ndarray:
    """Issue efficiency in [0,1] per pair given divergence and state."""
    l1i = w.l1i_miss * np.where(st >= FUSED, 0.5, 1.0)
    e_fetch = 1.0 - l1i * I_PEN
    if dws:
        e_div = 1.0 - np.minimum(d * P_NARROW * DWS_FACTOR, 1.0)
    else:
        e_narrow = 1.0 - np.minimum(d * P_NARROW, 1.0)
        e_wide = 1.0 - np.minimum(d * P_WIDE, 1.0)
        q = quarantine
        d_fast = d * (1.0 - q)
        d_slow = np.minimum(2.0 * d * q, 1.0)
        e_fast = 1.0 - np.minimum(d_fast * P_NARROW, 1.0)
        e_slow = 1.0 - np.minimum(d_slow * P_NARROW, 1.0)
        if q >= REGROUP_Q:
            # regrouped slow warps are all-slow; idle slots backfilled with
            # fast warps (paper: "periodically move some fast warps")
            e_q = 0.5 * e_fast + 0.5 * (e_slow + BACKFILL * (1.0 - e_slow))
        else:
            # direct mid-cut traps fast threads inside half-slow warps on the
            # slow SM: roughly half its issue slots do no useful work
            e_q = 0.5 * e_fast + 0.5 * (0.55 * e_slow + 0.45 * e_slow * 0.5)
        e_div = np.select([st == SPLIT_BASE, st == FUSED], [e_narrow, e_wide],
                          default=e_q)
    return np.maximum(e_fetch * e_div, 0.02)


def _memory_terms(w: Workload, st: np.ndarray):
    """(miss-per-instruction, coalesce rate, l1d miss) per pair."""
    # 64-wide coalescing only while actually fused; merged L1 also in QSPLIT
    c_eff = w.coalesce_base * np.where(st == FUSED, w.coalesce_gain, 1.0)
    cap_mult = np.where(st >= FUSED, 2.0 * (1.0 + w.share), 1.0)
    mu = np.minimum(w.l1_miss * cap_mult ** (-w.loc_alpha), 0.98)
    mpi = w.mem_frac * c_eff * mu
    return mpi, c_eff, mu


def _usable_mshr(w: Workload, st: np.ndarray, dws: bool = False) -> np.ndarray:
    """Merged MSHRs (FUSED/QSPLIT) pool perfectly; split domains pack worse.

    DWS (Fig 21) subdivides warps on memory divergence so hit-threads keep
    issuing — modeled as better MSHR utilization, its intra-SM-only benefit.
    """
    split = MSHR_IMBALANCE * 2.0 * np.minimum(PAPER_GPU.mshr_per_core,
                                              w.mlp * 8.0)
    merged = np.minimum(2.0 * PAPER_GPU.mshr_per_core, w.mlp * 16.0)
    out = np.where(st >= FUSED, merged, split)
    return out * 1.35 if dws else out


@dataclass
class SimResult:
    ipc: float
    trace: np.ndarray                 # (E, N_PAIRS) int states
    control_stall: float              # Fig 13
    l1i_miss: float                   # Fig 14
    l1d_miss: float                   # Fig 15
    actual_mem_rate: float            # Fig 16
    noc_stall: float                  # Fig 17
    injection_rate: float             # Fig 18 (bytes/cycle/router)
    switches: int = 0


def _epoch_throughput(w: Workload, st: np.ndarray, d: np.ndarray,
                      quarantine: float, dws: bool):
    """Fixed-point solve of the three bounds for one epoch.

    Returns (ipc_per_pair, stats dict).
    """
    e = _issue_eff(w, d, st, quarantine, dws)
    ipc_compute = ISSUE_PER_PAIR * e
    mpi, c_eff, mu = _memory_terms(w, st)
    mshr = _usable_mshr(w, st, dws)

    n_routers = int(PAPER_GPU.num_sms - (st >= FUSED).sum()) \
        + PAPER_GPU.num_memory_controllers
    side = math.sqrt(n_routers)
    hops = (2.0 / 3.0) * side
    base_rtt = 2.0 * hops * (PAPER_GPU.noc_router_stages + 1)

    iface_cap = np.where(st >= FUSED, CHAN_BYTES, 2 * CHAN_BYTES)

    ipc = ipc_compute.copy()
    rho = 0.0
    for _ in range(8):
        traffic = ipc * mpi * LINE_BYTES                  # B/cycle/pair
        total = traffic.sum()
        rho = min(total / NOC_CAPACITY, 0.995)
        congestion = 1.0 / (1.0 - min(rho, 0.90))
        rtt = base_rtt * congestion
        lat = L2_LAT + rtt + L2_MISS * DRAM_LAT + np.where(st >= FUSED, 1., 0.)
        ipc_mem = mshr / np.maximum(mpi * lat, 1e-9)
        ipc_iface = iface_cap / np.maximum(mpi * LINE_BYTES, 1e-9)
        ipc_new = np.minimum.reduce([ipc_compute, ipc_mem, ipc_iface])
        # hard MC-bandwidth constraint: aggregate traffic <= NoC capacity
        total_new = (ipc_new * mpi * LINE_BYTES).sum()
        if total_new > NOC_CAPACITY:
            ipc_new = ipc_new * (NOC_CAPACITY / total_new)
        ipc = 0.5 * ipc + 0.5 * ipc_new

    e_fetch = 1.0 - (w.l1i_miss * np.where(st >= FUSED, .5, 1.)) * I_PEN
    stats = {
        "rho": rho,
        "control_stall": float(np.mean(1.0 - e / np.maximum(e_fetch, 1e-9))),
        "l1i_miss": float(np.mean(w.l1i_miss * np.where(st >= FUSED, .5, 1.))),
        "l1d_miss": float(np.mean(mu)),
        "actual_mem_rate": float(np.mean(c_eff)),
        "noc_stall": float(max(0.0, rho - 0.85) / 0.15),
        "injection_rate": float((ipc * mpi * LINE_BYTES).sum() / n_routers),
    }
    return ipc, stats


def _pair_estimate(w: Workload, st: np.ndarray, d: np.ndarray,
                   quarantine: float, dws: bool, rho: float) -> np.ndarray:
    """Per-pair throughput estimate for the switch controller (no global
    fixed point: uses last epoch's congestion and an equal NoC share)."""
    e = _issue_eff(w, d, st, quarantine, dws)
    ipc_c = ISSUE_PER_PAIR * e
    mpi, _, _ = _memory_terms(w, st)
    mshr = _usable_mshr(w, st, dws)
    congestion = 1.0 / (1.0 - min(rho, 0.90))
    n_routers = PAPER_GPU.num_sms - int((st >= FUSED).sum()) \
        + PAPER_GPU.num_memory_controllers
    rtt = 2.0 * (2.0 / 3.0) * math.sqrt(n_routers) \
        * (PAPER_GPU.noc_router_stages + 1) * congestion
    lat = L2_LAT + rtt + L2_MISS * DRAM_LAT
    ipc_mem = mshr / np.maximum(mpi * lat, 1e-9)
    iface = np.where(st >= FUSED, CHAN_BYTES, 2 * CHAN_BYTES)
    ipc_iface = iface / np.maximum(mpi * LINE_BYTES, 1e-9)
    ipc_cap = (NOC_CAPACITY / N_PAIRS) / np.maximum(mpi * LINE_BYTES, 1e-9)
    if rho < 0.9:                     # capacity not binding — ignore share
        ipc_cap = np.full_like(ipc_cap, np.inf)
    return np.minimum.reduce([ipc_c, ipc_mem, ipc_iface, ipc_cap])


# ---------------------------------------------------------------------------
# Profiling (paper §4.1.1: one CTA / short sample predicts the kernel)
# ---------------------------------------------------------------------------

def profile_features(w: Workload) -> np.ndarray:
    """Sample the §4.1.2 metrics from a short scale-out profiling window."""
    st = np.full(N_PAIRS, SPLIT_BASE)
    jitter = (np.arange(N_PAIRS) * 7) % w.div_period
    # single-CTA sampling (§4.1.1): the short window sees pair-0's phase only
    d0 = float(_divergence(w, np.arange(4), jitter[:1]).mean())
    d = np.full(N_PAIRS, d0)
    ipc, stats = _epoch_throughput(w, st, d, DIRECT_Q, False)
    mpi, c_eff, mu = _memory_terms(w, st)
    traffic = float((ipc * mpi * LINE_BYTES).sum())
    rho = min(traffic / NOC_CAPACITY, 0.995)
    n_routers = PAPER_GPU.num_sms + PAPER_GPU.num_memory_controllers
    rtt = 2.0 * (2.0 / 3.0) * math.sqrt(n_routers) \
        * (PAPER_GPU.noc_router_stages + 1) / (1.0 - min(rho, 0.90))
    lat = L2_LAT + rtt + L2_MISS * DRAM_LAT
    inflight = float(np.mean(ipc * mpi * lat))
    mshr_rate = inflight / (2 * PAPER_GPU.mshr_per_core)
    inactive = float(np.mean(d)) * P_NARROW
    return np.array([
        rho,                          # noc_throughput (utilization)
        rtt,                          # noc_latency
        float(np.mean(c_eff)),        # coalesce rate (actual access rate)
        float(np.mean(mu)),           # l1d miss
        w.l1i_miss,                   # l1i miss
        0.05,                         # l1c (constant cache) miss — tiny
        mshr_rate,                    # MSHR occupancy
        inactive,                     # inactive thread rate
        0.6 * w.mem_frac,             # load instruction rate
        0.4 * w.mem_frac,             # store instruction rate
        float(w.ctas),                # concurrent CTAs
    ])


# ---------------------------------------------------------------------------
# Heterogeneous static chips (Fig 12): rank chip-level compositions
# ---------------------------------------------------------------------------

MIX_FRACTIONS = (0.0, 0.25, 0.5, 0.75, 1.0)


def _mix_state(n_fused: int) -> np.ndarray:
    """A static heterogeneous chip: the first ``n_fused`` pairs fused,
    the rest split — the paper fuses *neighboring* SMs, so a chip
    composition is exactly which contiguous pairs run wide."""
    st = np.full(N_PAIRS, SPLIT_BASE)
    st[:n_fused] = FUSED
    return st


def _static_ipc(w: Workload, st: np.ndarray, epochs: int) -> float:
    jitter = (np.arange(N_PAIRS) * 7) % w.div_period
    d_all = _divergence(w, np.arange(epochs), jitter)
    total = 0.0
    for t in range(epochs):
        ipc, _ = _epoch_throughput(w, st, d_all[t], DIRECT_Q, False)
        total += float(ipc.sum())
    return total / max(epochs, 1)


def rank_chip_mixes(w: Workload, fractions=MIX_FRACTIONS,
                    epochs: int = EPOCHS // 4) -> list:
    """Rank static chip compositions (n fused pairs + rest split) by IPC.

    This is the composition-lattice view of Fig 12's heterogeneous
    chips: between the all-split baseline and the all-fused scale-up
    chip sit mixes that win when only part of the workload coalesces —
    the chip-level analogue of a serving group's ``(5, 3)`` cut.
    Returns dicts sorted best-first: ``{"mix", "n_fused", "ipc"}``.
    """
    rows = []
    for f in fractions:
        n = int(round(f * N_PAIRS))
        rows.append({"mix": f"{n}F+{N_PAIRS - n}S", "n_fused": n,
                     "ipc": _static_ipc(w, _mix_state(n), epochs)})
    rows.sort(key=lambda r: (-r["ipc"], r["n_fused"]))
    return rows


# ---------------------------------------------------------------------------
# Schemes (Fig 12): baseline / scale_up / static_fuse / direct_split /
# warp_regroup, plus DWS (Fig 21) and the static_mix composition chooser
# ---------------------------------------------------------------------------

def run_benchmark(w: Workload, scheme: str, *,
                  fuse_decider: Optional[Callable[[np.ndarray], bool]] = None,
                  epochs: int = EPOCHS,
                  split_threshold: float = 0.28,
                  fuse_threshold: float = 0.18) -> SimResult:
    """Simulate one kernel under one scheme.

    ``fuse_decider`` maps profile features -> fuse? (the trained logistic
    predictor, wrapped in the shared ``repro_torch.control.PredictorPolicy``);
    None = the shared ``OraclePolicy`` (run both static configs, pick the
    better — used to *generate* predictor training labels).
    """
    jitter = (np.arange(N_PAIRS) * 7) % w.div_period
    dws = scheme == "dws"
    dynamic = scheme in ("direct_split", "warp_regroup")
    quarantine = {"direct_split": DIRECT_Q,
                  "warp_regroup": REGROUP_Q}.get(scheme, DIRECT_Q)

    init_st: Optional[np.ndarray] = None
    if scheme == "baseline" or dws:
        want_fused = False
    elif scheme == "scale_up":
        want_fused = True
    elif scheme == "static_mix":
        # the composition chooser: rank Fig 12's heterogeneous chips
        # (n fused pairs + rest split) and pin the best static mix
        want_fused = False
        best = rank_chip_mixes(w, epochs=max(epochs // 4, 8))[0]
        init_st = _mix_state(best["n_fused"])
    else:  # static_fuse / direct_split / warp_regroup: a shared
        # repro_torch.control policy makes the per-kernel static choice
        feats = profile_features(w)
        if fuse_decider is not None:
            policy = PredictorPolicy.from_decider(fuse_decider)
        else:
            # (2,) is the fused pair (one wide SM), (1, 1) the split pair
            policy = OraclePolicy(
                space=ConfigSpace(capacity=2, max_ways=2),
                score=lambda t, fv: run_benchmark(
                    w, "scale_up" if n_parts(t) == 1 else "baseline",
                    epochs=epochs // 2).ipc)
        want_fused = policy.choose_static(feats)

    st = init_st if init_st is not None \
        else np.full(N_PAIRS, FUSED if want_fused else SPLIT_BASE)
    trace = np.zeros((EPOCHS if epochs is None else epochs, N_PAIRS), np.int8)
    total_ipc = 0.0
    switches = 0
    rho_prev = 0.0
    agg: Dict[str, float] = {}
    t_axis = np.arange(epochs)
    d_all = _divergence(w, t_axis, jitter)

    for t in range(epochs):
        d = d_all[t]
        toggled = np.zeros(N_PAIRS, bool)
        if dynamic and want_fused:
            # Fig 10/11: per-pair independent split/fuse with hysteresis —
            # the same repro_torch.control primitive the serving engine runs.
            # §4.3: split only when "wide pipeline leads to a higher
            # performance degradation compared to the benefits from fusion" —
            # the switch controller estimates per-pair throughput in both
            # states (QSPLIT gives up the 64-wide coalescing gain but keeps
            # the merged L1/MSHR/NoC port) and picks the better one.
            est_f = _pair_estimate(w, np.full(N_PAIRS, FUSED), d,
                                   quarantine, dws, rho_prev)
            est_q = _pair_estimate(w, np.full(N_PAIRS, QSPLIT), d,
                                   quarantine, dws, rho_prev)
            split_now, fuse_now = hysteresis_toggle(
                st == QSPLIT, d, split_threshold, fuse_threshold,
                want_split=(st == FUSED) & (est_q > est_f),
                want_fuse=est_f > est_q * 1.02)
            toggled = split_now | fuse_now
            st = np.where(split_now, QSPLIT, st)
            st = np.where(fuse_now, FUSED, st)
            switches += int(toggled.sum())
        trace[t] = st
        ipc, stats = _epoch_throughput(w, st, d, quarantine, dws)
        rho_prev = stats.pop("rho")
        ipc = ipc * np.where(toggled, 1.0 - SWITCH_COST, 1.0)
        total_ipc += float(ipc.sum())
        for k, v in stats.items():
            agg[k] = agg.get(k, 0.0) + v

    n = float(epochs)
    return SimResult(
        ipc=total_ipc / n,
        trace=trace,
        control_stall=agg["control_stall"] / n,
        l1i_miss=agg["l1i_miss"] / n,
        l1d_miss=agg["l1d_miss"] / n,
        actual_mem_rate=agg["actual_mem_rate"] / n,
        noc_stall=agg["noc_stall"] / n,
        injection_rate=agg["injection_rate"] / n,
        switches=switches,
    )


SCHEMES = ("baseline", "scale_up", "static_fuse", "direct_split",
           "warp_regroup", "dws")
# static_mix (the chip-composition chooser) is opt-in: it multiplies the
# run cost by the ranked candidates, so it rides outside the tier-1 sweep
EXTENDED_SCHEMES = SCHEMES + ("static_mix",)


def run_all(scheme: str, fuse_decider=None,
            workloads: Optional[Dict[str, Workload]] = None
            ) -> Dict[str, SimResult]:
    wl = workloads or WORKLOADS
    return {name: run_benchmark(w, scheme, fuse_decider=fuse_decider)
            for name, w in wl.items()}
