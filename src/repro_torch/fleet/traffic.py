"""Trace-driven workloads for the fleet scheduler.

The hand-rolled batches in ``benchmarks/mesh_amoeba.py`` exercise exactly
one arrival pattern (everything submitted at tick 0).  Real serving load
is a *process*: requests arrive over time, in bursts, from tenants with
very different output-length profiles.  This module generates such traces
as plain ``Request`` lists with ``arrival`` ticks set, so any engine that
understands arrivals (the ``FleetEngine``) can replay them.

Arrivals are per-tick Poisson draws; burstiness is an on/off modulation of
the Poisson intensity (rate ``base`` off-burst, ``base * burst_factor``
during the duty window of each period) — the standard Markov-modulated
Poisson shape of interactive traffic.  Output lengths come from

* ``bimodal``   — short chat turns + a long-generation tail (``p_long``),
* ``lognormal`` — heavy right tail around ``mean_tokens``,
* ``uniform``   — the near-lockstep control case.

Prompt lengths are drawn from a small fixed set so the prefill compile
cache stays bounded.

Counterpart of ``repro/fleet/traffic.py``: the same numpy calls in the
same order, so every trace function returns identical requests.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from repro_torch.serve.engine import Request


@dataclass(frozen=True)
class TenantProfile:
    """One tenant's arrival process + output-length distribution."""
    name: str
    rate: float                        # mean arrivals per tick (off-burst)
    length_dist: str = "bimodal"       # bimodal | lognormal | uniform
    short_tokens: int = 4
    long_tokens: int = 48
    p_long: float = 0.2
    mean_tokens: float = 12.0          # lognormal median / uniform center
    sigma: float = 0.8                 # lognormal shape
    min_tokens: int = 1
    max_tokens: int = 256
    prompt_lengths: Sequence[int] = (8, 16)
    burst_factor: float = 1.0          # >1 turns on on/off modulation
    burst_period: int = 64             # ticks per on/off cycle
    burst_duty: float = 0.25           # fraction of the period at burst rate
    burst_phase: int = 0               # tick offset of the duty window
    # router shard for sticky (affinity) routing; None = unsharded
    shard: "int | None" = None

    def intensity(self, tick: int) -> float:
        if self.burst_factor <= 1.0:
            return self.rate
        on = ((tick - self.burst_phase) % self.burst_period
              < self.burst_duty * self.burst_period)
        return self.rate * (self.burst_factor if on else 1.0)

    def sample_length(self, rng: np.random.Generator) -> int:
        if self.length_dist == "bimodal":
            n = self.long_tokens if rng.random() < self.p_long \
                else self.short_tokens
        elif self.length_dist == "lognormal":
            n = int(round(float(
                rng.lognormal(np.log(self.mean_tokens), self.sigma))))
        elif self.length_dist == "uniform":
            lo = max(self.min_tokens, int(self.mean_tokens * 0.5))
            n = int(rng.integers(lo, int(self.mean_tokens * 1.5) + 1))
        else:
            raise ValueError(f"unknown length_dist {self.length_dist!r}")
        return int(np.clip(n, self.min_tokens, self.max_tokens))


def make_trace(profiles: Sequence[TenantProfile], horizon: int,
               vocab_size: int, seed: int = 0,
               max_requests: int = 10_000) -> List[Request]:
    """Superpose the tenants' arrival processes over ``horizon`` ticks."""
    rng = np.random.default_rng(seed)
    out: List[Request] = []
    for tick in range(horizon):
        for prof in profiles:
            for _ in range(int(rng.poisson(prof.intensity(tick)))):
                plen = int(rng.choice(list(prof.prompt_lengths)))
                prompt = list(map(int, rng.integers(0, vocab_size, plen)))
                out.append(Request(
                    rid=0, prompt=prompt,
                    max_new_tokens=prof.sample_length(rng),
                    tenant=prof.name, arrival=tick, shard=prof.shard))
    out.sort(key=lambda r: r.arrival)
    for i, r in enumerate(out):
        r.rid = i
    if len(out) > max_requests:
        warnings.warn(
            f"trace truncated from {len(out)} to {max_requests} requests "
            f"(raise max_requests to replay the full load)", stacklevel=2)
        out = out[:max_requests]
    return out


# -- canned scenarios ----------------------------------------------------------

def poisson_trace(rate: float, horizon: int, vocab_size: int,
                  seed: int = 0, **length_kw) -> List[Request]:
    """Single-tenant steady Poisson arrivals."""
    prof = TenantProfile(name="steady", rate=rate, **length_kw)
    return make_trace([prof], horizon, vocab_size, seed)


def bursty_longtail_trace(horizon: int, vocab_size: int, seed: int = 0,
                          chat_rate: float = 0.5,
                          batch_rate: float = 0.08) -> List[Request]:
    """The paper's adversarial serving regime as a multi-tenant mix.

    An interactive chat tenant arrives in bursts with mostly-short turns
    but a long tail, while a background batch tenant trickles in
    long-generation jobs — so fused groups keep inheriting divergent
    batches and queues build during bursts.
    """
    chat = TenantProfile(
        name="chat", rate=chat_rate, length_dist="bimodal",
        short_tokens=3, long_tokens=40, p_long=0.2,
        burst_factor=4.0, burst_period=80, burst_duty=0.2)
    batch = TenantProfile(
        name="batch", rate=batch_rate, length_dist="lognormal",
        mean_tokens=32.0, sigma=0.6, max_tokens=96,
        prompt_lengths=(16,))
    return make_trace([chat, batch], horizon, vocab_size, seed)


def skewed_longtail_trace(horizon: int, vocab_size: int, seed: int = 0,
                          rate: float = 0.7,
                          p_long: float = 0.3) -> List[Request]:
    """A steadily skewed mix: most requests are near-lockstep short turns,
    a fat minority are an order of magnitude longer.

    This is the regime where a heterogeneous composition pays: with ~30%
    long mass a capacity-8 group wants the ``(5, 3)`` cut — five slots
    lockstep-draining the short head while three quarantine the tail —
    which no equal-ways ladder (``2x4``/``4x2``) can express.  Used by
    the composition sweep in ``benchmarks/fleet_bench.py``.
    """
    skew = TenantProfile(
        name="chat", rate=rate, length_dist="bimodal",
        short_tokens=3, long_tokens=48, p_long=p_long,
        burst_factor=2.0, burst_period=60, burst_duty=0.3)
    drizzle = TenantProfile(
        name="batch", rate=0.05, length_dist="lognormal",
        mean_tokens=40.0, sigma=0.5, max_tokens=120,
        prompt_lengths=(16,))
    return make_trace([skew, drizzle], horizon, vocab_size, seed)


def imbalanced_trace(horizon: int, vocab_size: int, seed: int = 0,
                     shards: int = 4, hot_shard: int = 0,
                     hot_rate: float = 0.9, cold_rate: float = 0.05,
                     p_long: float = 0.3) -> List[Request]:
    """Shard-skewed load: one router shard takes nearly all the traffic.

    Every tenant is pinned to a shard (``Request.shard``, honored by the
    ``sticky`` router), but the arrival mass hammers ``hot_shard``: a
    bursty tenant with a fat long tail, while the other shards trickle
    short turns.  Under sticky routing the hot shard's group overflows
    while its neighbors starve — the imbalance regime
    ``repro_torch.fleet.migrate``'s work stealing exists to fix, used by the
    work-stealing sweep in ``benchmarks/fleet_bench.py``.
    """
    profs = []
    for s in range(shards):
        hot = s == hot_shard
        profs.append(TenantProfile(
            name=f"shard{s}",
            rate=hot_rate if hot else cold_rate,
            length_dist="bimodal",
            short_tokens=3,
            long_tokens=48 if hot else 12,
            p_long=p_long if hot else 0.1,
            burst_factor=3.0 if hot else 1.0,
            burst_period=50, burst_duty=0.3,
            shard=s))
    return make_trace(profs, horizon, vocab_size, seed)


def transient_burst_trace(horizon: int, vocab_size: int, seed: int = 0,
                          shards: int = 4, burst_len: int = 40,
                          base_rate: float = 0.08,
                          burst_factor: float = 10.0,
                          p_long: float = 0.15) -> List[Request]:
    """A rotating hot shard: each burst too short for a re-cut to pay.

    Every shard trickles short turns at ``base_rate``; the shards take
    turns being hot, each for one ``burst_len`` window of a
    ``shards * burst_len`` cycle (phased duty windows, never two hot at
    once).  By the time a topology move or a steal pipeline spins up for
    one shard's burst, the burst has moved on — while the other shards'
    groups sit with idle slots the whole time.  This is the regime slack
    leases (``repro_torch.fleet.lease``) exist for: the hot group borrows its
    neighbors' idle slots for the burst and hands them back when the
    rotation moves.  Used by the ``slack_lease`` sweep in
    ``benchmarks/fleet_bench.py``.
    """
    period = shards * burst_len
    profs = [TenantProfile(
        name=f"shard{s}", rate=base_rate,
        length_dist="bimodal", short_tokens=3, long_tokens=24,
        p_long=p_long, burst_factor=burst_factor,
        burst_period=period, burst_duty=1.0 / shards,
        burst_phase=s * burst_len, shard=s)
        for s in range(shards)]
    return make_trace(profs, horizon, vocab_size, seed)


def multichip_imbalanced_trace(horizon: int, vocab_size: int, seed: int = 0,
                               chips: int = 2, groups_per_chip: int = 2,
                               hot_chip: int = 0,
                               hot_rate: float = 0.9,
                               warm_rate: float = 0.25,
                               cold_rate: float = 0.04,
                               p_long: float = 0.35) -> List[Request]:
    """Chip-skewed load for the hierarchical (cluster) scheduler.

    One shard per group (``shards = chips * groups_per_chip``); the
    arrival mass hammers ``hot_chip``: its first group takes a bursty
    fat-long-tail stream, its chipmates a warm medium stream, while
    every group on the other chips barely trickles.  Under sticky
    routing the hot chip overflows as a unit — its chipmates can absorb
    some excess over the fast intra-chip NoC, but the residual must
    cross slow inter-chip links, which is exactly the regime where
    distance-blind stealing thrashes and the cluster layer's tiered
    controller pays.  Used by the ``cluster_hierarchy`` sweep in
    ``benchmarks/fleet_bench.py``.
    """
    profs = []
    for s in range(chips * groups_per_chip):
        chip, local = divmod(s, groups_per_chip)
        if chip == hot_chip and local == 0:
            rate, long_tok, pl_, burst = hot_rate, 48, p_long, 3.0
        elif chip == hot_chip:
            rate, long_tok, pl_, burst = warm_rate, 32, p_long / 2, 1.5
        else:
            rate, long_tok, pl_, burst = cold_rate, 12, 0.1, 1.0
        profs.append(TenantProfile(
            name=f"chip{chip}g{local}", rate=rate,
            length_dist="bimodal", short_tokens=3, long_tokens=long_tok,
            p_long=pl_, burst_factor=burst,
            burst_period=50, burst_duty=0.3, shard=s))
    return make_trace(profs, horizon, vocab_size, seed)


def uniform_trace(rate: float, horizon: int, vocab_size: int,
                  seed: int = 0, tokens: int = 12) -> List[Request]:
    """Near-lockstep lengths — the regime where fused should win."""
    prof = TenantProfile(name="uniform", rate=rate, length_dist="uniform",
                         mean_tokens=float(tokens))
    return make_trace([prof], horizon, vocab_size, seed)
