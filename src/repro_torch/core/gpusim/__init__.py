"""Faithful reproduction of the paper's evaluation system.

The paper evaluates AMOEBA in GPGPU-Sim (Table 1 config) on 12 benchmarks,
purely on throughput.  CUDA traces cannot run here, so the reproduction is a
cycle-approximate behavioral model of exactly the machine the paper
describes — scale-out SMs, pairwise fusion, shared L1/coalescer, mesh NoC
with router bypass, divergence-driven dynamic splitting — driven by
workload profiles parameterized to the characteristics the paper reports
per benchmark.  Every figure of §5 has a corresponding harness in
``benchmarks/``.

Counterpart of ``repro/core/gpusim``.  The simulator is numpy on the host,
as every control-plane module of the port is: 24 pairs an epoch, each epoch
solved to a fixed point, is no device work, and the same operations in the
same order give the reference's results bit for bit.  Only the corpus's
predictor fit (``corpus.train_sim_predictor``) runs in torch, through
``repro_torch.core.predictor``.
"""
from repro_torch.core.gpusim.sim import (
    EXTENDED_SCHEMES,
    SCHEMES,
    SimResult,
    profile_features,
    rank_chip_mixes,
    run_benchmark,
    run_all,
    FEATURE_NAMES,
)
from repro_torch.core.gpusim.workloads import (WORKLOADS, Workload,
                                              workload_variants)

__all__ = [
    "EXTENDED_SCHEMES", "SCHEMES", "SimResult", "profile_features",
    "rank_chip_mixes", "run_benchmark", "run_all",
    "FEATURE_NAMES", "WORKLOADS", "Workload", "workload_variants",
]
