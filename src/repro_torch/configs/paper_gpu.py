"""Paper Table 1 — GPGPU-Sim v3.2.2 baseline configuration for the
faithful-reproduction simulator (repro_torch.core.gpusim).

Counterpart of ``repro/configs/paper_gpu.py``, field for field.

The baseline GPU is a *scale-out* machine: 48 SMs, warp size 32, SIMD
pipeline width 8.  AMOEBA fuses two neighboring SMs into one scale-up SM
(64-wide warp issue, shared L1/coalescer, one NoC router bypassed).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class GPUConfig:
    num_sms: int = 48                 # "Number of Computing Cores" (scale-out SMs)
    num_memory_controllers: int = 8
    mshr_per_core: int = 64
    warp_size: int = 32
    simd_width: int = 8
    threads_per_core: int = 1024
    ctas_per_core: int = 8
    l1_cache_bytes: int = 16 * 1024
    l2_cache_bytes: int = 128 * 1024   # per-core share
    shared_mem_bytes: int = 48 * 1024
    registers_per_core: int = 16384
    constant_cache_bytes: int = 8 * 1024
    texture_cache_bytes: int = 8 * 1024
    warp_scheduler: str = "gto"        # greedy-then-oldest
    memory_scheduler: str = "fr_fcfs"
    mem_clock_mhz: float = 924.0
    core_clock_mhz: float = 700.0
    noc_channel_bits: int = 128
    noc_topology: str = "mesh"
    noc_router_stages: int = 2
    # derived mesh side for SMs+MCs placed on a 2D mesh NoC
    dram_latency_cycles: int = 220
    l2_latency_cycles: int = 32
    l1_latency_cycles: int = 1
    # AMOEBA additions (paper §4.2): +1 cycle on fused L1 access
    fused_l1_extra_cycles: int = 1


PAPER_GPU = GPUConfig()
