"""Mesh-level scalability metrics: the roofline terms of §4.1.2.

Counterpart of ``repro/core/metrics.py``: a phase's profile (FLOPs, device
memory bytes, collective bytes, peak memory, MoE or length divergence) and
its three bounds (compute, memory, interconnect) against a card's peaks,
with the port's ``H100`` as the default hardware where the reference
defaults to the TPU v5e.  ``collective_bytes`` parses HLO text, as the
reference's does.  The counterpart of ``profile_from_compiled``, which
reads XLA's compiled artifacts, is ``core.step_count.profile_from_step``:
the port compiles no HLO, so it counts one eager step op by op.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.configs.base import H100, HardwareConfig

# HLO ops whose operand bytes cross the ICI
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_SHAPE_RE = re.compile(r"(bf16|f32|f16|f64|s32|s8|u32|u8|pred|s64|u64)"
                       r"\[([\d,]*)\]")
_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "s32": 4, "u32": 4,
          "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8}


def _shape_bytes(text: str) -> int:
    """Total bytes of every typed shape literal in an HLO snippet."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum output-shape bytes of every cross-device collective in the HLO.

    Parses the post-SPMD module: each collective line looks like
    ``%x = bf16[512,1024] all-reduce(...)``; the result shape is the payload
    that crosses the network (per participating device).
    """
    out = {op: 0 for op in COLLECTIVE_OPS}
    for line in hlo_text.splitlines():
        s = line.strip()
        for op in COLLECTIVE_OPS:
            # match op name in the instruction position, not inside metadata
            if f"= {op}" in s or re.match(rf"\S+ = \S+ {op}\(", s) \
               or re.search(rf"\)\s*{op}\(", s):
                lhs = s.split("=", 1)
                shape_part = lhs[1].split(op)[0] if len(lhs) > 1 else s
                out[op] += _shape_bytes(shape_part)
                break
    return out


@dataclass
class StepProfile:
    """Everything the controller needs to know about one compiled phase."""
    name: str
    flops: float                      # HLO FLOPs (per device)
    hbm_bytes: float                  # HLO bytes accessed (per device)
    coll_bytes: float                 # collective payload bytes (per device)
    coll_breakdown: Dict[str, int] = field(default_factory=dict)
    peak_memory: float = 0.0          # bytes per device
    chips: int = 1
    model_flops: float = 0.0          # 6*N*D useful flops (whole step)
    per_chip_batch: float = 0.0       # tokens resident per chip
    divergence: float = 0.0           # MoE imbalance / length spread [0,1]
    raw: Dict = field(default_factory=dict)   # cost_analysis + loop details

    def roofline(self, hw: HardwareConfig = H100) -> Dict[str, float]:
        """Three terms in seconds (per-device figures vs per-chip peaks)."""
        compute = self.flops / hw.peak_flops
        memory = self.hbm_bytes / hw.hbm_bandwidth
        coll = self.coll_bytes / hw.ici_bandwidth
        dom = max(("compute", compute), ("memory", memory),
                  ("collective", coll), key=lambda kv: kv[1])
        step = max(compute, memory, coll)
        useful = (self.model_flops / self.chips) / hw.peak_flops \
            if self.model_flops else 0.0
        return {
            "compute_s": compute,
            "memory_s": memory,
            "collective_s": coll,
            "bottleneck": dom[0],
            "step_s": step,
            "roofline_frac": useful / step if step > 0 else 0.0,
            "useful_flop_frac": (self.model_flops / self.chips) / self.flops
            if self.flops else 0.0,
        }

    def features(self) -> np.ndarray:
        """Feature vector for the mesh-level logistic predictor."""
        f = max(self.flops, 1.0)
        return np.array([
            self.coll_bytes / f,              # "NoC throughput" analogue
            self.hbm_bytes / f,               # arithmetic-intensity inverse
            np.log10(max(self.per_chip_batch, 1.0)),
            np.log10(max(self.peak_memory, 1.0)),
            self.divergence,
            np.log10(f),
        ], dtype=np.float64)


MESH_FEATURE_NAMES = (
    "coll_bytes_per_flop", "hbm_bytes_per_flop", "log_per_chip_batch",
    "log_peak_memory", "divergence", "log_flops",
)
