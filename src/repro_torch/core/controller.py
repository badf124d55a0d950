"""Online reconfiguration controller (paper §4.1, Fig 7 + Fig 10/11).

Counterpart of ``repro/core/controller.py``, with the port's ``H100`` as
the default hardware.  Two nested loops, the paper's structure lifted to
the mesh level:

1. **Per-phase plan selection** — when a new phase starts (a training
   job, a prefill wave, a decode wave), compare its profiles' rooflines
   or ask the trained logistic predictor, and pick the mesh plan (fused /
   base / scale_out), once per phase and only if the win repays the
   reshard.

2. **Dynamic split/fuse inside a phase** — track the divergence signal
   (decode length spread, MoE expert imbalance); split when it crosses
   ``split_threshold``, re-fuse under ``fuse_threshold``, with hysteresis
   and a ``min_phase_steps`` dwell.  This loop delegates to the shared
   :class:`repro_torch.control.GroupController` driving a
   :class:`repro_torch.control.ThresholdPolicy`, the objects the serving
   engine and the fleet consume.

The controller emits decisions (plan names, split layouts); the launcher,
trainer or serving engine carries them out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import H100, AmoebaConfig, HardwareConfig
from repro_torch.core import fusion, predictor, regroup
from repro_torch.core.metrics import StepProfile

if TYPE_CHECKING:
    # repro_torch.control's policies import repro_torch.core.predictor, so
    # the runtime import of the control plane is deferred into
    # __init__/observe to keep `import repro_torch.core` acyclic
    from repro_torch.control import GroupController


@dataclass
class PhaseDecision:
    plan: str                      # chosen mesh plan name
    proba: float                   # P(fuse better) from the predictor
    reason: str
    profiles: Dict[str, Dict] = field(default_factory=dict)


@dataclass
class SplitState:
    """Read-only binary view of the shared ControlState (legacy API)."""
    split: bool = False
    steps_in_state: int = 0
    history: List[Tuple[int, bool, float]] = field(default_factory=list)


class AmoebaController:
    """Decision engine shared by the trainer and the serving engine."""

    def __init__(self, cfg: AmoebaConfig = AmoebaConfig(),
                 model: Optional[predictor.LogisticModel] = None,
                 hw: HardwareConfig = H100,
                 group: Optional["GroupController"] = None):
        from repro_torch.control import (ConfigSpace, GroupController,
                                   ThresholdPolicy)
        self.cfg = cfg
        self.model = model
        self.hw = hw
        self.group = group or GroupController(
            policy=ThresholdPolicy(cfg.split_threshold, cfg.fuse_threshold,
                                   cfg.regroup_policy),
            space=ConfigSpace(capacity=2, max_ways=2,
                              min_gain=cfg.min_gain),
            dwell=cfg.min_phase_steps,
            regroup_policy=cfg.regroup_policy)
        self.decisions: List[PhaseDecision] = []

    @property
    def split_state(self) -> SplitState:
        st = self.group.state
        return SplitState(
            split=st.ways > 1, steps_in_state=st.steps_in_state,
            history=[(s, w > 1, d) for s, w, d in st.history])

    # -- loop 1: per-phase plan selection ---------------------------------

    def choose_plan(self, profiles: Dict[str, StepProfile],
                    param_bytes_per_chip: float = 0.0,
                    steps_remaining: float = np.inf) -> PhaseDecision:
        """Pick the best mesh plan from compiled per-plan profiles.

        ``profiles`` maps plan name -> StepProfile (from the dry-run of the
        phase's step under each candidate mesh).  When exact profiles exist
        we compare rooflines directly (the paper's 'oracle' static upper
        bound); the logistic model covers the online case where only the
        base profile was measured.
        """
        if not self.cfg.enabled:
            d = PhaseDecision(plan="base", proba=0.5, reason="amoeba off")
            self.decisions.append(d)
            return d
        rts = {name: p.roofline(self.hw) for name, p in profiles.items()}
        if len(rts) > 1:
            best = min(rts, key=lambda n: rts[n]["step_s"])
            base_s = rts.get("base", rts[best])["step_s"]
            gain = base_s - rts[best]["step_s"]
            if best != "base" and not fusion.amortized_switch_ok(
                    gain, param_bytes_per_chip, steps_remaining, self.hw):
                best, reason = "base", "win does not amortize reshard"
            else:
                reason = f"roofline: {best} step {rts[best]['step_s']:.4g}s"
            proba = 1.0 if best == "fused" else 0.0
        else:
            (name, profile), = profiles.items()
            feats = profile.features()
            if self.model is not None:
                proba = float(predictor.predict_proba(self.model, feats))
                best = "fused" if proba > 0.5 else "scale_out"
                reason = f"predictor P(fuse)={proba:.3f}"
            else:
                # heuristic fallback mirroring §4.1.2: interconnect- or
                # memory-pressure-bound phases fuse; divergent ones scale out
                r = profile.roofline(self.hw)
                fuse = r["bottleneck"] == "collective" or (
                    r["bottleneck"] == "memory"
                    and profile.divergence < self.cfg.split_threshold)
                proba = 0.75 if fuse else 0.25
                best = "fused" if fuse else "scale_out"
                reason = f"heuristic: bottleneck={r['bottleneck']}"
        d = PhaseDecision(plan=best, proba=proba, reason=reason,
                          profiles=rts)
        self.decisions.append(d)
        return d

    # -- loop 2: dynamic split/fuse on divergence --------------------------

    def observe(self, divergence: float,
                remaining: Optional[Sequence[float]] = None) -> bool:
        """Feed one step's divergence signal; returns current split state.

        Implements Fig 10/11 with hysteresis + dwell (via the shared
        ``repro_torch.control.GroupController``): split when divergence exceeds
        the threshold *and* the regroup policy predicts a win; re-fuse
        when it drops below ``fuse_threshold`` (the slow half drained).
        """
        from repro_torch.control import FeatureVector
        fv = FeatureVector(
            divergence=float(divergence),
            remaining=None if remaining is None
            else np.asarray(remaining, np.float64))
        return self.group.observe(fv) > 1

    def layout(self, indices: Sequence[int],
               remaining: Sequence[float]) -> Tuple[List[int], List[int]]:
        """Current batch layout: (fast, slow) under the active policy."""
        if self.group.state.ways <= 1:
            return list(indices), []
        return regroup.POLICIES[self.cfg.regroup_policy](indices, remaining)
