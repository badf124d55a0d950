"""repro_torch.control — the unified reconfiguration control plane.

One policy stack drives every layer that reconfigures: the gpusim pair
fabric, the serving groups, the fleet, and the trainer.  The paper's
monitor -> predict -> reconfigure loop (§4.1, Fig 7) lives here once:

* ``features``   — FeatureVector from live telemetry + the replay buffer
                   (recency-weighted refits, drift reset).
* ``space``      — ConfigSpace: composition topologies (``(8,)`` fused,
                   ``(4, 4)`` the pair, ``(5, 3)`` a skewed cut) with
                   per-part amortization-checked moves.
* ``policies``   — ReconfigPolicy protocol: Threshold / Predictor /
                   Oracle / Online implementations + the shared
                   hysteresis primitive.
* ``controller`` — GroupController (per-part dwell + transition
                   enforcement) and FleetController (chip-wide split-mix
                   rebalancing, including deepening under tail mass).
* ``offline``    — serve-level predictor training corpus + the Fig 20
                   feature ablation.
"""
from repro_torch.control.controller import (ControlState, FleetController,
                                      GroupController)
from repro_torch.control.features import (SERVE_FEATURES, ArrivalRateTracker,
                                    FeatureVector, ReplayBuffer)
from repro_torch.control.offline import (build_serve_corpus,
                                        serve_feature_ablation,
                                        train_serve_predictor)
from repro_torch.control.policies import (POLICY_NAMES, Decision, OnlinePolicy,
                                    OraclePolicy, PredictorPolicy,
                                    ReconfigPolicy, ThresholdPolicy,
                                    hysteresis_toggle, make_policy)
from repro_torch.control.space import (ConfigSpace, Topology, balanced, n_parts,
                                 topology_name)

__all__ = [
    "ControlState", "FleetController", "GroupController",
    "SERVE_FEATURES", "ArrivalRateTracker", "FeatureVector", "ReplayBuffer",
    "build_serve_corpus", "serve_feature_ablation", "train_serve_predictor",
    "POLICY_NAMES", "Decision", "OnlinePolicy", "OraclePolicy",
    "PredictorPolicy", "ReconfigPolicy", "ThresholdPolicy",
    "hysteresis_toggle", "make_policy",
    "ConfigSpace", "Topology", "balanced", "n_parts", "topology_name",
]
