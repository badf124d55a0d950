"""AMOEBA core, at the mesh level.

* ``predictor``   — binary logistic regression scalability model (§4.1.3).
* ``metrics``     — mesh-level scalability metrics / roofline terms.
* ``fusion``      — mesh plans: fuse/split chip-group factorizations.
* ``controller``  — online reconfiguration controller (Fig 7, 10, 11).
* ``regroup``     — direct-split / warp-regroup batch policies (§4.3).
"""
from repro_torch.core.controller import AmoebaController, PhaseDecision
from repro_torch.core.fusion import MeshPlan, plan_family
from repro_torch.core.metrics import StepProfile, collective_bytes
from repro_torch.core.predictor import (LogisticModel, predict_fuse,
                                        predict_proba, train_logistic)

__all__ = [
    "AmoebaController", "PhaseDecision", "MeshPlan", "plan_family",
    "StepProfile", "collective_bytes", "LogisticModel", "predict_fuse",
    "predict_proba", "train_logistic",
]
