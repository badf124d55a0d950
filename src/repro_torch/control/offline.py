"""Offline corpus for the serve-level scalability predictor.

The paper trains its logistic model on "a large amount of offline
experimental data" from the simulator (that path is
:mod:`repro_torch.core.gpusim.corpus`).  The serving analogue generates
decision scenarios — batches with bimodal / lognormal / near-lockstep remaining-length profiles under
varying queue pressure — and labels each with the realized win: does the
best k-way partition of this batch save more slot-steps than the
reconfiguration margin?  The features are exactly the live-telemetry
:class:`~repro_torch.control.features.FeatureVector`, so a model trained here
drops straight into :class:`~repro_torch.control.policies.PredictorPolicy`.

Counterpart of ``repro/control/offline.py``: the corpus is drawn with the
same numpy calls, so it is identical; the model is trained by the port's
torch full-batch gradient descent (:mod:`repro_torch.core.predictor`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.control.features import SERVE_FEATURES, FeatureVector
from repro_torch.control.space import ConfigSpace
from repro_torch.core import predictor as P


def _sample_remaining(rng: np.random.Generator, n: int) -> np.ndarray:
    kind = rng.choice(("bimodal", "lognormal", "uniform", "draining"))
    if kind == "bimodal":
        r = np.where(rng.random(n) < rng.uniform(0.1, 0.5),
                     rng.integers(24, 200, n), rng.integers(1, 8, n))
    elif kind == "lognormal":
        r = np.ceil(rng.lognormal(np.log(12), rng.uniform(0.3, 1.2), n))
    elif kind == "uniform":
        c = rng.integers(4, 64)
        r = rng.integers(max(c - 2, 1), c + 3, n)
    else:  # draining: a fused batch where some rows already finished
        r = rng.integers(1, 96, n).astype(np.float64)
        r[rng.random(n) < rng.uniform(0.2, 0.7)] = 0.0
    return np.asarray(r, np.float64)


def build_serve_corpus(n_samples: int = 2048, capacity: int = 8,
                       max_ways: int = 2, label_margin: float = 0.02,
                       regroup_policy: str = "warp_regroup",
                       seed: int = 0, hetero: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (X (N, F), y (N,)) with y=1 iff reconfiguring wins.

    The label is the realized win of the best topology in the group's
    composition lattice (``hetero=False`` restricts it to the balanced
    ladder — the pre-composition labels).
    """
    rng = np.random.default_rng(seed)
    space = ConfigSpace(capacity=capacity, max_ways=max_ways, hetero=hetero)
    X = np.zeros((n_samples, len(SERVE_FEATURES)))
    y = np.zeros(n_samples)
    for i in range(n_samples):
        b = int(rng.integers(2, capacity + 1))
        remaining = _sample_remaining(rng, b)
        fv = FeatureVector.from_group(
            remaining, queue_depth=int(rng.integers(0, 3 * capacity)),
            arrival_rate=float(rng.uniform(0.0, 2.0)), capacity=capacity)
        _, gain = space.best_topology(remaining, regroup_policy)
        X[i] = fv.to_array()
        y[i] = 1.0 if gain > label_margin else 0.0
    return X, y


def train_serve_predictor(n_samples: int = 2048, capacity: int = 8,
                          max_ways: int = 2, label_margin: float = 0.02,
                          regroup_policy: str = "warp_regroup",
                          seed: int = 0, steps: int = 1500,
                          hetero: bool = True):
    """Train the serve-level logistic model; returns (model, info)."""
    X, y = build_serve_corpus(n_samples, capacity, max_ways, label_margin,
                              regroup_policy, seed, hetero=hetero)
    return P.train_logistic(X, y, feature_names=SERVE_FEATURES, steps=steps)


def serve_feature_ablation(model: P.LogisticModel, X: np.ndarray,
                           y: np.ndarray, steps: int = 400
                           ) -> Dict[str, Dict[str, float]]:
    """Paper Fig 20 at the serve level: what actually carries the decision.

    For each feature reports the mean absolute per-sample impact
    (standardized value x coefficient — the paper's impact metric) and
    the drop-one refit accuracy: retrain without the feature and see how
    much the corpus accuracy falls.  A feature whose removal costs
    nothing is dead weight in the online refit loop.
    """
    names = model.feature_names or tuple(
        f"f{i}" for i in range(X.shape[1]))
    impacts = np.abs(np.asarray(P.feature_impacts(
        model, np.asarray(X, np.float64))))
    mean_abs = impacts.mean(axis=0)
    # the drop-one baseline is a full-feature model retrained on the SAME
    # (X, y, steps) budget, so accuracy_cost isolates the feature instead
    # of conflating it with the passed-in model's larger training run
    full, _ = P.train_logistic(X, y, feature_names=names, steps=steps)
    full_acc = float(np.mean(
        (np.asarray(P.predict_proba(full, X)) > 0.5) == (y > 0.5)))
    out: Dict[str, Dict[str, float]] = {}
    for i, name in enumerate(names):
        keep = [j for j in range(X.shape[1]) if j != i]
        sub, _ = P.train_logistic(
            X[:, keep], y,
            feature_names=tuple(names[j] for j in keep), steps=steps)
        sub_acc = float(np.mean(
            (np.asarray(P.predict_proba(sub, X[:, keep])) > 0.5)
            == (y > 0.5)))
        out[name] = {
            "mean_abs_impact": round(float(mean_abs[i]), 4),
            "drop_one_accuracy": round(sub_acc, 4),
            "accuracy_cost": round(full_acc - sub_acc, 4),
        }
    return out
