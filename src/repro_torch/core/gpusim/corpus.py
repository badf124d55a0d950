"""Offline training corpus for the scalability predictor (paper §4.1.3).

"We train this binary logistic model using a large amount of offline
experimental data": for every benchmark profile and randomized variants of
it, run the simulator under both static configurations, label with the
winner, and pair the label with the §4.1.2 metrics sampled from a short
scale-out profiling window.

Counterpart of ``repro/core/gpusim/corpus.py``.  The corpus is the
simulator's, so it equals the reference's exactly; the model is fitted by
the port's torch float32 gradient descent (``repro_torch.core.predictor``),
whose sums run in another order than XLA's, so coefficients agree to a
tolerance and the decisions on the corpus agree.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import predictor as P
from repro_torch.core.gpusim.sim import (FEATURE_NAMES, profile_features,
                                   run_benchmark)
from repro_torch.core.gpusim.workloads import WORKLOADS, workload_variants


def build_corpus(variants_per_workload: int = 24, seed: int = 0,
                 epochs: int = 48) -> Tuple[np.ndarray, np.ndarray, list]:
    """Returns (X (N, F), y (N,), names)."""
    X, y, names = [], [], []
    for base_name, base in WORKLOADS.items():
        pool = (base,) + workload_variants(base, variants_per_workload, seed)
        seed += 1
        for w in pool:
            feats = profile_features(w)
            a = run_benchmark(w, "baseline", epochs=epochs)
            b = run_benchmark(w, "scale_up", epochs=epochs)
            X.append(feats)
            y.append(1.0 if b.ipc > a.ipc else 0.0)
            names.append(w.name)
    return np.stack(X), np.asarray(y), names


def train_sim_predictor(variants_per_workload: int = 24, seed: int = 0,
                        epochs: int = 48):
    """Builds the corpus, trains, and cross-checks on the 12 base profiles.

    Returns (model, info) where info adds base-profile accuracy.
    """
    X, y, names = build_corpus(variants_per_workload, seed, epochs)
    model, info = P.train_logistic(X, y, feature_names=FEATURE_NAMES)
    correct = 0
    for name, w in WORKLOADS.items():
        feats = profile_features(w)
        pred = bool(P.predict_fuse(model, feats))
        a = run_benchmark(w, "baseline", epochs=epochs)
        b = run_benchmark(w, "scale_up", epochs=epochs)
        truth = b.ipc > a.ipc
        correct += pred == truth
    info["base_profile_accuracy"] = correct / len(WORKLOADS)
    return model, info
