"""Binary logistic regression scalability predictor (paper §4.1.3).

Counterpart of ``repro.core.predictor``.  Inference is one dot product and
a sigmoid in numpy float32 (the reference evaluates in float32 too, since
JAX canonicalizes to it).  Training is full-batch gradient descent on the
L2-regularized NLL in torch float32 on the host, with the gradient written
out in closed form.  Its sums run in another order than the reference's
XLA reduction, so coefficients agree to a tolerance, not bit for bit.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class LogisticModel(NamedTuple):
    w: np.ndarray           # (F,) float32
    b: np.ndarray           # () float32
    mu: np.ndarray          # (F,) feature standardization
    sigma: np.ndarray       # (F,)
    feature_names: Tuple[str, ...] = ()

    def standardize(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, np.float32) - self.mu) / self.sigma


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return np.exp(-np.logaddexp(np.float32(0.0), -z)).astype(np.float32)


def predict_proba(model: LogisticModel, x: np.ndarray) -> np.ndarray:
    """P(scale-up / fuse is better). x: (..., F)."""
    z = model.standardize(x) @ model.w + model.b
    return _sigmoid(np.asarray(z, np.float32))


def predict_fuse(model: LogisticModel, x: np.ndarray) -> np.ndarray:
    return predict_proba(model, x) > 0.5


def feature_impacts(model: LogisticModel, x: np.ndarray) -> np.ndarray:
    """Paper Fig. 20: per-feature impact magnitude = coefficient x value."""
    return model.standardize(x) * model.w


def train_logistic(X: np.ndarray, y: np.ndarray, *,
                   feature_names: Sequence[str] = (),
                   l2: float = 1e-3, lr: float = 0.3, steps: int = 3000,
                   seed: int = 0,
                   sample_weight: Optional[np.ndarray] = None
                   ) -> Tuple[LogisticModel, dict]:
    """Full-batch gradient descent on the regularized NLL (float32, host).

    Same contract as the reference: ``sample_weight`` is normalized to
    mean 1, and ``info["loss_history"]`` holds the loss before each step.
    """
    X = torch.as_tensor(np.asarray(X), dtype=torch.float32)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32)
    if sample_weight is None:
        sw = torch.ones_like(y)
    else:
        sw = torch.as_tensor(np.asarray(sample_weight), dtype=torch.float32)
        sw = sw / torch.clamp(sw.mean(), min=1e-9)
    mu = X.mean(0)
    sigma = torch.clamp(X.std(0, unbiased=False), min=1e-6)
    Xs = (X - mu) / sigma
    n, F = X.shape

    def nll(w, b):
        z = Xs @ w + b
        loss = torch.mean(sw * (torch.logaddexp(torch.zeros_like(z), z)
                                - y * z))
        return loss + l2 * torch.sum(w ** 2)

    w = torch.zeros(F, dtype=torch.float32)
    b = torch.zeros((), dtype=torch.float32)
    losses = []
    for _ in range(steps):
        z = Xs @ w + b
        losses.append(nll(w, b))
        dz = sw * (torch.sigmoid(z) - y) / n
        w = w - lr * (Xs.T @ dz + 2.0 * l2 * w)
        b = b - lr * dz.sum()
    model = LogisticModel(w=w.numpy(), b=b.numpy(), mu=mu.numpy(),
                          sigma=sigma.numpy(),
                          feature_names=tuple(feature_names))
    z = Xs @ w + b
    acc = float(torch.mean(((z > 0) == (y > 0.5)).float()))
    loss_history = torch.stack(losses).double().tolist() if losses else []
    info = {"train_accuracy": acc, "final_nll": float(nll(w, b)),
            "n": int(n), "loss_history": loss_history}
    return model, info


# ---------------------------------------------------------------------------
# (De)serialization — same JSON layout as the reference
# ---------------------------------------------------------------------------

def save_model(model: LogisticModel, path: str) -> None:
    blob = {
        "w": np.asarray(model.w).tolist(),
        "b": float(model.b),
        "mu": np.asarray(model.mu).tolist(),
        "sigma": np.asarray(model.sigma).tolist(),
        "feature_names": list(model.feature_names),
    }
    with open(path, "w") as f:
        json.dump(blob, f, indent=1)


def load_model(path: str) -> LogisticModel:
    with open(path) as f:
        blob = json.load(f)
    return LogisticModel(
        w=np.asarray(blob["w"], np.float32),
        b=np.asarray(blob["b"], np.float32),
        mu=np.asarray(blob["mu"], np.float32),
        sigma=np.asarray(blob["sigma"], np.float32),
        feature_names=tuple(blob["feature_names"]),
    )
