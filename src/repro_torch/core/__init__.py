"""AMOEBA core, as far as the serving path needs it.

* ``predictor``   — binary logistic regression scalability model (§4.1.3).
* ``regroup``     — direct-split / warp-regroup batch policies (§4.3).
"""
from repro_torch.core.predictor import (LogisticModel, predict_fuse,
                                        predict_proba, train_logistic)

__all__ = ["LogisticModel", "predict_fuse", "predict_proba",
           "train_logistic"]
