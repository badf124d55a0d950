"""Map the reference's parameter tree onto torch tensors, key for key.

The tests build one parameter tree with ``repro.models.transformer``,
convert its leaves to numpy (``jax.tree.map(np.asarray, params)``), and
hand the result to :func:`params_from_numpy`, so both packages compute
with bit-identical weights.  The tree's structure (dicts, the tuple under
``"reps"``, NamedTuples) is kept as it is.  :func:`train_state_from_numpy`
maps a whole reference ``TrainState`` (parameters, AdamW moments and step,
data cursor, compression residuals) onto the port's, so both trainers
start from the same state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import pytree, resolve_device


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")   # the tensor owns its memory
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: same bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Dicts, tuples and lists are kept; every array leaf becomes a tensor."""
    dev = resolve_device(device)
    return pytree.map_(lambda a: _tensor(np.asarray(a), dev), tree)


def train_state_from_numpy(ref_state: Any, device="cuda"):
    """The reference's ``TrainState`` with numpy leaves
    (``jax.tree.map(np.asarray, state)``) -> the port's ``TrainState``."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.trainer import TrainState
    t = lambda tree: params_from_numpy(tree, device)  # noqa: E731
    opt = ref_state.opt
    return TrainState(params=t(ref_state.params),
                      opt=AdamWState(step=t(opt.step), m=t(opt.m),
                                     v=t(opt.v)),
                      data_step=t(ref_state.data_step),
                      residuals=t(ref_state.residuals))
