"""Map the reference's parameter tree onto torch tensors, key for key.

The tests build one parameter tree with ``repro.models.transformer``,
convert its leaves to numpy (``jax.tree.map(np.asarray, params)``), and
hand the result to :func:`params_from_numpy`, so both packages compute
with bit-identical weights.  The tree's structure (dicts, and the tuple
under ``"reps"``) is kept as it is.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device


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

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(conv(v) for v in node)
        return _tensor(np.asarray(node), dev)

    return conv(tree)
