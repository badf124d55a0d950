"""PyTorch/CUDA port of the AMOEBA serving stack for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module layout where that helps a reader find a counterpart, and imports
nothing of it (nor of JAX).  Entry points run on CUDA unless the caller
passes ``device="cpu"``; without a GPU and without that request they
raise (see :func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises rather than falling back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


__all__ = ["resolve_device"]
