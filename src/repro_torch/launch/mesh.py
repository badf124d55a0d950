"""Production meshes, and joining the process group.

Counterpart of ``repro/launch/mesh.py``.  Each mesh is a ``DeviceMesh``
made by a FUNCTION (not a module constant), so importing this module
touches no process group.

Axis semantics:
  pod    — pipeline/replica axis across pods (multi-pod only)
  data   — batch/FSDP axis (DP replicas = AMOEBA "number of SMs")
  model  — tensor/expert-parallel axis (per-group width = "SM size")

AMOEBA plans refactor (data x model) at a fixed chip count:
fused = model x2 / data /2 (scale-up), scale_out = the inverse.

:func:`init_distributed` joins the process group from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)::

    torchrun --nproc-per-node 4 my_script.py    # my_script calls
                                                # init_distributed()
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.fusion import MeshPlan, plan_family


def init_distributed(backend: Optional[str] = None) -> str:
    """Join the default process group from torchrun's environment; returns
    the backend.  Default: NCCL when each rank has a card of its own (the
    rank's ``LOCAL_RANK`` card becomes its device), gloo otherwise (on the
    CPU, or several ranks sharing one card).  Nothing here falls back: a
    backend that cannot start raises."""
    if dist.is_initialized():
        return dist.get_backend()
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        if k not in os.environ:
            raise KeyError(f"init_distributed: {k} is not set")
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= world else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, rank=rank, world_size=world,
                            init_method="env://")
    return backend


def make_production_mesh(*, multi_pod: bool = False):
    plan = multi_pod_plan() if multi_pod else single_pod_plan()
    return plan.build()


def make_plan_mesh(plan: MeshPlan):
    """Mesh for a named AMOEBA plan over the same chips."""
    return plan.build()


def single_pod_plan(name: str = "base") -> MeshPlan:
    base = MeshPlan("base", data=16, model=16)
    if name == "base":
        return base
    return plan_family(base)[name]


def multi_pod_plan() -> MeshPlan:
    return MeshPlan("multi", data=16, model=16, pod=2)
