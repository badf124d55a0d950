"""Mesh plans: the device-mesh translation of AMOEBA's SM fuse/split fabric.

Counterpart of ``repro/core/fusion.py``.  A *plan* is a factorization of
the same chips into (replica-ish axes x model axis).  ``fuse`` merges two
neighboring data-parallel groups into one group with 2x the
tensor-parallel width (parameters stored once per fused group, half the
participants in the gradient all-reduce, twice the batch per group);
``split`` is the inverse.  The pod axis is never refactored: fusion
happens inside a pod, as the paper fuses neighboring SMs only.

Switching plans reshards every weight, so ``reshard_cost_s`` bounds the
bytes moved and the controller amortizes it against the predicted per-step
win before switching.  The link rate defaults to the port's ``H100``
(NVLink, 450 GB/s each way).  ``MeshPlan.build`` makes the plan's
``torch.distributed`` device mesh over the joined process group.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import H100, HardwareConfig


@dataclass(frozen=True)
class MeshPlan:
    """A named (data, model) factorization of the chip grid."""
    name: str
    data: int
    model: int
    pod: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pod, self.data, self.model) if self.pod > 1 \
            else (self.data, self.model)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    @property
    def num_devices(self) -> int:
        return self.pod * self.data * self.model

    def build(self, device_type: Optional[str] = None):
        """The plan's ``DeviceMesh`` over the first ``num_devices`` ranks
        of the joined process group (every rank calls it).  A plan larger
        than the world raises: nothing shrinks quietly.  ``device_type``
        defaults to ``cuda`` when this rank has a card, else ``cpu``."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
        if not dist.is_initialized():
            raise RuntimeError(
                "MeshPlan.build: join the process group first "
                "(repro_torch.launch.mesh.init_distributed)")
        world = dist.get_world_size()
        if self.num_devices > world:
            raise ValueError(f"{self} needs {self.num_devices} ranks, the "
                             f"process group has {world}")
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        if self.num_devices == world:
            return init_device_mesh(device_type, self.shape,
                                    mesh_dim_names=self.axes)
        ranks = torch.arange(self.num_devices).reshape(self.shape)
        return DeviceMesh(device_type, ranks, mesh_dim_names=self.axes)


def plan_family(base: MeshPlan) -> Dict[str, MeshPlan]:
    """The three plans the controller arbitrates between.

    fused:     model x2, data /2   (scale-up: fuse neighboring groups)
    scale_out: model /2, data x2   (scale-out: split groups)
    """
    plans = {"base": base}
    if base.data % 2 == 0:
        plans["fused"] = dataclasses.replace(
            base, name="fused", data=base.data // 2, model=base.model * 2)
    if base.model % 2 == 0:
        plans["scale_out"] = dataclasses.replace(
            base, name="scale_out", data=base.data * 2, model=base.model // 2)
    return plans


def reshard_cost_s(param_bytes_per_chip: float,
                   hw: HardwareConfig = H100) -> float:
    """Crude upper bound for switching plans: every chip sends + receives
    its parameter shard once over the interconnect."""
    return 2.0 * param_bytes_per_chip / hw.ici_bandwidth


def amortized_switch_ok(step_gain_s: float, param_bytes_per_chip: float,
                        steps_remaining: float,
                        hw: HardwareConfig = H100) -> bool:
    """Switch only if the cumulative predicted win repays the reshard."""
    return step_gain_s * steps_remaining > reshard_cost_s(
        param_bytes_per_chip, hw)
