"""Fault-tolerant trainer, on one device or over a device mesh.

Counterpart of ``repro/train/trainer.py``.  The step is eager and keeps
the reference's order: loss and gradients by autograd through
``models.transformer.loss_fn`` (activation checkpointing under
``Runtime.remat``), gradient accumulation over ``micro_steps`` in the
parameters' dtype, the global norm and its clip factor, the int8
compression round trip with error feedback (``parallel.compression``; its
quantizer is the hand-written CUDA kernel on the card), then the cosine
schedule and AdamW, which updates parameters and moments in place (the
torch counterpart of the reference's donation).

Fault tolerance, as the reference's:

* periodic **async atomic checkpoints** (``repro_torch.ckpt``) of params +
  optimizer + data-iterator step; ``train()`` resumes from the newest one,
  and a ``failure_injector`` hook lets tests kill arbitrary steps to prove
  the resume path is exact (same data order, same loss curve);
* a **StragglerMonitor** flags slow steps for the control plane.

Divergence telemetry (MoE expert imbalance) is fed to the AMOEBA
controller each step when one is attached.

Under a mesh (``mesh=``, a ``DeviceMesh``; every rank runs the same
trainer) parameters, moments and residuals are ``DTensor``s laid out by
their resolved specs (``state_pspecs``), so each rank holds its share;
``place_batch`` gives each rank its rows of the batch.  Each rank takes
gradients of ``loss / world_size`` through the model's gathers, whose
transposes leave on each rank the exact gradient of its own shards (see
``parallel.collectives``).  The global norm counts every element once, and
the int8 compression quantizes the rows of the whole (global) leaf, as the
reference's does (``compression.round_trip_sharded_``: each rank gathers
only the dimensions that cut its rows and keeps its shard of the
result).  AdamW is elementwise and
updates each rank's shards in place.  A checkpoint saved under one plan
restores onto another (``ckpt.restore(pspecs=, mesh=)``).

The training step runs ``use_kernels=False``, as the reference's does: the
kernels have no backward.  Floating-point inputs
(whisper's audio frames, qwen2-vl's patch embeddings) are fed in the
model's dtype; for a bfloat16 model the reference would carry float32
frames through the encoder in float32 by type promotion, which torch's
matmul does not do.  A float32 model computes the same either way.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import pytree, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.controller import AmoebaController
from repro_torch.core.regroup import moe_divergence
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as A
from repro_torch.parallel import compression as C
from repro_torch.parallel import shardctx
from repro_torch.parallel.shardctx import P
from repro_torch.train.stragglers import StragglerMonitor


class TrainState(NamedTuple):
    params: Any
    opt: A.AdamWState
    data_step: torch.Tensor      # () int32 — exact-resume data cursor
    residuals: Any = None        # grad-compression error feedback


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class StepMetrics:
    step: int
    loss: float
    grad_norm: float
    lr: float
    dt: float
    divergence: float = 0.0


class Trainer:
    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: TrainConfig = TrainConfig(),
                 rt: Optional[T.Runtime] = None, mesh=None,
                 controller: Optional[AmoebaController] = None,
                 data_cfg: DataConfig = DataConfig(),
                 state_dtype: Optional[str] = None, device="cuda"):
        self.model_cfg = model_cfg
        self.shape = shape
        self.tcfg = tcfg
        self.rt = rt or T.Runtime(production=mesh is not None,
                                  remat=tcfg.remat != "none")
        self.mesh = mesh
        self._pspecs = None
        self.controller = controller
        self.data = SyntheticLM(model_cfg, shape, data_cfg)
        self.state_dtype = state_dtype
        self.device = resolve_device(device)

    # -- state ----------------------------------------------------------------

    def _fresh_state(self, seed: int, device: torch.device) -> TrainState:
        gen = torch.Generator(
            device=device if device.type != "meta" else "cpu")
        params = T.init_model(self.model_cfg, gen.manual_seed(seed), device)
        residuals = (C.init_residuals(params)
                     if self.tcfg.grad_compression else None)
        return TrainState(params=params,
                          opt=A.adamw_init(params, self.state_dtype),
                          data_step=torch.zeros((), dtype=torch.int32,
                                                device=device),
                          residuals=residuals)

    def init_state(self, seed: int = 0) -> TrainState:
        """Random parameters from a seeded generator on the trainer's
        device, zero moments and residuals; under a mesh each rank makes
        the whole parameters (the same on every rank) and keeps its shards,
        and the moments and residuals are made as shards."""
        if self.mesh is None:
            return self._fresh_state(seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        whole = T.init_model(self.model_cfg, gen, self.device)
        params = shardctx.layout_tree(whole, self.state_pspecs().params,
                                      self.mesh)
        del whole
        residuals = (C.init_residuals(params)
                     if self.tcfg.grad_compression else None)
        return TrainState(params=params,
                          opt=A.adamw_init(params, self.state_dtype),
                          data_step=torch.zeros((), dtype=torch.int32,
                                                device=self.device),
                          residuals=residuals)

    def place_state(self, state: TrainState) -> TrainState:
        """A whole state (the same on every rank: a reference's, a
        restored one) laid out by ``state_pspecs`` on the trainer's mesh
        and device; without a mesh, moved to the device."""
        if self.mesh is None:
            return pytree.map_(lambda t: t.to(self.device), state)
        return shardctx.layout_tree(state, self.state_pspecs(), self.mesh,
                                    device=self.device)

    def state_pspecs(self) -> TrainState:
        if self._pspecs is None:
            _, self._pspecs = T.model_pspecs(self.model_cfg)
        residual_specs = self._pspecs if self.tcfg.grad_compression else None
        return TrainState(params=self._pspecs,
                          opt=A.adamw_pspecs(self._pspecs),
                          data_step=P(), residuals=residual_specs)

    def _restore_template(self) -> TrainState:
        """The state's structure and dtypes on the meta device (no memory:
        the reference's ``eval_shape``)."""
        return self._fresh_state(self.tcfg.seed, torch.device("meta"))

    # -- the step ----------------------------------------------------------------

    def loss_and_grads(self, params, batch):
        """-> (loss, metrics, grads) by autograd through ``loss_fn``; grads
        in the parameters' dtypes (under a mesh, ``DTensor``s laid out as
        the parameters, each rank's shards exact)."""
        if self.mesh is not None:
            return self._mesh_loss_and_grads(params, batch)
        leaves = pytree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, metrics = T.loss_fn(params, batch, self.model_cfg, self.rt)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                pytree.unflatten(params, iter(grads)))

    def _mesh_loss_and_grads(self, params, batch):
        """The autograd leaves are this rank's shards; the model sees them
        as ``DTensor``s.  The loss is the whole batch's on every rank, so
        each rank differentiates ``loss / world_size``."""
        flat = pytree.leaves(params)
        locs = [shardctx.local(p).detach().requires_grad_(True)
                for p in flat]
        view = pytree.unflatten(params, iter(
            shardctx.like(p, x) for p, x in zip(flat, locs)))
        with shardctx.use_mesh(self.mesh):
            loss, metrics = T.loss_fn(view, batch, self.model_cfg, self.rt)
            grads = torch.autograd.grad(loss / self.mesh.size(), locs)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                pytree.unflatten(params, iter(
                    shardctx.like(p, g) for p, g in zip(flat, grads))))

    def _accumulated(self, params, batch):
        """``loss_and_grads`` summed over ``micro_steps`` microbatches (row
        blocks of the batch) in the parameters' dtype, then averaged: the
        activation peak is one microbatch's."""
        k = self.tcfg.micro_steps
        gacc = pytree.map_(torch.zeros_like, params)
        lsum = torch.zeros((), device=self.device)
        msum: Dict[str, torch.Tensor] = {}
        for i in range(k):
            mb = {n: v.reshape((k, v.shape[0] // k) + v.shape[1:])[i]
                  for n, v in batch.items()}
            loss, metrics, grads = self.loss_and_grads(params, mb)
            for a, b in zip(pytree.leaves(gacc), pytree.leaves(grads)):
                a.add_(b.to(a.dtype))
            del grads
            lsum = lsum + loss
            for n in ("expert_load", "dropped_frac"):
                if n in metrics:
                    msum[n] = msum[n] + metrics[n] if n in msum \
                        else metrics[n]
        grads = pytree.map_(lambda g: g / k, gacc)
        return lsum / k, {n: v / k for n, v in msum.items()}, grads

    def step(self, state: TrainState, batch):
        """One optimizer step: -> (new state, {"loss", "grad_norm", "lr",
        ["expert_load", "dropped_frac"]}) as device tensors.  ``state``'s
        parameters, moments and residuals are updated in place."""
        tcfg = self.tcfg
        if tcfg.micro_steps > 1:
            loss, metrics, grads = self._accumulated(state.params, batch)
        else:
            loss, metrics, grads = self.loss_and_grads(state.params, batch)
        gnorm = A.global_norm(grads)
        gscale = torch.clamp(gnorm.new_tensor(tcfg.grad_clip)
                             / torch.clamp(gnorm, min=1e-9), max=1.0)
        if tcfg.grad_compression:
            # int8 wire-format roundtrip with error feedback: the numerics
            # of the compressed data-parallel all-reduce
            for g, r in zip(pytree.leaves(grads),
                            pytree.leaves(state.residuals)):
                if shardctx.is_dtensor(g):
                    C.round_trip_sharded_(g, r)
                else:
                    C.round_trip_(g, r)
        lr = A.cosine_schedule(state.opt.step, base_lr=tcfg.learning_rate,
                               warmup=tcfg.warmup_steps,
                               total=tcfg.total_steps)
        # elementwise: each rank's shards update as the whole would
        loc = lambda t: pytree.map_(shardctx.local, t)  # noqa: E731
        _, opt = A.adamw_update(
            loc(state.params), loc(grads),
            state.opt._replace(m=loc(state.opt.m), v=loc(state.opt.v)),
            lr=lr, weight_decay=tcfg.weight_decay, grad_scale=gscale)
        params = state.params
        opt = opt._replace(m=state.opt.m, v=state.opt.v)
        new_state = TrainState(params=params, opt=opt,
                               data_step=state.data_step + 1,
                               residuals=state.residuals)
        out = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        for n in ("expert_load", "dropped_frac"):
            if n in metrics:
                out[n] = metrics[n]
        return new_state, out

    def place_batch(self, batch: Dict[str, np.ndarray]):
        """Host batch -> device tensors: int64 tokens, floating inputs in
        the model's dtype; under a mesh this rank's rows (sharded over the
        batch axes, replicated when they do not divide the batch)."""
        dtype = getattr(torch, self.model_cfg.dtype)
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(v)
            t = t.long() if k == "tokens" else t.to(dtype)
            out[k] = shardctx.batch_shard(t, self.mesh).to(self.device)
        return out

    # -- the loop -------------------------------------------------------------------

    def _restore(self, ckpt) -> TrainState:
        return ckpt.restore(
            like=self._restore_template(),
            pspecs=self.state_pspecs() if self.mesh is not None else None,
            mesh=self.mesh, device=self.device)[1]

    def train(self, steps: int, state: Optional[TrainState] = None,
              ckpt=None, log_every: int = 10,
              failure_injector: Optional[Callable[[int], bool]] = None,
              monitor: Optional[StragglerMonitor] = None
              ) -> Dict[str, Any]:
        """Run up to ``steps`` optimizer steps with checkpoint/restart.

        Returns {"state", "history", "monitor", "resumes"}.
        """
        monitor = monitor or StragglerMonitor()
        history: List[StepMetrics] = []
        resumes = 0

        if state is None:
            restored = False
            if ckpt is not None:
                try:
                    state = self._restore(ckpt)
                    restored = True
                    resumes += 1
                except FileNotFoundError:
                    pass
            if not restored:
                state = self.init_state(self.tcfg.seed)

        k = int(state.data_step)
        while k < steps:
            try:
                if failure_injector is not None and failure_injector(k):
                    raise SimulatedFailure(f"injected failure at step {k}")
                batch = self.place_batch(self.data.batch_at(k))
                monitor.start()
                state, out = self.step(state, batch)
                loss = float(out["loss"])
                dt = monitor.stop(k)
                div = 0.0
                if "expert_load" in out:
                    div = moe_divergence(out["expert_load"].cpu().numpy())
                    if self.controller is not None:
                        self.controller.observe(div)
                history.append(StepMetrics(
                    step=k, loss=loss, grad_norm=float(out["grad_norm"]),
                    lr=float(out["lr"]), dt=dt, divergence=div))
                k += 1
                if ckpt is not None and k % self.tcfg.checkpoint_every == 0:
                    ckpt.save(k, state, extra={"k": k})
            except SimulatedFailure:
                # crash/restart path: reload newest durable checkpoint
                if ckpt is None:
                    raise
                ckpt.wait()
                try:
                    state = self._restore(ckpt)
                except FileNotFoundError:
                    state = self.init_state(self.tcfg.seed)
                k = int(state.data_step)
                resumes += 1
        if ckpt is not None:
            ckpt.save(steps, state, extra={"k": steps}, blocking=True)
        return {"state": state, "history": history, "monitor": monitor,
                "resumes": resumes}
