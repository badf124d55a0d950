"""Mixture-of-Experts FFN: fine-grained routed experts (+ shared experts,
+ optional arctic-style dense residual branch).

Counterpart of ``repro/models/moe.py``.  The port has no device mesh, so
``moe_forward`` always takes ``moe_dense``, as the reference does on one
device: every expert runs on every token and the outputs are combined by
routing weight.  The reference's capacity-buffer path (``_moe_local``,
``moe_sharded``) waits for distribution (ROADMAP queue 1, item 5).

The expert products are plain batched matmuls, as the reference's are
plain einsums outside any Pallas kernel.  ``x`` is broadcast over the
expert axis (``x2d[None]``) instead of repeated E times as the reference
does: the copy changes nothing in the result.  Nothing here syncs with the
host or has a data-dependent shape (no ``.item()``, ``nonzero`` or boolean
indexing), so a decode step stays capturable, and the routing telemetry
(``MoEAux``) stays on the device.

Returns routing telemetry (expert load fractions, dropped-token fraction)
— the divergence signal the AMOEBA controller consumes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


class MoEAux(NamedTuple):
    aux_loss: torch.Tensor      # scalar load-balance loss
    load: torch.Tensor          # (E,) fraction of assignments per expert
    dropped: torch.Tensor       # scalar fraction of dropped assignments


def init_moe(cfg: ModelConfig, device, generator: torch.Generator,
             lead=()) -> dict:
    """The reference's tree; the router stays float32 among ``cfg.dtype``
    leaves, as there."""
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    dtype = getattr(torch, cfg.dtype)
    lead = tuple(lead)

    def w(shape, std, dt=dtype):
        return layers.truncated_normal_(
            torch.empty(lead + shape, dtype=dt, device=device), std, generator)

    experts = {"wi_up": w((m.num_experts, d, f), 1.0 / math.sqrt(d)),
               "wo": w((m.num_experts, f, d), 1.0 / math.sqrt(f))}
    if cfg.activation == "swiglu":
        experts["wi_gate"] = w((m.num_experts, d, f), 1.0 / math.sqrt(d))
    params = {"router": w((d, m.num_experts), 1.0 / math.sqrt(d),
                          torch.float32),
              "experts": experts}
    if m.num_shared:
        params["shared"] = layers.init_mlp(d, m.num_shared * f,
                                           cfg.activation, dtype, device,
                                           generator, lead)
    if m.dense_residual:
        params["dense"] = layers.init_mlp(d, cfg.d_ff, cfg.activation, dtype,
                                          device, generator, lead)
    return params


def _route(params, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d: (T, D) -> top-k ids/weights + aux loss terms (fp32)."""
    m = cfg.moe
    logits = x2d.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    top_p, top_ids = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    top_w = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    assign = torch.zeros_like(probs).scatter_add_(
        1, top_ids, torch.ones_like(top_p))
    frac_assign = assign.mean(dim=0) / m.top_k                  # (E,)
    frac_prob = probs.mean(dim=0)
    aux = m.num_experts * torch.sum(frac_assign * frac_prob)
    return top_ids, top_w, aux, frac_assign


def _expert_ffn(bank, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (E, C, D), or (1, C, D) broadcast over E, through the expert
    MLPs -> (E, C, D)."""
    up = torch.matmul(x, bank["wi_up"])
    if cfg.activation == "swiglu":
        h = F.silu(torch.matmul(x, bank["wi_gate"])) * up
    elif cfg.activation == "relu2":
        h = torch.square(F.relu(up))
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return torch.matmul(h, bank["wo"])


def _extras(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Shared experts + dense residual (dense compute)."""
    y = torch.zeros_like(x)
    if "shared" in params:
        y = y + layers.mlp(params["shared"], x, cfg.activation)
    if "dense" in params:
        y = y + layers.mlp(params["dense"], x, cfg.activation)
    return y


def moe_dense(params, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, MoEAux]:
    """Capacity-free: all experts on all tokens."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    T_ = x2d.shape[0]
    top_ids, top_w, aux, load = _route(params, x2d, cfg)
    all_out = _expert_ffn(params["experts"], x2d[None], cfg)   # (E, T, D)
    gathered = all_out[top_ids.T, torch.arange(T_, device=x.device)[None]]
    y = torch.einsum("ktd,tk->td", gathered, top_w.to(x.dtype))
    y = y.reshape(B, S, D) + _extras(params, x, cfg)
    return y, MoEAux(aux_loss=aux, load=load,
                     dropped=torch.zeros((), device=x.device))


def moe_forward(params, x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, MoEAux]:
    """The reference's entry point; without a mesh it is ``moe_dense``."""
    return moe_dense(params, x, cfg)
