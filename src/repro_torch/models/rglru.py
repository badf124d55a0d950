"""RG-LRU recurrent block (recurrentgemma / Griffin).

Counterpart of ``repro/models/rglru.py``:

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),  r_t = sigmoid(x W_a + b_a),
i_t = sigmoid(x W_x).

The block is: in-proj (x branch + gate branch) -> causal conv on x branch
-> RG-LRU -> gate by gelu (tanh approximation, ``jax.nn.gelu``'s default)
-> out-proj.  The recurrence is fp32; it goes through the CUDA kernel
(``kernels.ops.rglru_scan``) under ``use_kernel`` and through
``scan_utils.linear_scan`` otherwise.

Tensor parallelism (``tp``) splits the width W over 'model', as the
reference's specs do (``rglru_pspecs``): ``in_x``, ``in_gate``, ``wa`` and
``wx`` are column-parallel, ``out`` row-parallel (its partial sums add over
'model'), and ``ba``, ``lam`` and ``conv_w`` per channel.  The gates' input
is the conv output, itself on the rank's W / n channels, so it is
all-gathered over 'model' for ``wa`` / ``wx`` (as GSPMD inserts it); the
scan and the gelu gate run on the rank's channels.  The decode state then
holds the rank's channels, a ``DTensor`` over the model axis
(``rglru_state_pspec``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import layers, scan_utils
from repro_torch.parallel import collectives, shardctx
from repro_torch.parallel.shardctx import P

_C = 8.0  # Griffin's fixed temperature on the recurrence gate


class RGLRUState(NamedTuple):
    conv: torch.Tensor   # (B, K-1, W)
    h: torch.Tensor      # (B, W) fp32


# each state field's channel dimension, the one ``rglru_state_pspec``
# splits over 'model'
STATE_MODEL_DIM = RGLRUState(conv=-1, h=-1)


def init_rglru(cfg: ModelConfig, device, generator: torch.Generator,
               lead=()) -> dict:
    r = cfg.rglru
    d = cfg.d_model
    w = r.lru_width or d
    dtype = getattr(torch, cfg.dtype)
    lead = tuple(lead)

    def mat(shape, std):
        return layers.truncated_normal_(
            torch.empty(lead + shape, dtype=dtype, device=device), std,
            generator)

    # Lambda init so that a ~ uniform(0.9, 0.999) at r=1 (Griffin appendix)
    u = torch.empty(lead + (w,), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    std_d, std_w = 1.0 / math.sqrt(d), 1.0 / math.sqrt(w)
    return {
        "in_x": mat((d, w), std_d),
        "in_gate": mat((d, w), std_d),
        "conv_w": mat((r.conv_width, w), 0.1),
        "wa": mat((w, w), std_w),
        "wx": mat((w, w), std_w),
        "ba": torch.zeros(lead + (w,), dtype=torch.float32, device=device),
        "lam": torch.log(torch.expm1(-torch.log(u) / _C)),
        "out": mat((w, d), std_w),
    }


def _gates(params, xc, tp: bool = False):
    """xc: (..., W) conv output -> (a, gated_input) in fp32.  Under ``tp``
    xc holds the rank's channels; the gate columns of ``wa`` / ``wx`` read
    every channel, all-gathered over 'model'."""
    xg = collectives.all_gather(xc, xc.dim() - 1, "model") if tp else xc
    r = torch.sigmoid((xg @ params["wa"]).float() + params["ba"])
    i = torch.sigmoid((xg @ params["wx"]).float())
    log_a = -_C * F.softplus(params["lam"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    b = beta * i * xc.float()
    return a, b


def rglru_forward(params, x: torch.Tensor, cfg: ModelConfig,
                  use_kernel: bool = False, return_state: bool = False,
                  tp: bool = False):
    """x: (B,S,D) -> (B,S,D) (optionally also the final RGLRUState).  With
    ``tp`` the weights are this rank's shards (module docstring)."""
    xb = x @ params["in_x"]
    gate = x @ params["in_gate"]
    xc = scan_utils.causal_conv1d(xb, params["conv_w"])
    a, b = _gates(params, xc, tp)
    if use_kernel:
        h = kernel_ops.rglru_scan(a, b)
        h_last = h[:, -1]
    else:
        h0 = a.new_zeros((x.shape[0], a.shape[-1]))
        h, h_last = scan_utils.linear_scan(a, b, h0)
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = y @ params["out"]
    if tp:
        out = collectives.psum(out, "model")
    if not return_state:
        return out
    conv_state = scan_utils.conv_tail(xb, (cfg.rglru.conv_width
                                           if cfg.rglru else 4))
    # a copy: the state must not keep the whole (B, S, W) scan output alive
    state = RGLRUState(conv=conv_state, h=h_last.clone())
    if tp:
        state = RGLRUState(*(shardctx.model_sharded(t, d)
                             for t, d in zip(state, STATE_MODEL_DIM)))
    return out, state


def rglru_pspecs() -> dict:
    return {"in_x": P("data", "model"), "in_gate": P("data", "model"),
            "conv_w": P(None, "model"), "wa": P("data", "model"),
            "wx": P("data", "model"), "ba": P("model"), "lam": P("model"),
            "out": P("model", "data")}


def rglru_state_pspec() -> RGLRUState:
    return RGLRUState(conv=P("batch", None, "model"),
                      h=P("batch", "model"))


def init_rglru_state(cfg: ModelConfig, batch: int, device,
                     lead=()) -> RGLRUState:
    r = cfg.rglru
    w = r.lru_width or cfg.d_model
    lead = tuple(lead)
    return RGLRUState(
        conv=torch.zeros(lead + (batch, r.conv_width - 1, w),
                         dtype=getattr(torch, cfg.dtype), device=device),
        h=torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
    )


def rglru_step(params, state: RGLRUState, x_new: torch.Tensor,
               cfg: ModelConfig, tp: bool = False
               ) -> Tuple[torch.Tensor, RGLRUState]:
    """Decode step.  x_new: (B,1,D) -> (B,1,D).  With ``tp`` the weights
    are this rank's shards and ``state`` holds its channels (a ``DTensor``
    over 'model', as ``rglru_forward`` leaves it); the new state comes back
    laid out as ``state``."""
    conv0, h0 = (shardctx.local(t) for t in state)
    xb = x_new[:, 0] @ params["in_x"]
    if conv0.shape[-1] != xb.shape[-1]:
        raise ValueError(f"rglru_step: a state of {conv0.shape[-1]} "
                         f"channels for weights of {xb.shape[-1]}")
    gate = x_new[:, 0] @ params["in_gate"]
    xc, conv_state = scan_utils.causal_conv1d_step(
        xb, conv0, params["conv_w"])
    a, b = _gates(params, xc, tp)
    h = scan_utils.linear_scan_step(a, b, h0)
    y = h.to(x_new.dtype) * F.gelu(gate, approximate="tanh")
    out = (y @ params["out"])[:, None]
    if tp:
        out = collectives.psum(out, "model")
    return out, RGLRUState(conv=shardctx.like(state.conv, conv_state),
                           h=shardctx.like(state.h, h))
