"""Mamba-1 selective-SSM block (falcon-mamba-7b).

Counterpart of ``repro/models/ssm.py``: in-proj (x and z branches) ->
causal depthwise conv -> silu -> selective scan with the C-contraction ->
``+ D x`` -> gate by silu(z) -> out-proj.  ``A_log``, ``D`` and the scan
are fp32.  Under ``use_kernel`` the discretization and the scan are one
CUDA kernel (``kernels.ops.selective_scan``); otherwise the discretized
``a`` and ``b`` are built whole and go through
``scan_utils.linear_scan_contract``.  The decode step is elementwise, as in
the reference.

Tensor parallelism (``tp``) splits ``d_inner`` over 'model', as the
reference's specs do (``ssm_pspecs``): the weights are this rank's shards,
``in_proj`` as its x and z columns side by side (:func:`in_proj_shard`).
The conv, the discretization, the scan and the gate are per channel and
run on the rank's ``d_inner / n`` channels; ``x_proj`` contracts over them,
so its (dt, B, C) projection adds over 'model' before ``dt_proj``;
``out_proj`` is row-parallel and adds over 'model'.  The decode state then
holds the rank's channels, a ``DTensor`` over the model axis
(``ssm_state_pspec``).
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


class SSMState(NamedTuple):
    conv: torch.Tensor   # (B, d_conv-1, d_inner)
    h: torch.Tensor      # (B, d_inner, d_state) fp32


# each state field's channel dimension, the one ``ssm_state_pspec`` splits
# over 'model'
STATE_MODEL_DIM = SSMState(conv=-1, h=-2)


def init_ssm(cfg: ModelConfig, device, generator: torch.Generator,
             lead=()) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dtr = s.resolved_dt_rank(d)
    dtype = getattr(torch, cfg.dtype)
    lead = tuple(lead)

    def w(shape, std):
        return layers.truncated_normal_(
            torch.empty(lead + shape, dtype=dtype, device=device), std,
            generator)

    log_dt = torch.empty(lead + (di,), dtype=torch.float32, device=device)
    log_dt.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    a_log = torch.log(torch.arange(1, s.d_state + 1, dtype=torch.float32,
                                   device=device))
    return {
        "in_proj": w((d, 2 * di), 1.0 / math.sqrt(d)),
        "conv_w": w((s.d_conv, di), 0.1),
        "x_proj": w((di, dtr + 2 * s.d_state), 1.0 / math.sqrt(di)),
        "dt_proj": w((dtr, di), 1.0 / math.sqrt(dtr)),
        # inverse softplus of dt ~ log-uniform(1e-3, 1e-1)
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))).to(dtype),
        "A_log": a_log.expand(lead + (di, s.d_state)).contiguous(),
        "D": torch.ones(lead + (di,), dtype=torch.float32, device=device),
        "out_proj": w((di, d), 1.0 / math.sqrt(di)),
    }


def in_proj_shard(w: torch.Tensor) -> torch.Tensor:
    """This rank's columns of a whole ``in_proj`` (D, 2 di): ``[r di/n,
    (r+1) di/n)`` of the x half and of the z half, side by side.  A
    contiguous 'model' chunk of the 2 di columns is not that: on 2 ranks,
    rank 0's is the whole x half."""
    xw, zw = torch.chunk(w, 2, dim=-1)
    return torch.cat([shardctx.model_chunk(xw, -1),
                      shardctx.model_chunk(zw, -1)], dim=-1)


def _ssm_inner(params, xc, cfg: ModelConfig, tp: bool = False):
    """Common post-conv math: returns (dt, A, Bmat, Cmat).

    xc: (B, S, di) conv+silu output (the rank's channels under ``tp``,
    whose partial x-projections add over 'model').
    """
    s = cfg.ssm
    dtr = s.resolved_dt_rank(cfg.d_model)
    proj = xc @ params["x_proj"]                     # (B,S,dtr+2N)
    if tp:
        proj = collectives.psum(proj, "model")
    dt, Bm, Cm = torch.split(proj, [dtr, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"]
                    + params["dt_bias"].to(dt.dtype))  # (B,S,di)
    A = -torch.exp(params["A_log"])                  # (di, N) fp32
    return dt, A, Bm, Cm


def ssm_forward(params, x: torch.Tensor, cfg: ModelConfig,
                use_kernel: bool = False, return_state: bool = False,
                tp: bool = False):
    """x: (B,S,D) -> (B,S,D) (optionally also the final SSMState).  With
    ``tp`` the weights are this rank's shards (module docstring)."""
    s = cfg.ssm
    xz = x @ params["in_proj"]
    xp, z = torch.chunk(xz, 2, dim=-1)               # (B,S,di) each
    xc = F.silu(scan_utils.causal_conv1d(xp, params["conv_w"]))
    dt, A, Bm, Cm = _ssm_inner(params, xc, cfg, tp)
    if use_kernel:
        # the discretization happens inside the scan kernel: no
        # (B, S, di, N) tensor is built
        y, h_last = kernel_ops.selective_scan(dt, xc, A, Bm, Cm)
    else:
        dtf = dt.float()
        # discretize: a = exp(dt*A), b = dt*x*B, both (B,S,di,N); exp in
        # place, since each is 8.6 GB for a wave of 8 rows of 2048 at full
        # width
        a = (dtf[..., None] * A).exp_()
        bx = (dtf * xc.float())[..., None] * Bm.float()[:, :, None, :]
        h0 = a.new_zeros(a.shape[:1] + a.shape[2:])
        y, h_last = scan_utils.linear_scan_contract(a, bx, Cm.float(), h0)
        del a, bx
    y = y + params["D"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    if tp:
        out = collectives.psum(out, "model")
    if not return_state:
        return out
    state = SSMState(conv=scan_utils.conv_tail(xp, s.d_conv), h=h_last)
    if tp:
        state = SSMState(*(shardctx.model_sharded(t, d)
                           for t, d in zip(state, STATE_MODEL_DIM)))
    return out, state


def ssm_pspecs() -> dict:
    return {"in_proj": P("data", "model"), "conv_w": P(None, "model"),
            "x_proj": P("model", None), "dt_proj": P(None, "model"),
            "dt_bias": P("model"), "A_log": P("model", None),
            "D": P("model"), "out_proj": P("model", "data")}


def ssm_state_pspec() -> SSMState:
    return SSMState(conv=P("batch", None, "model"),
                    h=P("batch", "model", None))


def init_ssm_state(cfg: ModelConfig, batch: int, device, lead=()) -> SSMState:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    lead = tuple(lead)
    return SSMState(
        conv=torch.zeros(lead + (batch, s.d_conv - 1, di),
                         dtype=getattr(torch, cfg.dtype), device=device),
        h=torch.zeros(lead + (batch, di, s.d_state), dtype=torch.float32,
                      device=device),
    )


def ssm_step(params, state: SSMState, x_new: torch.Tensor,
             cfg: ModelConfig, tp: bool = False
             ) -> Tuple[torch.Tensor, SSMState]:
    """Decode step.  x_new: (B,1,D) -> (B,1,D).  With ``tp`` the weights
    are this rank's shards and ``state`` holds its channels (a ``DTensor``
    over 'model', as ``ssm_forward`` leaves it); the new state comes back
    laid out as ``state``."""
    conv0, h0 = (shardctx.local(t) for t in state)
    xz = x_new[:, 0] @ params["in_proj"]
    xp, z = torch.chunk(xz, 2, dim=-1)                # (B,di)
    if conv0.shape[-1] != xp.shape[-1]:
        raise ValueError(f"ssm_step: a state of {conv0.shape[-1]} channels "
                         f"for weights of {xp.shape[-1]}")
    xc, conv_state = scan_utils.causal_conv1d_step(
        xp, conv0, params["conv_w"])
    xc = F.silu(xc)
    dt, A, Bm, Cm = _ssm_inner(params, xc[:, None], cfg, tp)
    dtf = dt[:, 0].float()                            # (B,di)
    a = torch.exp(dtf[..., None] * A)                 # (B,di,N)
    bx = (dtf * xc.float())[..., None] * Bm[:, 0].float()[:, None, :]
    h = scan_utils.linear_scan_step(a, bx, h0)
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = y + params["D"] * xc.float()
    y = y.to(x_new.dtype) * F.silu(z)
    out = (y @ params["out_proj"])[:, None]
    if tp:
        out = collectives.psum(out, "model")
    return out, SSMState(conv=shardctx.like(state.conv, conv_state),
                         h=shardctx.like(state.h, h))
