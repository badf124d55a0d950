"""Mixture-of-Experts FFN: fine-grained routed experts (+ shared experts,
+ optional arctic-style dense residual branch).

Counterpart of ``repro/models/moe.py``.  Two execution paths:

* ``moe_dense`` — capacity-free: every expert runs on every token and the
  outputs are combined by routing weight.  ``moe_forward`` takes it without
  a mesh, as the reference does.  ``x`` is broadcast over the expert axis
  (``x2d[None]``) instead of repeated E times: the copy changes nothing.
* ``moe_sharded`` — the production path under a mesh.  Experts are sharded
  over ``model`` (EP) and tokens over the batch axes; tokens are replicated
  across ``model``, so each rank packs the tokens of its rows routed to its
  own experts into a per-expert capacity buffer (slots by masked cumsum,
  one overflow row for the rest, counted in ``dropped``), runs the expert
  FFN as one batched matmul, scatters back, and one all-reduce SUM over
  ``model`` both combines the experts' contributions and restores
  replication.  Expert weights are also sharded over ``data`` (FSDP) and
  all-gathered per layer; in training that gather's transpose is a
  reduce-scatter (all-reduce + slice, ``parallel.collectives``).

The always-on branches (deepseek's shared experts, arctic's dense
residual) run outside the expert path in both.  Under a mesh with model
ranks every entry point hands them over as this rank's 'model' shards
(``tp``): Megatron's split of ``layers.mlp``, their partial sums added over
'model', as GSPMD divides the reference's by their ``mlp_pspecs``.

The expert products are plain batched matmuls, as the reference's are
plain einsums outside any Pallas kernel.  Nothing here syncs with the host
or has a data-dependent shape (no ``.item()``, ``nonzero`` or boolean
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
from repro_torch.obs.spans import SPANS
from repro_torch.parallel import collectives, shardctx
from repro_torch.parallel.shardctx import P


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


def moe_pspecs(cfg: ModelConfig) -> dict:
    """The reference's specs: expert banks ``("model", "data", None)``
    (``wo``: ``("model", None, "data")``), the router replicated."""
    m = cfg.moe
    names = ["wi_up", "wo"] + (["wi_gate"] if cfg.activation == "swiglu"
                               else [])
    specs = {"router": P(None, None),
             "experts": {k: P("model", None, "data") if k == "wo"
                         else P("model", "data", None) for k in names}}
    if m.num_shared:
        specs["shared"] = layers.mlp_pspecs(cfg.activation)
    if m.dense_residual:
        specs["dense"] = layers.mlp_pspecs(cfg.activation)
    return specs


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


def _extras(params, x: torch.Tensor, cfg: ModelConfig,
            tp: bool = False) -> torch.Tensor:
    """Shared experts + dense residual (dense compute).  With ``tp`` their
    weights are this rank's 'model' shards (``layers.mlp``'s Megatron
    split), each branch's partial sums added over 'model'."""
    y = torch.zeros_like(x)
    if "shared" in params:
        y = y + layers.mlp(params["shared"], x, cfg.activation, tp=tp)
    if "dense" in params:
        y = y + layers.mlp(params["dense"], x, cfg.activation, tp=tp)
    return y


def moe_dense(params, x: torch.Tensor, cfg: ModelConfig,
              tp: bool = False) -> Tuple[torch.Tensor, MoEAux]:
    """Capacity-free: all experts on all tokens (``tp``: :func:`_extras`')."""
    B, S, D = x.shape
    x2d = x.reshape(-1, D)
    T_ = x2d.shape[0]
    top_ids, top_w, aux, load = _route(params, x2d, cfg)
    all_out = _expert_ffn(params["experts"], x2d[None], cfg)   # (E, T, D)
    gathered = all_out[top_ids.T, torch.arange(T_, device=x.device)[None]]
    y = torch.einsum("ktd,tk->td", gathered, top_w.to(x.dtype))
    y = y.reshape(B, S, D) + _extras(params, x, cfg, tp)
    return y, MoEAux(aux_loss=aux, load=load,
                     dropped=torch.zeros((), device=x.device))


# ---------------------------------------------------------------------------
# Production path
# ---------------------------------------------------------------------------

def _moe_local(params_local, x_loc: torch.Tensor, cfg: ModelConfig,
               e_start: int, e_local: int, capacity: int, model_axis=None,
               fsdp_axis=None) -> Tuple[torch.Tensor, MoEAux]:
    """Per-rank body (standalone when unsharded).

    x_loc: (T, D) local tokens (replicated over ``model``).
    ``params_local["experts"]``: the bank of this model rank's experts; with
    ``fsdp_axis`` it arrives D-sharded (``DTensor``) and is all-gathered
    here.
    """
    m = cfg.moe
    T_, D = x_loc.shape
    dev = x_loc.device
    bank = params_local["experts"]
    if model_axis is not None or fsdp_axis is not None:
        keep = (model_axis,) if model_axis is not None else ()
        bank = {k: shardctx.gather(w, keep) for k, w in bank.items()}

    top_ids, top_w, aux, load = _route(params_local, x_loc, cfg)
    flat_ids = top_ids.reshape(-1)                       # (T*k,)
    flat_w = top_w.reshape(-1)
    mine = (flat_ids >= e_start) & (flat_ids < e_start + e_local)
    le = torch.clamp(flat_ids - e_start, 0, e_local - 1)  # local expert id
    # intra-expert slot via masked cumsum
    onehot = (F.one_hot(le, e_local).to(torch.int32)
              * mine[:, None].to(torch.int32))           # (T*k, E_loc)
    slot = torch.cumsum(onehot, dim=0) - onehot
    slot = torch.sum(slot * onehot, dim=-1)              # (T*k,)
    keep_ = mine & (slot < capacity)
    dropped_here = torch.sum(mine & ~keep_).float()

    tok_idx = torch.arange(T_, device=dev).repeat_interleave(m.top_k)
    slot_c = torch.where(keep_, slot, torch.full_like(slot, capacity))
    buf = torch.zeros((e_local, capacity + 1, D), dtype=x_loc.dtype,
                      device=dev)                        # + overflow row
    rows = torch.where(keep_[:, None], x_loc[tok_idx],
                       torch.zeros((), dtype=x_loc.dtype, device=dev))
    buf = buf.index_put((le, slot_c), rows)
    out_buf = _expert_ffn(bank, buf[:, :capacity], cfg)  # (E_loc, C, D)
    out_buf = torch.cat([out_buf, torch.zeros((e_local, 1, D),
                                              dtype=out_buf.dtype,
                                              device=dev)], dim=1)
    w_tok = torch.where(keep_, flat_w, torch.zeros_like(flat_w))
    y_tok = out_buf[le, slot_c] * w_tok[:, None].to(x_loc.dtype)
    y = torch.zeros_like(x_loc).index_add(0, tok_idx, y_tok)

    if model_axis is not None:
        y = collectives.psum(y, model_axis)
        dropped_here = collectives.psum(dropped_here, model_axis)
    dropped = dropped_here / (T_ * m.top_k)
    return y, MoEAux(aux_loss=aux, load=load, dropped=dropped)


def _moe_local_mapped(params_local, x_loc, cfg, e_start, e_local, capacity,
                      model_axis, fsdp_axis):
    """``_moe_local`` with the aux terms given a leading batch-shard dim of
    1: they are per-data-shard values, not replicated, so ``moe_sharded``
    averages them over the batch axes."""
    y, aux = _moe_local(params_local, x_loc, cfg, e_start, e_local, capacity,
                        model_axis, fsdp_axis)
    return y, MoEAux(aux_loss=aux.aux_loss[None], load=aux.load[None],
                     dropped=aux.dropped[None])


def _mean_over_batch(aux: MoEAux) -> MoEAux:
    """Per-data-shard aux terms -> their mean over the batch axes."""
    bat = shardctx.batch_axes()
    return MoEAux(*(collectives.pmean(t, bat).mean(dim=0) for t in aux))


def moe_sharded(params, x: torch.Tensor, cfg: ModelConfig,
                tp: bool = False) -> Tuple[torch.Tensor, MoEAux]:
    """EP over ``model``, token-parallel over the batch axes, FSDP over
    ``data``.  ``x`` holds this rank's rows; the capacity counts them (the
    reference's ``t_local``).  ``tp``: the always-on branches on 'model'
    shards (:func:`_extras`)."""
    B, S, D = x.shape
    m = cfg.moe
    mesh = shardctx.current_mesh()
    x2d = x.reshape(-1, D)
    t_local = x2d.shape[0]

    if mesh is None or "model" not in shardctx.mesh_axes(mesh):
        cap = int(math.ceil(t_local * m.top_k / m.num_experts
                            * m.capacity_factor))
        routed = {"router": shardctx.gather(params["router"]),
                  "experts": {k: shardctx.gather(w)
                              for k, w in params["experts"].items()}}
        y, aux = _moe_local(routed, x2d, cfg, 0, m.num_experts, cap,
                            None, None)
        if mesh is not None:
            aux = _mean_over_batch(MoEAux(*(t[None] for t in aux)))
        y = y + _extras(params, x2d, cfg, tp)
        return y.reshape(B, S, D), aux

    n_model = shardctx.axis_size("model")
    e_local = m.num_experts // n_model
    capacity = int(math.ceil(t_local * m.top_k / m.num_experts
                             * m.capacity_factor))
    has_fsdp = shardctx.axis_size("data") > 1
    e_start = shardctx.axis_index("model") * e_local
    # a bank handed over whole (not a DTensor) gives this rank its experts
    bank = {k: w if shardctx.is_dtensor(w) else w[e_start:e_start + e_local]
            for k, w in params["experts"].items()}
    routed = {"router": shardctx.gather(params["router"]), "experts": bank}
    y, aux = _moe_local_mapped(routed, x2d, cfg, e_start, e_local, capacity,
                               "model", "data" if has_fsdp else None)
    # always-on branches (shared experts / arctic dense residual) run as
    # plain matmuls outside the expert path, on 'model' shards with ``tp``
    # as GSPMD divides the reference's by their specs
    y = y + _extras(params, x2d, cfg, tp)
    return y.reshape(B, S, D), _mean_over_batch(aux)


def moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                production: bool = True,
                tp: bool = False) -> Tuple[torch.Tensor, MoEAux]:
    """``moe_sharded`` under a mesh with ``production``, else
    ``moe_dense`` (under a mesh its aux terms are averaged over the batch
    axes, as the reference's global ones are).  ``tp``: the shared experts
    and dense residual come as this rank's 'model' shards
    (``transformer._tp_block_params``)."""
    if SPANS.on:
        with SPANS.span("model.moe", tokens=x.numel() // x.shape[-1]):
            return _moe_forward(params, x, cfg, production, tp)
    return _moe_forward(params, x, cfg, production, tp)


def _moe_forward(params, x: torch.Tensor, cfg: ModelConfig,
                 production: bool, tp: bool) -> Tuple[torch.Tensor, MoEAux]:
    if shardctx.current_mesh() is None:
        return moe_dense(params, x, cfg)
    if production:
        return moe_sharded(params, x, cfg, tp)
    y, aux = moe_dense(params, x, cfg, tp)
    return y, _mean_over_batch(MoEAux(*(t[None] for t in aux)))
