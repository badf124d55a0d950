"""The model's work, whatever implements it: FLOPs and bytes from shapes.

These counts are the yardstick for ``mfu`` and the kernels' roofline
shares.  They count what the model needs, not what the port executes:
a MoE token goes through its ``top_k`` routed and its shared experts
(never the ``num_experts`` that a dense fallback runs), causal attention
scores the positions a token attends, and a prefill computes the LM head
at its last position only.

``model`` is a configuration file's ``model`` object (the port's
``ModelConfig`` fields), so nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

from port_bench.harness import peaks


def layer_kinds(model: dict) -> Tuple[str, ...]:
    pat = model.get("block_pattern")
    if pat is None:
        pat = ("ssm",) if model["family"] == "ssm" else ("attn",)
    return tuple(pat[i % len(pat)] for i in range(model["num_layers"]))


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["num_heads"]


def ssm_sizes(model: dict) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank) of a Mamba-1 mixer."""
    s = model["ssm"]
    d = model["d_model"]
    di = s.get("expand", 2) * d
    dtr = s.get("dt_rank") or max(1, d // 16)
    return di, s.get("d_state", 16), s.get("d_conv", 4), dtr


def matmul_params(model: dict) -> Dict[str, float]:
    """Weights one token multiplies, by where they are: ``blocks`` (all
    layers, a MoE's routed experts at top_k of them) and ``head`` (the LM
    head; the embedding lookup multiplies nothing)."""
    d = model["d_model"]
    hd = head_dim(model)
    gated = 3 if model.get("activation", "swiglu") == "swiglu" else 2
    blocks = 0.0
    for kind in layer_kinds(model):
        if kind == "attn":
            blocks += d * hd * (2 * model["num_heads"]
                                + 2 * model["num_kv_heads"])
        elif kind == "ssm":
            di, n, _, dtr = ssm_sizes(model)
            blocks += d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
        else:
            raise ValueError(f"no FLOP count for a {kind!r} layer")
        if kind == "ssm":
            continue                       # Mamba blocks have no FFN
        moe = model.get("moe")
        if moe:
            f = moe["d_ff_expert"]
            blocks += d * moe["num_experts"]                   # router
            blocks += (moe["top_k"] + moe.get("num_shared", 0)) \
                * gated * d * f
        elif model.get("d_ff"):
            blocks += gated * d * model["d_ff"]
    return {"blocks": blocks, "head": d * model["vocab_size"]}


def scan_ops(tokens: float, model: dict) -> float:
    """The selective scan's operations for ``tokens`` positions of one
    layer: per channel and state, ``dt*A``, its exp, ``(dt x) * B``, the
    update ``a h + b`` (2) and ``C h`` into y (2); per channel ``dt x``."""
    di, n, _, _ = ssm_sizes(model)
    return tokens * di * (7 * n + 1)


def ssm_extra(model: dict) -> float:
    """FLOPs of one token beyond the weights in the Mamba layers: the
    depthwise conv and the scan."""
    out = 0.0
    for kind in layer_kinds(model):
        if kind == "ssm":
            di, _, k, _ = ssm_sizes(model)
            out += 2.0 * k * di + scan_ops(1, model)
    return out


def attn_extra(model: dict, ctx: float) -> float:
    """Attention's scores and P.V for one token attending ``ctx``
    positions (itself included), over the attention layers."""
    n_attn = sum(k == "attn" for k in layer_kinds(model))
    return 4.0 * model["num_heads"] * head_dim(model) * ctx * n_attn


def prefill_flops(model: dict, batch: int, seq: int) -> float:
    """One prefill call of ``batch`` prompts of ``seq`` tokens: the blocks
    on every token, causal attention over positions 1..seq, and the LM
    head at the last position of each prompt."""
    p = matmul_params(model)
    attn = attn_extra(model, 1.0) * seq * (seq + 1) / 2
    return batch * (2.0 * p["blocks"] * seq + attn
                    + ssm_extra(model) * seq + 2.0 * p["head"])


def decode_flops(model: dict, ctx: float) -> float:
    """One generated token whose attention sees ``ctx`` positions."""
    p = matmul_params(model)
    return (2.0 * (p["blocks"] + p["head"]) + attn_extra(model, ctx)
            + ssm_extra(model))


def flash_cost(batch: int, heads: int, hd: int, seq: int,
               elt: int = 2) -> Tuple[float, float]:
    """(ops, bytes) of one causal flash-attention call: 4.B.H.hd.S^2/2
    operations; q, k, v read once and o written once."""
    ops = 4.0 * batch * heads * hd * seq * seq / 2
    nbytes = 4.0 * batch * seq * heads * hd * elt
    return ops, nbytes


def scan_cost(batch: int, seq: int, model: dict,
              elt: int = 2) -> Tuple[float, float]:
    """(ops, bytes) of one selective-scan call: ``scan_ops``; dt and x
    (``elt`` bytes), A, B and C (fp32) read once, y and the last state
    (fp32) written once."""
    di, n, _, _ = ssm_sizes(model)
    ops = scan_ops(batch * seq, model)
    nbytes = (2.0 * batch * seq * di * elt + di * n * 4
              + 2.0 * batch * seq * n * 4 + batch * seq * di * 4
              + batch * di * n * 4)
    return ops, nbytes


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time the chip could take: the larger of the operation
    bound at ``peak`` and the byte bound at the HBM bandwidth."""
    return max(ops / peak, nbytes / peaks.HBM_BYTES_S)
