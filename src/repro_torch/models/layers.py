"""Shared layer primitives: norms, MLPs, RoPE / M-RoPE, embeddings.

Counterpart of ``repro/models/layers.py``.  Parameters are plain dicts of
tensors with the reference's keys.  The reference also returns sharding
specs from every ``init_*``; the port has no mesh yet, so ``init_*``
returns the params alone.  ``rmsnorm`` and ``rmsnorm_headwise`` go
through the hand-written kernel (``kernels.ops.rmsnorm``) when
``use_kernel`` is set; the function is the same either way.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.rmsnorm import rmsnorm_plain


def truncated_normal_(t: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """In place: stddev * N(0, 1) truncated to [-2, 2], in t's own dtype."""
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return t.mul_(stddev)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, dtype, device, lead=()) -> dict:
    return {"scale": torch.ones(tuple(lead) + (dim,), dtype=dtype,
                                device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6,
            use_kernel: bool = False) -> torch.Tensor:
    if use_kernel:
        return kernel_ops.rmsnorm(x, params["scale"], eps)
    return rmsnorm_plain(x, params["scale"], eps)


def rmsnorm_headwise(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
                     use_kernel: bool = False) -> torch.Tensor:
    """QK-norm: normalize the trailing head_dim of (..., H, hd)."""
    if use_kernel:
        return kernel_ops.rmsnorm(x, scale, eps)
    return rmsnorm_plain(x, scale, eps)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(d_model: int, d_ff: int, activation: str, dtype, device,
             generator: torch.Generator, lead=()) -> dict:
    """Gated (swiglu) or 2-matrix (relu2 / gelu) MLP, stacked over ``lead``."""
    std_in = 1.0 / math.sqrt(d_model)
    std_out = 1.0 / math.sqrt(d_ff)
    lead = tuple(lead)

    def w(shape, std):
        return truncated_normal_(torch.empty(lead + shape, dtype=dtype,
                                             device=device), std, generator)

    params = {}
    if activation == "swiglu":
        params["wi_gate"] = w((d_model, d_ff), std_in)
    params["wi_up"] = w((d_model, d_ff), std_in)
    params["wo"] = w((d_ff, d_model), std_out)
    return params


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = x @ params["wi_up"]
    if activation == "swiglu":
        gate = x @ params["wi_gate"]
        h = F.silu(gate) * up
    elif activation == "relu2":
        h = torch.square(F.relu(up))
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # (hd/2,)
    ang = positions.float()[..., None] * freqs                   # (B, S, hd/2)
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Sequence[int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions: (B, 3, S)."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang_all = positions.float()[..., None] * freqs               # (B, 3, S, half)
    parts, start = [], 0
    for comp, sec in enumerate(sections):
        parts.append(ang_all[:, comp, :, start:start + sec])
        start += sec
    return _rotate(x, torch.cat(parts, dim=-1))


def sinusoidal_positions(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embedding, (S, D)."""
    half = d_model // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / (half - 1))
    pos = torch.arange(seq_len, dtype=torch.float32,
                       device=device)[:, None] * freq[None, :]
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embedding(vocab: int, d_model: int, dtype, tie: bool, device,
                   generator: torch.Generator) -> dict:
    params = {"table": truncated_normal_(
        torch.empty((vocab, d_model), dtype=dtype, device=device), 1.0,
        generator)}
    if not tie:
        params["out"] = truncated_normal_(
            torch.empty((d_model, vocab), dtype=dtype, device=device),
            1.0 / math.sqrt(d_model), generator)
    return params


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: dict, x: torch.Tensor, tie: bool) -> torch.Tensor:
    if tie:
        return x @ params["table"].T.to(x.dtype)
    return x @ params["out"]


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal LM cross-entropy with fp32 accumulation."""
    targets = tokens[:, 1:]
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    picked = torch.gather(lg, -1, targets[..., None].long())[..., 0]
    nll = logz - picked
    if mask is not None:
        m = mask[:, 1:].float()
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)
