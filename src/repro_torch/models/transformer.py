"""Model assembly for the dense-attention family (the ``("attn",)`` pattern).

Counterpart of ``repro/models/transformer.py``: embed -> L x [rmsnorm ->
GQA attention with RoPE and qk-norm -> rmsnorm -> SwiGLU] -> rmsnorm ->
unembed.  Parameters keep the reference's tree: ``params["reps"]`` is a
1-tuple (one entry per pattern position) whose leaves are stacked on a
leading ``R = num_layers`` axis, so ``bridge.params_from_numpy`` maps the
reference's tree one to one.  The reference's ``lax.scan`` over ``reps``
becomes a Python loop over R.

Two entry points per program phase, as in the reference: :func:`prefill`
(full-sequence forward that builds the decode state) and
:func:`decode_step` (one new token against the cached state); plus
:func:`logits_fn` for smoke-scale full logits.  The reference's MoE aux
outputs do not exist here, so ``forward_hidden`` and ``logits_fn`` return
no aux.  Training (``loss_fn``, activation checkpointing) is ROADMAP queue 1,
item 8; the other block kinds (MoE, Mamba SSM, RG-LRU, whisper's
encoder/cross-attention, qwen2-vl's M-RoPE) are item 7 and raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.attention import KVCache

_ITEM7 = "is not ported yet (ROADMAP queue 1, item 7: other model families)"


# ---------------------------------------------------------------------------
# Runtime options
# ---------------------------------------------------------------------------

class Runtime(NamedTuple):
    """Execution knobs threaded through the stack.

    The reference's fields that only MoE (``production``), training
    (``remat``, ``loss_chunk``) or a device mesh (``seq_shard``) read are
    absent; they return with the ROADMAP items that port those paths.
    """
    use_kernels: bool = False     # hand-written CUDA kernels vs torch ops
    q_block: int = 512            # chunked-attention q/kv block sizes
    kv_block: int = 1024
    kv_quant: bool = False        # int8 KV cache + per-vector scales


DEFAULT_RT = Runtime()


def check_supported(cfg: ModelConfig) -> None:
    """Raise for the configurations this slice of the port cannot run."""
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE ({cfg.name}) {_ITEM7}")
    kinds = sorted(set(cfg.layer_kinds) - {"attn"})
    if kinds:
        raise NotImplementedError(f"block kinds {kinds} ({cfg.name}) {_ITEM7}")
    if cfg.encoder_layers or cfg.cross_attention:
        raise NotImplementedError(
            f"encoder/cross-attention ({cfg.name}) {_ITEM7}")
    if cfg.mrope or cfg.vision_stub:
        raise NotImplementedError(f"M-RoPE / vision stub ({cfg.name}) {_ITEM7}")


# ---------------------------------------------------------------------------
# Stacked-tree helpers (the reference's tree.map over the R axis)
# ---------------------------------------------------------------------------

def _index(tree, r: int):
    """Layer ``r`` of a tree whose leaves are stacked on a leading R axis."""
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(*[None if t is None else t[r] for t in tree])
    return tree[r]


def _stack(trees: List[Any]):
    """Stack identical trees on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, KVCache):
        return KVCache(*[None if first[i] is None
                         else torch.stack([t[i] for t in trees])
                         for i in range(len(first))])
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# One block: norm -> attention -> norm -> ffn, pre-norm residual
# ---------------------------------------------------------------------------

def init_blocks(cfg: ModelConfig, R: int, device,
                generator: torch.Generator) -> Dict[str, Any]:
    """R attention blocks, each parameter stacked on a leading R axis.

    Allocated directly in ``cfg.dtype`` on ``device`` and filled in place,
    so the full-width model never has an fp32 copy.
    """
    dtype = getattr(torch, cfg.dtype)
    lead = (R,)
    params: Dict[str, Any] = {
        "norm1": layers.init_rmsnorm(cfg.d_model, dtype, device, lead),
        "mixer": attention.init_attention(cfg, device, generator, lead=lead),
    }
    if cfg.d_ff > 0:
        params["norm2"] = layers.init_rmsnorm(cfg.d_model, dtype, device, lead)
        params["ffn"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.activation,
                                        dtype, device, generator, lead)
    return params


def block_forward(params, x, positions, cfg: ModelConfig, rt: Runtime, *,
                  causal: bool = True, build_cache: bool = False,
                  cache_window: Optional[int] = None):
    """Full-sequence block. Returns (x, cache_or_None)."""
    k = rt.use_kernels
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps, use_kernel=k)
    mix = attention.full_attention(
        params["mixer"], h, positions, cfg, causal=causal, use_flash=k,
        use_kernels=k, q_block=rt.q_block, kv_block=rt.kv_block)
    cache = None
    if build_cache:
        cache = {"self": attention.prefill_cache(
            params["mixer"], h, positions, cfg, window_override=cache_window,
            quant=rt.kv_quant, use_kernels=k)}
    x = x + mix
    if "ffn" in params:
        h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps, use_kernel=k)
        x = x + layers.mlp(params["ffn"], h, cfg.activation)
    return x, cache


def block_decode(params, state, x_new, pos, cfg: ModelConfig, rt: Runtime,
                 rope_pos=None):
    """One-token block step. x_new: (B,1,D). Returns (x, new_state)."""
    k = rt.use_kernels
    h = layers.rmsnorm(params["norm1"], x_new, cfg.norm_eps, use_kernel=k)
    mix, new_self = attention.decode_attention(
        params["mixer"], state["self"], h, pos, cfg, rope_pos=rope_pos,
        use_kernels=k)
    x = x_new + mix
    if "ffn" in params:
        h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps, use_kernel=k)
        x = x + layers.mlp(params["ffn"], h, cfg.activation)
    return x, {"self": new_self}


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    """Random parameters from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(cfg.vocab_size, cfg.d_model, dtype,
                                       cfg.tie_embeddings, dev, generator),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if cfg.num_layers > 0:
        params["reps"] = (init_blocks(cfg, cfg.num_layers, dev, generator),)
    return params


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(count_params(v) for v in params)
    return int(params.numel())


# ---------------------------------------------------------------------------
# Full-sequence forward (shared by logits / prefill)
# ---------------------------------------------------------------------------

def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """-> (x (B,S,D), positions (B,S))."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return x, positions


def forward_hidden(params, x, positions, cfg: ModelConfig, rt: Runtime,
                   build_cache: bool = False,
                   cache_window: Optional[int] = None):
    """Runs the decoder stack. Returns (hidden, caches_rep_or_None)."""
    check_supported(cfg)
    caches = []
    if "reps" in params:
        (blocks,) = params["reps"]
        for r in range(blocks["norm1"]["scale"].shape[0]):
            x, c = block_forward(_index(blocks, r), x, positions, cfg, rt,
                                 causal=True, build_cache=build_cache,
                                 cache_window=cache_window)
            caches.append(c)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                       use_kernel=rt.use_kernels)
    return x, ((_stack(caches),) if build_cache and caches else None)


def logits_fn(params, batch, cfg: ModelConfig, rt: Runtime = DEFAULT_RT):
    """Full (B,S,V) logits — smoke-test scale only."""
    x, positions = embed_inputs(params, batch, cfg)
    x, _ = forward_hidden(params, x, positions, cfg, rt)
    return layers.unembed(params["embed"], x, cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# Decode state: prefill + one-token step
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    pos: torch.Tensor          # (B,) next absolute position
    rope_offset: torch.Tensor  # (B,) rope_pos = pos + offset (M-RoPE)
    reps: Any                  # tuple per pattern position, stacked (R, B, ...)
    rest: Any                  # tuple per remainder layer (empty here)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      kv_quant: bool = False, device="cuda") -> DecodeState:
    """Zero-initialized state sized for a seq_len-token context window."""
    check_supported(cfg)
    dev = resolve_device(device)
    reps = ()
    if cfg.num_layers:
        reps = ({"self": attention.init_cache(
            cfg, batch, seq_len, num_layers=cfg.num_layers, quant=kv_quant,
            device=dev)},)
    zeros = torch.zeros((batch,), dtype=torch.long, device=dev)
    return DecodeState(pos=zeros, rope_offset=zeros.clone(), reps=reps,
                       rest=())


def prefill(params, batch, cfg: ModelConfig, rt: Runtime = DEFAULT_RT,
            window: Optional[int] = None):
    """Full-sequence forward that also builds the decode state.

    Returns (last_logits (B, V), DecodeState).  ``window`` sets the decode
    horizon (cache length); defaults to the prompt length.
    """
    x, positions = embed_inputs(params, batch, cfg)
    x, caches_rep = forward_hidden(params, x, positions, cfg, rt,
                                   build_cache=True, cache_window=window)
    logits = layers.unembed(params["embed"], x[:, -1:],
                            cfg.tie_embeddings)[:, 0]
    B, S = batch["tokens"].shape
    dev = x.device
    return logits, DecodeState(
        pos=torch.full((B,), S, dtype=torch.long, device=dev),
        rope_offset=torch.zeros((B,), dtype=torch.long, device=dev),
        reps=caches_rep or (), rest=())


def decode_step(params, state: DecodeState, new_tokens: torch.Tensor,
                cfg: ModelConfig, rt: Runtime = DEFAULT_RT):
    """new_tokens: (B, 1) int -> (logits (B, V), new DecodeState).

    The KV caches in ``state`` are updated in place and carried into the
    returned state (see ``attention``); ``state`` itself must not be
    decoded from again.
    """
    check_supported(cfg)
    pos = state.pos
    rope_pos = pos + state.rope_offset
    x = layers.embed(params["embed"], new_tokens)            # (B,1,D)
    if state.reps:
        (blocks,) = params["reps"]
        (states,) = state.reps
        for r in range(blocks["norm1"]["scale"].shape[0]):
            x, _ = block_decode(_index(blocks, r), _index(states, r), x, pos,
                                cfg, rt, rope_pos=rope_pos)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                       use_kernel=rt.use_kernels)
    logits = layers.unembed(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, DecodeState(pos=pos + 1, rope_offset=state.rope_offset,
                               reps=state.reps, rest=())
