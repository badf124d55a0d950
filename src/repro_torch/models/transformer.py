"""Model assembly: the dense, Mamba-SSM and RG-LRU hybrid stacks.

Counterpart of ``repro/models/transformer.py``.  The layer sequence is
``R`` repetitions of the arch's block pattern (``("attn",)`` for dense,
``("ssm",)`` for falcon-mamba, ``("rglru", "rglru", "attn")`` for
recurrentgemma) plus ``L mod len(pattern)`` remainder layers.  Parameters
keep the reference's tree: ``params["reps"]`` is a tuple with one entry per
pattern position whose leaves are stacked on a leading R axis, and
``params["rest"]`` a tuple of unstacked remainder blocks, so
``bridge.params_from_numpy`` maps the reference's tree one to one.  The
reference's ``lax.scan`` over ``reps`` becomes a Python loop over R.

Two entry points per program phase, as in the reference: :func:`prefill`
(full-sequence forward that builds the decode state) and
:func:`decode_step` (one new token against the cached state); plus
:func:`logits_fn` for smoke-scale full logits.  The reference's MoE aux
outputs do not exist here, so ``forward_hidden`` and ``logits_fn`` return
no aux.  Training (``loss_fn``, activation checkpointing) is ROADMAP queue 1,
item 8; MoE, whisper's encoder/cross-attention and qwen2-vl's M-RoPE are
item 7 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, rglru, ssm

_ITEM7 = "is not ported yet (ROADMAP queue 1, item 7: other model families)"
BLOCK_KINDS = ("attn", "ssm", "rglru")


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
    """Raise for the configurations this port cannot run yet."""
    if cfg.moe is not None:
        raise NotImplementedError(f"MoE ({cfg.name}) {_ITEM7}")
    kinds = sorted(set(cfg.layer_kinds) - set(BLOCK_KINDS))
    if kinds:
        raise NotImplementedError(f"block kinds {kinds} ({cfg.name}) {_ITEM7}")
    if cfg.encoder_layers or cfg.cross_attention:
        raise NotImplementedError(
            f"encoder/cross-attention ({cfg.name}) {_ITEM7}")
    if cfg.mrope or cfg.vision_stub:
        raise NotImplementedError(f"M-RoPE / vision stub ({cfg.name}) {_ITEM7}")


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.block_pattern is not None:
        return tuple(cfg.block_pattern)
    return ("ssm",) if cfg.family == "ssm" else ("attn",)


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return kind != "ssm" and (cfg.moe is not None or cfg.d_ff > 0)


# ---------------------------------------------------------------------------
# Stacked-tree helpers (the reference's tree.map over the R axis)
# ---------------------------------------------------------------------------

def _rebuild(like, items):
    """A tuple like ``like`` (a NamedTuple state or a plain tuple)."""
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _index(tree, r: int):
    """Layer ``r`` of a tree whose leaves are stacked on a leading R axis.

    A NamedTuple state (``KVCache``, ``SSMState``, ``RGLRUState``) is a node,
    indexed field by field; ``None`` fields stay ``None``.
    """
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return _rebuild(tree, [_index(t, r) for t in tree])
    return tree[r]


def _stack(trees: List[Any]):
    """Stack identical trees on a new leading axis."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return _rebuild(first, [_stack([t[i] for t in trees])
                                for i in range(len(first))])
    return torch.stack(trees)


def _write_(dst, src) -> None:
    """In place: copy tree ``src`` into the same-shaped views ``dst``
    (a tensor that already is its destination is left as it is)."""
    if isinstance(dst, dict):
        for k in dst:
            _write_(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            _write_(d, s_)
    elif dst is not None and dst is not src:
        dst.copy_(src)


def _depth(blocks) -> int:
    """R, the leading axis of a stacked block's parameters."""
    return blocks["norm1"]["scale"].shape[0]


# ---------------------------------------------------------------------------
# One block: norm -> attention -> norm -> ffn, pre-norm residual
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, kind: str, device,
               generator: torch.Generator, lead=()) -> Dict[str, Any]:
    """One block of ``kind``, each parameter stacked on ``lead``.

    Allocated directly in ``cfg.dtype`` on ``device`` (fp32 only where the
    reference keeps fp32) and filled in place, so the full-width model
    never has an fp32 copy.
    """
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "norm1": layers.init_rmsnorm(cfg.d_model, dtype, device, lead)}
    if kind == "attn":
        params["mixer"] = attention.init_attention(cfg, device, generator,
                                                   lead=lead)
    elif kind == "ssm":
        params["mixer"] = ssm.init_ssm(cfg, device, generator, lead)
    elif kind == "rglru":
        params["mixer"] = rglru.init_rglru(cfg, device, generator, lead)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if _has_ffn(cfg, kind):
        params["norm2"] = layers.init_rmsnorm(cfg.d_model, dtype, device, lead)
        params["ffn"] = layers.init_mlp(cfg.d_model, cfg.d_ff, cfg.activation,
                                        dtype, device, generator, lead)
    return params


def block_forward(params, x, positions, cfg: ModelConfig, kind: str,
                  rt: Runtime, *, causal: bool = True,
                  build_cache: bool = False,
                  cache_window: Optional[int] = None):
    """Full-sequence block. Returns (x, cache_or_None)."""
    k = rt.use_kernels
    h = layers.rmsnorm(params["norm1"], x, cfg.norm_eps, use_kernel=k)
    cache = None
    if kind == "attn":
        mix = attention.full_attention(
            params["mixer"], h, positions, cfg, causal=causal, use_flash=k,
            use_kernels=k, q_block=rt.q_block, kv_block=rt.kv_block)
        if build_cache:
            cache = {"self": attention.prefill_cache(
                params["mixer"], h, positions, cfg,
                window_override=cache_window, quant=rt.kv_quant,
                use_kernels=k)}
    else:
        fwd = ssm.ssm_forward if kind == "ssm" else rglru.rglru_forward
        mix = fwd(params["mixer"], h, cfg, use_kernel=k,
                  return_state=build_cache)
        if build_cache:
            mix, st = mix
            cache = {"self": st}
    x = x + mix
    if "ffn" in params:
        h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps, use_kernel=k)
        x = x + layers.mlp(params["ffn"], h, cfg.activation)
    return x, cache


def block_decode(params, state, x_new, pos, cfg: ModelConfig, kind: str,
                 rt: Runtime, rope_pos=None):
    """One-token block step. x_new: (B,1,D). Returns (x, new_state)."""
    k = rt.use_kernels
    h = layers.rmsnorm(params["norm1"], x_new, cfg.norm_eps, use_kernel=k)
    if kind == "attn":
        mix, new_self = attention.decode_attention(
            params["mixer"], state["self"], h, pos, cfg, rope_pos=rope_pos,
            use_kernels=k)
    elif kind == "ssm":
        mix, new_self = ssm.ssm_step(params["mixer"], state["self"], h, cfg)
    else:
        mix, new_self = rglru.rglru_step(params["mixer"], state["self"], h,
                                         cfg)
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
    pattern = _pattern(cfg)
    R, rem = divmod(cfg.num_layers, len(pattern))
    if R > 0:
        params["reps"] = tuple(init_block(cfg, kind, dev, generator, (R,))
                               for kind in pattern)
    if rem:
        params["rest"] = tuple(init_block(cfg, pattern[j], dev, generator)
                               for j in range(rem))
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
    """Runs the decoder stack. Returns (hidden, (caches_rep, caches_rest)).

    Each cache part is ``None`` unless ``build_cache``; ``caches_rep`` has
    one entry per pattern position, stacked on R.
    """
    check_supported(cfg)
    pattern = _pattern(cfg)
    caches_rep, caches_rest = None, None

    def one(p, x, kind):
        return block_forward(p, x, positions, cfg, kind, rt, causal=True,
                             build_cache=build_cache,
                             cache_window=cache_window)

    if "reps" in params:
        per_kind: List[List[Any]] = [[] for _ in pattern]
        for r in range(_depth(params["reps"][0])):
            for i, kind in enumerate(pattern):
                x, c = one(_index(params["reps"][i], r), x, kind)
                per_kind[i].append(c)
        if build_cache:
            caches_rep = tuple(_stack(cs) for cs in per_kind)
    if "rest" in params:
        caches = []
        for j, p in enumerate(params["rest"]):
            x, c = one(p, x, pattern[j % len(pattern)])
            caches.append(c)
        if build_cache:
            caches_rest = tuple(caches)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                       use_kernel=rt.use_kernels)
    return x, (caches_rep, caches_rest)


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
    rest: Any                  # tuple per remainder layer, (B, ...)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      kv_quant: bool = False, device="cuda") -> DecodeState:
    """Zero-initialized state sized for a seq_len-token context window.

    Attention caches hold ``min(seq_len, attn_window)`` slots; SSM and
    RG-LRU states are fixed-size.
    """
    check_supported(cfg)
    dev = resolve_device(device)
    pattern = _pattern(cfg)
    R, rem = divmod(cfg.num_layers, len(pattern))

    def one(kind, lead):
        if kind == "attn":
            return {"self": attention.init_cache(
                cfg, batch, seq_len, num_layers=lead[0] if lead else None,
                quant=kv_quant, device=dev)}
        if kind == "ssm":
            return {"self": ssm.init_ssm_state(cfg, batch, dev, lead)}
        return {"self": rglru.init_rglru_state(cfg, batch, dev, lead)}

    reps = tuple(one(kind, (R,)) for kind in pattern) if R else ()
    rest = tuple(one(pattern[j], ()) for j in range(rem))
    zeros = torch.zeros((batch,), dtype=torch.long, device=dev)
    return DecodeState(pos=zeros, rope_offset=zeros.clone(), reps=reps,
                       rest=rest)


def prefill(params, batch, cfg: ModelConfig, rt: Runtime = DEFAULT_RT,
            window: Optional[int] = None):
    """Full-sequence forward that also builds the decode state.

    Returns (last_logits (B, V), DecodeState).  ``window`` sets the decode
    horizon (cache length); defaults to the prompt length.
    """
    x, positions = embed_inputs(params, batch, cfg)
    x, (caches_rep, caches_rest) = forward_hidden(
        params, x, positions, cfg, rt, build_cache=True, cache_window=window)
    logits = layers.unembed(params["embed"], x[:, -1:],
                            cfg.tie_embeddings)[:, 0]
    B, S = batch["tokens"].shape
    dev = x.device
    return logits, DecodeState(
        pos=torch.full((B,), S, dtype=torch.long, device=dev),
        rope_offset=torch.zeros((B,), dtype=torch.long, device=dev),
        reps=caches_rep or (), rest=caches_rest or ())


def decode_step(params, state: DecodeState, new_tokens: torch.Tensor,
                cfg: ModelConfig, rt: Runtime = DEFAULT_RT):
    """new_tokens: (B, 1) int -> (logits (B, V), new DecodeState).

    The layer states in ``state.reps`` are updated in place and carried
    into the returned state (attention writes its KV slot in place, see
    ``attention``; the recurrent states are copied into their layer's
    rows), so ``state`` itself must not be decoded from again.
    """
    check_supported(cfg)
    pattern = _pattern(cfg)
    pos = state.pos
    rope_pos = pos + state.rope_offset
    x = layers.embed(params["embed"], new_tokens)            # (B,1,D)
    if state.reps:
        for r in range(_depth(params["reps"][0])):
            for i, kind in enumerate(pattern):
                st = _index(state.reps[i], r)
                x, new = block_decode(_index(params["reps"][i], r), st, x,
                                      pos, cfg, kind, rt, rope_pos=rope_pos)
                _write_(st, new)
    new_rest = []
    for j, p in enumerate(params.get("rest", ())):
        x, new = block_decode(p, state.rest[j], x, pos, cfg,
                              pattern[j % len(pattern)], rt,
                              rope_pos=rope_pos)
        new_rest.append(new)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps,
                       use_kernel=rt.use_kernels)
    logits = layers.unembed(params["embed"], x, cfg.tie_embeddings)[:, 0]
    return logits, DecodeState(pos=pos + 1, rope_offset=state.rope_offset,
                               reps=state.reps, rest=tuple(new_rest))
