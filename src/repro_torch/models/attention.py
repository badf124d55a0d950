"""Attention: GQA/MQA, causal / sliding-window / bidirectional, cross-attn,
and the one-token decode step.

Counterpart of ``repro/models/attention.py``.  Two full-sequence paths:

  * ``chunked_attention`` — torch blockwise online softmax (the plain path,
    same blocks and masks as the reference's double ``lax.scan``).
  * ``kernels.ops.flash_attention`` — the hand-written CUDA kernel, taken
    with ``use_flash=True`` (prefill under ``Runtime.use_kernels``).

Under ``Runtime.kv_quant`` every K/V vector written into the cache, at
prefill and at each decode step, is quantized to int8 by
``kernels.ops.quantize_int8`` when ``use_kernels`` is on (the reference
computes the same function inline in jnp).

``decode_attention`` scores one new token against the ring-buffer KV cache
in torch ops (the reference has no Pallas kernel there).  The reference's
``shard_map`` sequence-parallel decode is not ported yet (ROADMAP queue 1,
item 9).  Unlike the reference, decode writes the new K/V into the cache
in place: a functional copy of every layer's cache per token would move
the whole cache through memory once per step for nothing.

KV caches are ring buffers: slot ``i`` holds absolute position
``p_i = pos - ((pos - i) mod W)`` (valid iff ``p_i >= 0``), which
degenerates to the identity layout when ``W >= seq``.  RoPE is applied at
write time so cached keys never need re-rotation.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.quantize import quantize_int8_plain
from repro_torch.models import layers

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, device, generator: torch.Generator,
                   cross: bool = False, lead=()) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    q_dim, kv_dim = cfg.num_heads * hd, cfg.num_kv_heads * hd
    std = 1.0 / math.sqrt(d)
    dtype = getattr(torch, cfg.dtype)
    lead = tuple(lead)

    def w(shape, s):
        return layers.truncated_normal_(
            torch.empty(lead + shape, dtype=dtype, device=device), s,
            generator)

    params = {
        "wq": w((d, q_dim), std),
        "wk": w((d, kv_dim), std),
        "wv": w((d, kv_dim), std),
        "wo": w((q_dim, d), 1.0 / math.sqrt(q_dim)),
    }
    if cfg.qk_norm and not cross:
        params["q_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
        params["k_norm"] = torch.ones(lead + (hd,), dtype=dtype, device=device)
    return params


def _project_qkv(params, x, cfg: ModelConfig, positions, kv_source=None,
                 apply_positions=True, use_kernels: bool = False):
    """Returns q (B,S,H,hd), k/v (B,Skv,KV,hd) with norm+rope applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    src = x if kv_source is None else kv_source
    q = (x @ params["wq"]).reshape(B, S, cfg.num_heads, hd)
    k = (src @ params["wk"]).reshape(B, src.shape[1], cfg.num_kv_heads, hd)
    v = (src @ params["wv"]).reshape(B, src.shape[1], cfg.num_kv_heads, hd)
    if cfg.qk_norm and "q_norm" in params:
        q = layers.rmsnorm_headwise(params["q_norm"], q, cfg.norm_eps,
                                    use_kernel=use_kernels)
        k = layers.rmsnorm_headwise(params["k_norm"], k, cfg.norm_eps,
                                    use_kernel=use_kernels)
    if apply_positions and positions is not None:
        if cfg.mrope:
            q = layers.apply_mrope(q, positions, cfg.rope_theta,
                                   cfg.mrope_sections)
            k = layers.apply_mrope(k, positions, cfg.rope_theta,
                                   cfg.mrope_sections)
        else:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Blockwise online-softmax attention (full-sequence: train / prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: Optional[int] = None,
                      q_block: int = 512, kv_block: int = 512) -> torch.Tensor:
    """q: (B,S,H,hd); k, v: (B,Skv,KV,hd) -> (B,S,H,hd).

    Loops over q- and kv-blocks with a running (m, l, o) accumulator, as
    the reference's double scan does; memory is O(q_block * kv_block) per
    head.  Scores and P@V accumulate in fp32 (the reference's
    ``preferred_element_type``); P is cast to v's type first, as there.
    """
    B, S, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qb = min(q_block, S)
    kb = min(kv_block, Skv)
    nq = -(-S // qb)
    nk = -(-Skv // kb)
    dev = q.device

    qr = (q * scale).reshape(B, S, KV, G, hd)
    outs = []
    for qi in range(nq):
        q_lo = qi * qb
        qblk = qr[:, q_lo:q_lo + qb].float()
        n_q = qblk.shape[1]
        qpos = q_lo + torch.arange(qb, device=dev)[:n_q]
        m = torch.full((B, n_q, KV, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, n_q, KV, G), dtype=torch.float32, device=dev)
        o = torch.zeros((B, n_q, KV, G, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_lo = ki * kb
            kblk = k[:, k_lo:k_lo + kb]
            vblk = v[:, k_lo:k_lo + kb]
            kpos = k_lo + torch.arange(kblk.shape[1], device=dev)
            s = torch.einsum("bqkgh,bskh->bqkgs", qblk, kblk.float())
            mask = torch.ones((n_q, kblk.shape[1]), dtype=torch.bool,
                              device=dev)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask[None, :, None, None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqkgs,bskh->bqkgh", p.to(vblk.dtype).float(),
                              vblk.float())
            o = o * corr[..., None] + pv
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, S, H, hd)
    return out.to(q.dtype)


def full_attention(params, x, positions, cfg: ModelConfig, *,
                   causal: bool = True, encoder_out=None,
                   use_flash: bool = False, use_kernels: bool = False,
                   q_block: int = 512, kv_block: int = 512) -> torch.Tensor:
    """Self- or cross-attention over a full sequence.  Returns (B,S,D).

    ``use_flash`` takes the CUDA flash kernel and, like the reference,
    ignores ``q_block``/``kv_block`` (the kernel has its own tiles);
    ``use_kernels`` routes the qk-norm through the rmsnorm kernel.
    """
    cross = encoder_out is not None
    q, k, v = _project_qkv(params, x, cfg, None if cross else positions,
                           kv_source=encoder_out, use_kernels=use_kernels)
    window = None if cross else cfg.attn_window
    if use_flash:
        out = kernel_ops.flash_attention(q, k, v, causal=causal and not cross,
                                         window=window)
    else:
        out = chunked_attention(q, k, v, causal=causal and not cross,
                                window=window, q_block=q_block,
                                kv_block=kv_block)
    out = out.reshape(x.shape[0], x.shape[1], -1)
    return out @ params["wo"]


# ---------------------------------------------------------------------------
# Decode: one token against a ring-buffer KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, W, KV, hd) — storage dtype (bf16 or int8)
    v: torch.Tensor       # (B, W, KV, hd)
    k_scale: Any = None   # (B, W, KV, 1) f32 when int8-quantized
    v_scale: Any = None


def _quantize_kv(x: torch.Tensor, use_kernels: bool = False):
    """(.., hd) -> int8 payload + per-vector f32 scale.

    The floor is 1e-8, as in the reference's ``_quantize_kv`` (not the
    int8 kernel's 1e-12).  ``use_kernels`` quantizes the vectors as rows
    through ``kernel_ops.quantize_int8`` (the CUDA kernel on a CUDA
    tensor), which computes the same bits as the plain version.
    """
    if not use_kernels:
        return quantize_int8_plain(x, floor=1e-8)
    q, scale = kernel_ops.quantize_int8(x.reshape(-1, x.shape[-1]),
                                        floor=1e-8)
    return q.reshape(x.shape), scale.reshape(x.shape[:-1] + (1,))


def _dequantize_kv(q: torch.Tensor, scale, dtype=torch.float32) -> torch.Tensor:
    if scale is None:
        return q.to(dtype)
    return (q.float() * scale).to(dtype)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               num_layers: Optional[int] = None, quant: bool = False,
               device="cuda") -> KVCache:
    W = min(seq_len, cfg.attn_window) if cfg.attn_window else seq_len
    hd = cfg.resolved_head_dim
    shape = (batch, W, cfg.num_kv_heads, hd)
    if num_layers is not None:
        shape = (num_layers,) + shape
    if quant:
        z = torch.zeros(shape, dtype=torch.int8, device=device)
        s = torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)
        return KVCache(k=z, v=z.clone(), k_scale=s, v_scale=s.clone())
    z = torch.zeros(shape, dtype=getattr(torch, cfg.dtype), device=device)
    return KVCache(k=z, v=z.clone())


def _ring_valid(pos: torch.Tensor, W: int, slots: torch.Tensor) -> torch.Tensor:
    """Which ring slots hold a live position for each batch element.

    pos: (B,) current absolute position; slots: (S_loc,) slot indices.
    """
    p = pos[:, None] - torch.remainder(pos[:, None] - slots[None, :], W)
    return p >= 0


def _write_slot_(buf, new_val, bidx, clamped, in_range) -> None:
    """In place: buf[b, clamped[b]] = new_val[b] where in_range[b]."""
    cur = buf[bidx, clamped]
    keep = in_range.reshape((-1,) + (1,) * (cur.dim() - 1))
    buf[bidx, clamped] = torch.where(keep, new_val.to(buf.dtype), cur)


def _decode_core(q, cache: KVCache, new_k, new_v, pos, *, W, offset,
                 s_loc, update, use_kernels: bool = False):
    """Scores one token against the cache; writes its K/V into the cache.

    q: (B,1,H,hd) -> internally (B,KV,G,hd); cache arrays: (B,s_loc,KV,*).
    Handles both bf16 and int8-quantized (k_scale/v_scale) caches.
    """
    B, _, H, hd = q.shape
    k_cache, v_cache = cache.k, cache.v
    ks, vs = cache.k_scale, cache.v_scale
    quant = ks is not None
    KV = k_cache.shape[2]
    G = H // KV
    dev = q.device
    slots = offset + torch.arange(s_loc, device=dev)

    if update:
        write_slot = torch.remainder(pos, W) - offset
        in_range = (write_slot >= 0) & (write_slot < s_loc)
        clamped = torch.clamp(write_slot, 0, s_loc - 1)
        bidx = torch.arange(B, device=dev)
        if quant:
            nk_q, nk_s = _quantize_kv(new_k[:, 0], use_kernels)
            nv_q, nv_s = _quantize_kv(new_v[:, 0], use_kernels)
            _write_slot_(k_cache, nk_q, bidx, clamped, in_range)
            _write_slot_(v_cache, nv_q, bidx, clamped, in_range)
            _write_slot_(ks, nk_s, bidx, clamped, in_range)
            _write_slot_(vs, nv_s, bidx, clamped, in_range)
        else:
            _write_slot_(k_cache, new_k[:, 0], bidx, clamped, in_range)
            _write_slot_(v_cache, new_v[:, 0], bidx, clamped, in_range)

    valid = _ring_valid(pos, W, slots)                       # (B, s_loc)
    kf = _dequantize_kv(k_cache, ks) if quant else k_cache
    vf = _dequantize_kv(v_cache, vs) if quant else v_cache
    qg = q.reshape(B, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), kf.float())
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # (B,KV,G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(vf.dtype).float(), vf.float())
    out = (o / torch.clamp(l, min=1e-30)[..., None]).reshape(B, 1, H, hd)
    return out.to(q.dtype), KVCache(k=k_cache, v=v_cache, k_scale=ks,
                                    v_scale=vs)


def decode_attention(params, cache: KVCache, x_new: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     update: bool = True, cross: bool = False,
                     rope_pos: Optional[torch.Tensor] = None,
                     use_kernels: bool = False
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention step.

    x_new: (B, 1, D); pos: (B,) absolute position of the new token (drives
    the ring-slot layout); rope_pos overrides the RoPE angle position when
    it differs from the ring position (M-RoPE vision offset).
    """
    B = x_new.shape[0]
    W = cache.k.shape[1]
    rp = pos if rope_pos is None else rope_pos
    if cross or not cfg.uses_rope:
        positions = None
    elif cfg.mrope:
        positions = rp[:, None, None].expand(B, 3, 1)
    else:
        positions = rp[:, None]
    q, new_k, new_v = _project_qkv(params, x_new, cfg, positions,
                                   use_kernels=use_kernels)
    out, new_cache = _decode_core(q, cache, new_k, new_v, pos, W=W, offset=0,
                                  s_loc=W, update=update,
                                  use_kernels=use_kernels)
    out = out.reshape(B, 1, -1) @ params["wo"]
    return out, new_cache


def build_cross_cache(params, encoder_out: torch.Tensor,
                      cfg: ModelConfig) -> KVCache:
    """Static decode-time KV cache over the encoder output (no RoPE)."""
    _, k, v = _project_qkv(params, encoder_out, cfg, None,
                           apply_positions=False)
    return KVCache(k=k, v=v)


def prefill_cache(params, x, positions, cfg: ModelConfig,
                  window_override: Optional[int] = None,
                  quant: bool = False, use_kernels: bool = False) -> KVCache:
    """Build the decode-layout cache from a full prefill pass."""
    _, k, v = _project_qkv(params, x, cfg, positions, use_kernels=use_kernels)
    W = window_override or (min(x.shape[1], cfg.attn_window)
                            if cfg.attn_window else x.shape[1])
    if cfg.attn_window:
        W = min(W, cfg.attn_window)
    S = x.shape[1]
    if S > W:
        k, v = k[:, -W:], v[:, -W:]
        # ring layout: slot = p mod W; the tail slice starts at position S-W,
        # which lands on slot (S-W) mod W — roll so slots line up.
        shift = (S - W) % W
        k = torch.roll(k, shift, dims=1)
        v = torch.roll(v, shift, dims=1)
    elif S < W:
        # identity layout; tail slots are unwritten (invalid until pos wraps)
        pad = (0, 0, 0, 0, 0, W - S)
        k, v = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    if quant:
        kq, ksc = _quantize_kv(k, use_kernels)
        vq, vsc = _quantize_kv(v, use_kernels)
        return KVCache(k=kq, v=vq, k_scale=ksc, v_scale=vsc)
    return KVCache(k=k.contiguous(), v=v.contiguous())
