"""Attention: GQA/MQA, causal / sliding-window / bidirectional, cross-attn,
and the one-token decode step.

Counterpart of ``repro/models/attention.py``.  Two full-sequence paths:

  * ``chunked_attention`` — torch blockwise online softmax (the plain path,
    same blocks and masks as the reference's double ``lax.scan``).
  * ``kernels.ops.flash_attention`` — the hand-written CUDA kernel, taken
    with ``use_flash=True`` (prefill under ``Runtime.use_kernels``).

Under ``Runtime.kv_quant`` every K/V vector written into the cache, at
prefill and at each decode step, is quantized to int8 by one of two
stores: ``quantize_kv_prefill`` builds the prefill ring and
``quantize_kv_store_`` writes a decode step's K and V into their slot.
With ``use_kernels`` on they are ``kernels.ops``'s, one launch of the
quantize kernel a layer; off, their plain versions in
``kernels.quantize`` (the reference computes the same function inline in
jnp).

``decode_attention`` scores one new token against the ring-buffer KV cache
in torch ops (the reference has no Pallas kernel there).  Under a mesh the
ring is sequence-sharded over 'model' (a ``DTensor`` over the model axis,
``prefill_cache`` builds it so): each model rank holds ``W // n_model``
slots at offset ``rank * W // n_model``, scores its own slots, and the
partial softmaxes merge by log-sum-exp (an all-reduce MAX of the running
max, an all-reduce SUM of the sums and outputs), so KV never leaves its
shard.  Unlike the reference, decode writes the new K/V into the cache in
place (the int8 store by offset, on each shard): a functional copy of every
layer's cache per token would move the whole cache through memory once per
step for nothing.

Under tensor parallelism (``tp``, the serving path under a mesh with
model ranks) the projections take this rank's 'model' shards of the
weights: q on the rank's ``H / n`` heads, k / v on its KV heads where
their spec splits them or on every KV head where it replicates them (the
rank's q heads then read the run of them their GQA groups use; decode
projects its column chunk of them instead); ``wo`` is row-parallel and
the partial sums add over 'model'.  The prefill cache and the decode core
take every KV head and q whole, as the reference's ring and ``shard_map``
do, so the rank's heads are all-gathered over 'model' first.  Whisper's
cross-attention takes the same path with k / v projected from the encoder
output; its decode cache (``build_cross_cache``) is laid out over 'model'
by encoder position like a ring, and its decode step projects q alone.

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
from repro_torch.kernels import quantize as QZ
from repro_torch.models import layers
from repro_torch.parallel import collectives, shardctx
from repro_torch.parallel.shardctx import P

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


def attention_pspecs(cfg: ModelConfig, cross: bool = False) -> dict:
    """The reference's specs: kv projections are sharded over "model"
    only when the kv-head count is mesh-divisible (a multiple of 4);
    MQA/GQA with few heads replicates them (cheap)."""
    kv = P("data", None) if cfg.num_kv_heads % 4 else P("data", "model")
    specs = {"wq": P("data", "model"), "wk": kv, "wv": kv,
             "wo": P("model", "data")}
    if cfg.qk_norm and not cross:
        specs["q_norm"] = P(None)
        specs["k_norm"] = P(None)
    return specs


def _project_qkv(params, x, cfg: ModelConfig, positions, kv_source=None,
                 apply_positions=True, use_kernels: bool = False):
    """Returns q (B,S,H,hd), k/v (B,Skv,KV,hd) with norm+rope applied (H and
    KV this rank's heads when the weights are its 'model' shards)."""
    src = x if kv_source is None else kv_source
    q, k, v = (x @ params["wq"], src @ params["wk"], src @ params["wv"])
    return _heads(params, q, k, v, cfg, positions, apply_positions,
                  use_kernels)


def _heads(params, q, k, v, cfg: ModelConfig, positions,
           apply_positions=True, use_kernels: bool = False):
    """Projections (B, S, heads * hd) as heads, qk-normed and rotated.  The
    head counts come from the widths: all heads, or this rank's under
    tensor parallelism."""
    hd = cfg.resolved_head_dim
    q = q.reshape(*q.shape[:2], -1, hd)
    k = k.reshape(*k.shape[:2], -1, hd)
    v = v.reshape(*v.shape[:2], -1, hd)
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


def _kv_split(k: torch.Tensor, cfg: ModelConfig) -> bool:
    """Under tensor parallelism: whether k (B,S,*,hd) holds only this
    rank's KV heads (``wk``'s resolved spec splits it over 'model'), as
    opposed to all of them (the spec replicates it)."""
    return k.shape[2] != cfg.num_kv_heads


def _kv_for_local_heads(q, k, v, cfg: ModelConfig):
    """The KV heads this rank's q heads read, in their GQA grouping.

    q holds the rank's ``H / n`` heads ``[r·H/n, (r+1)·H/n)``.  Split k/v
    already hold their KV heads; replicated k/v hold every KV head (each
    rank projects them all, as GSPMD does), of which q head ``h`` reads
    ``h // (H / KV)``: the contiguous run of them the rank's heads read is
    kept.  A run the rank's heads do not read in equal groups raises.
    """
    if _kv_split(k, cfg):
        return k, v
    Hl = q.shape[2]
    G = cfg.num_heads // cfg.num_kv_heads
    first = shardctx.axis_index("model") * Hl
    reads = [(first + i) // G for i in range(Hl)]
    lo, nk = reads[0], reads[-1] - reads[0] + 1
    if Hl % nk or reads != [lo + i // (Hl // nk) for i in range(Hl)]:
        raise ValueError(f"tensor-parallel attention: q heads [{first}, "
                         f"{first + Hl}) do not read KV heads in equal "
                         f"groups ({cfg.num_heads}/{cfg.num_kv_heads} heads)")
    return k[:, :, lo:lo + nk], v[:, :, lo:lo + nk]


def _gather_columns(*ts: torch.Tensor):
    """Tensors (B, S, c_i) of this rank's columns, each made whole over
    'model' (column blocks in rank order), in one all-gather."""
    B, S = ts[0].shape[:2]
    g = collectives.all_gather(torch.cat(ts, dim=2)[:, :, None], 2, "model")
    out, lo = [], 0
    for t in ts:
        c = t.shape[2]
        out.append(g[:, :, :, lo:lo + c].reshape(B, S, -1))
        lo += c
    return out


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
                   q_block: int = 512, kv_block: int = 512,
                   tp: bool = False) -> torch.Tensor:
    """Self- or cross-attention over a full sequence.  Returns (B,S,D).

    ``use_flash`` takes the CUDA flash kernel and, like the reference,
    ignores ``q_block``/``kv_block`` (the kernel has its own tiles);
    ``use_kernels`` routes the qk-norm through the rmsnorm kernel.  With
    ``tp`` (self-attention) the weights are this rank's 'model' shards:
    q/k/v, qk-norm, RoPE and attention run on the rank's heads, ``wo`` is
    row-parallel on their rows and the partial sums add over 'model'.
    """
    cross = encoder_out is not None
    q, k, v = _project_qkv(params, x, cfg, None if cross else positions,
                           kv_source=encoder_out, use_kernels=use_kernels)
    if tp:
        k, v = _kv_for_local_heads(q, k, v, cfg)
    window = None if cross else cfg.attn_window
    if use_flash:
        out = kernel_ops.flash_attention(q, k, v, causal=causal and not cross,
                                         window=window)
    else:
        out = chunked_attention(q, k, v, causal=causal and not cross,
                                window=window, q_block=q_block,
                                kv_block=kv_block)
    out = out.reshape(x.shape[0], x.shape[1], -1) @ params["wo"]
    return collectives.psum(out, "model") if tp else out


# ---------------------------------------------------------------------------
# Decode: one token against a ring-buffer KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor       # (B, W, KV, hd) — storage dtype (bf16 or int8)
    v: torch.Tensor       # (B, W, KV, hd)
    k_scale: Any = None   # (B, W, KV, 1) f32 when int8-quantized
    v_scale: Any = None


def cache_pspec(quant: bool = False) -> KVCache:
    sp = P("batch", "model", None, None)
    return KVCache(k=sp, v=sp, k_scale=sp if quant else None,
                   v_scale=sp if quant else None)


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


def _decode_core(q, cache: KVCache, new_k, new_v, pos, *, W, offset,
                 s_loc, update, axis=None, use_kernels: bool = False):
    """Scores one KV shard; LSE-combines across ``axis`` when given.

    q: (B,1,H,hd) -> internally (B,KV,G,hd); cache arrays: (B,s_loc,KV,*),
    slots ``offset .. offset + s_loc`` of a ``W``-slot ring; the new K/V is
    written into its slot when it falls in this shard.  Handles both bf16
    and int8-quantized (k_scale/v_scale) caches.
    """
    B, _, H, hd = q.shape
    k_cache, v_cache = cache.k, cache.v
    ks, vs = cache.k_scale, cache.v_scale
    quant = ks is not None
    KV = k_cache.shape[2]
    G = H // KV
    dev = q.device
    slots = offset + torch.arange(s_loc, device=dev)

    if update and quant:
        # K and V quantized into their slot (pos mod W) - offset; the
        # kernel (one launch) computes the slot on the device
        store = (kernel_ops.quantize_kv_store_ if use_kernels
                 else QZ.quantize_kv_store_plain_)
        store(new_k[:, 0], new_v[:, 0], k_cache, v_cache, ks, vs, pos, W,
              offset, floor=1e-8)
    elif update:
        write_slot = torch.remainder(pos, W) - offset
        in_range = (write_slot >= 0) & (write_slot < s_loc)
        clamped = torch.clamp(write_slot, 0, s_loc - 1)
        bidx = torch.arange(B, device=dev)
        QZ.write_slot_(k_cache, new_k[:, 0], bidx, clamped, in_range)
        QZ.write_slot_(v_cache, new_v[:, 0], bidx, clamped, in_range)

    valid = _ring_valid(pos, W, slots)                       # (B, s_loc)
    kf = _dequantize_kv(k_cache, ks) if quant else k_cache
    vf = _dequantize_kv(v_cache, vs) if quant else v_cache
    qg = q.reshape(B, KV, G, hd) / math.sqrt(hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), kf.float())
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)                                       # (B,KV,G)
    if axis is not None:
        m = collectives.pmax(m, axis)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(vf.dtype).float(), vf.float())
    if axis is not None:
        l = collectives.psum(l, axis)
        o = collectives.psum(o, axis)
    out = (o / torch.clamp(l, min=1e-30)[..., None]).reshape(B, 1, H, hd)
    return out.to(q.dtype), KVCache(k=k_cache, v=v_cache, k_scale=ks,
                                    v_scale=vs)


def decode_attention(params, cache: KVCache, x_new: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig, *,
                     update: bool = True, cross: bool = False,
                     rope_pos: Optional[torch.Tensor] = None,
                     use_kernels: bool = False, tp: bool = False
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token attention step.

    x_new: (B, 1, D); pos: (B,) absolute position of the new token (drives
    the ring-slot layout); rope_pos overrides the RoPE angle position when
    it differs from the ring position (M-RoPE vision offset).  A cache
    sharded over 'model' (``DTensor``) is scored shard by shard and
    combined across the model ranks; the cache is updated in place and
    returned as it came.  With ``tp`` the weights are this rank's 'model'
    shards: q and the new k/v are projected column-parallel (the rank's
    heads; its column chunk of a replicated ``wk`` / ``wv``) and
    all-gathered over 'model' for the core, which takes heads whole (the
    reference's ``shard_map`` in_specs); ``wo`` is row-parallel on the
    rank's heads and the partial sums add over 'model'.
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
    if cross:
        # the cache holds the encoder's K / V: only q is projected (the
        # reference projects the new token's k / v too and drops them, and
        # XLA removes that work from its program)
        q = x_new @ params["wq"]
        if tp:
            (q,) = _gather_columns(q)
        q = q.reshape(B, 1, -1, cfg.resolved_head_dim)
        new_k = new_v = None
    elif tp:
        # column-parallel q / k / v: the rank's heads, or its column chunk
        # of a replicated ``wk`` / ``wv`` (GSPMD divides that projection
        # too); all-gathered, then normed and rotated on whole heads
        wk, wv = params["wk"], params["wv"]
        if wk.shape[1] == cfg.num_kv_heads * cfg.resolved_head_dim:
            wk, wv = shardctx.model_chunk(wk, 1), shardctx.model_chunk(wv, 1)
        q, new_k, new_v = _heads(params, *_gather_columns(
            x_new @ params["wq"], x_new @ wk, x_new @ wv), cfg, positions,
            use_kernels=use_kernels)
    else:
        q, new_k, new_v = _project_qkv(params, x_new, cfg, positions,
                                       use_kernels=use_kernels)
    if shardctx.is_dtensor(cache.k):
        n_model = shardctx.axis_size("model")
        if n_model != cache.k.device_mesh.size():
            raise ValueError("decode_attention: a model-sharded cache needs "
                             "the mesh it was built under")
        s_loc = W // n_model
        local = KVCache(*(shardctx.local(t) if t is not None else None
                          for t in cache))
        out, _ = _decode_core(q, local, new_k, new_v, pos, W=W,
                              offset=shardctx.axis_index("model") * s_loc,
                              s_loc=s_loc, update=update, axis="model",
                              use_kernels=use_kernels)
        new_cache = cache
    else:
        out, new_cache = _decode_core(q, cache, new_k, new_v, pos, W=W,
                                      offset=0, s_loc=W, update=update,
                                      use_kernels=use_kernels)
    if tp:
        out = shardctx.model_chunk(out, 2)               # the rank's heads
    out = out.reshape(B, 1, -1) @ params["wo"]
    if tp:
        out = collectives.psum(out, "model")
    return out, new_cache


def build_cross_cache(params, encoder_out: torch.Tensor,
                      cfg: ModelConfig, tp: bool = False) -> KVCache:
    """Static decode-time KV cache over the encoder output (no RoPE).

    With ``tp`` the weights are this rank's 'model' shards; split k / v are
    all-gathered over 'model' along the heads, as ``prefill_cache``'s are.
    Under a mesh whose 'model' axis divides the encoder positions the
    cache is the rank's run of them (``_seq_shard_cache``), which the
    decode step scores and combines across the model ranks.
    """
    k, v = encoder_out @ params["wk"], encoder_out @ params["wv"]
    if tp and k.shape[-1] != cfg.num_kv_heads * cfg.resolved_head_dim:
        k, v = _gather_columns(k, v)
    hd = cfg.resolved_head_dim
    return _seq_shard_cache(KVCache(k=k.reshape(*k.shape[:2], -1, hd),
                                    v=v.reshape(*v.shape[:2], -1, hd)))


def prefill_cache(params, x, positions, cfg: ModelConfig,
                  window_override: Optional[int] = None,
                  quant: bool = False, use_kernels: bool = False,
                  tp: bool = False) -> KVCache:
    """Build the decode-layout cache from a full prefill pass.

    With ``tp`` the weights are this rank's 'model' shards; the ring holds
    every KV head on each model rank, as the reference's does, so split
    k/v are all-gathered over 'model' along the heads first.
    """
    _, k, v = _project_qkv(params, x, cfg, positions, use_kernels=use_kernels)
    if tp and _kv_split(k, cfg):
        k, v = (t.reshape(*k.shape[:2], -1, k.shape[3])
                for t in _gather_columns(k.flatten(2), v.flatten(2)))
    W = window_override or (min(x.shape[1], cfg.attn_window)
                            if cfg.attn_window else x.shape[1])
    if cfg.attn_window:
        W = min(W, cfg.attn_window)
    if quant:
        # the ring layout and the quantizer (one launch of the kernel);
        # the floor is the reference ``_quantize_kv``'s 1e-8
        store = (kernel_ops.quantize_kv_prefill if use_kernels
                 else QZ.quantize_kv_prefill_plain)
        kq, vq, ksc, vsc = store(k, v, W, floor=1e-8)
        return _seq_shard_cache(KVCache(k=kq, v=vq, k_scale=ksc, v_scale=vsc))
    k, v = QZ.ring_layout(k, W), QZ.ring_layout(v, W)
    return _seq_shard_cache(KVCache(k=k.contiguous(), v=v.contiguous()))


def _seq_shard_cache(cache: KVCache) -> KVCache:
    """Under a mesh whose 'model' axis divides the ring (or the cross
    cache's encoder positions), this rank's slots of it as a ``DTensor``
    over the model axis (the reference's ``hint(k, "batch", "model", None,
    None)``, which its decode's ``shard_map`` takes); else the ring whole.
    The slots are dimension -3 of each field, so a stack of layers' caches
    (R, B, W, KV, hd) is laid out as the stack of each layer's."""
    n = shardctx.axis_size("model")
    if n == 1 or cache.k.shape[-3] % n:
        return cache
    return KVCache(*(None if t is None else shardctx.model_sharded(
        shardctx.model_chunk(t, -3).contiguous(), -3) for t in cache))
