"""Model assembly: every architecture of ``configs`` as one composable stack.

Counterpart of ``repro/models/transformer.py``.  The layer sequence is
``R`` repetitions of the arch's block pattern (``("attn",)`` for dense, MoE,
whisper's decoder and qwen2-vl, ``("ssm",)`` for falcon-mamba,
``("rglru", "rglru", "attn")`` for recurrentgemma) plus
``L mod len(pattern)`` remainder layers.  Parameters
keep the reference's tree: ``params["reps"]`` is a tuple with one entry per
pattern position whose leaves are stacked on a leading R axis, and
``params["rest"]`` a tuple of unstacked remainder blocks, so
``bridge.params_from_numpy`` maps the reference's tree one to one.  The
reference's ``lax.scan`` over ``reps`` becomes a Python loop over R.

One entry point per program phase, as in the reference: :func:`loss_fn`
(full-sequence teacher-forced LM loss, the training step's), :func:`prefill`
(full-sequence forward that builds the decode state) and
:func:`decode_step` (one new token against the cached state); plus
:func:`logits_fn` for smoke-scale full logits.  ``forward_hidden`` and
``logits_fn`` return the MoE routing telemetry (``MoEAux``, zeros for a
model without MoE) beside their result, as the reference's do.

Whisper's encoder (:func:`encode`) runs under the caller's ``Runtime``, so
its bidirectional attention takes the flash kernel with ``use_kernels``;
the reference's ``embed_inputs`` runs it under its default runtime.  The
function is the same either way.

Activation checkpointing (``torch.utils.checkpoint``, non-reentrant) sits
where the reference has ``jax.checkpoint``: each decoder block under
``Runtime.remat`` (not while building a decode cache), each encoder block
under ``Runtime.remat``, and each chunk of the LM loss always.  It applies
only while autograd records and some input of the checkpointed call
requires a gradient, so serving computes exactly what it computes without
it, at the same cost.  The LM loss streams over
sequence chunks of ``Runtime.loss_chunk`` positions, so the fp32 (B, S, V)
logits are never materialized.

Under a device mesh (``parallel.shardctx.use_mesh``) each rank runs these
entry points on its own rows of the batch, with parameters held as
``DTensor``s laid out by :func:`model_pspecs`.  Each block gathers the
weights it computes whole with as it runs (:func:`_pin_block_params`,
FSDP); under ``Runtime.production`` the MoE FFN runs the
reference's expert-parallel ``moe_sharded`` and decode attention the
sequence-sharded ring (``attention.decode_attention``).  ``loss_fn``
returns the loss of the whole batch (averaged over the batch axes), as the
reference's does; ``prefill`` and ``decode_step`` return the rank's rows'
logits.  Under ``Runtime.seq_shard`` the residual stream lives S-sharded
over ``model`` between sublayers (Megatron-SP).

Every entry point (``loss_fn``, ``logits_fn``, ``prefill``, ``decode_step``)
is tensor-parallel where the 'model' axis has ranks, as GSPMD partitions
the reference's layers by their specs (Megatron): the self- and
cross-attention, the SSM and RG-LRU mixers, the dense MLP, the MoE's
shared experts and dense residual, the embedding lookup and the LM head
take each weight as its resolved spec has it, this rank's 'model' shard or
whole (:func:`_tp_block_params`, :func:`_table_shard`), and their partial
sums add over 'model'.  The decode state follows the reference's specs:
attention rings and whisper's cross caches hold the rank's run of
positions, and the SSM and RG-LRU states its channels (``DTensor``s over
the model axis), where the model axis divides them.  The LM loss is
vocab-parallel: each rank scores its V / n logits and the log-sum-exp and
the picked logit add over 'model' (:func:`_vocab_parallel_nll`), so no
rank holds (B, c, V) fp32 logits.  Attention is on shards whatever the
head counts: where the model axis does not divide the heads, each rank
computes its ``ceil(H / n)`` of them, as GSPMD pads the head dimension.  A
mixer whose channels the axis does not divide computes whole on the rank's
rows; the routed experts keep ``moe_sharded``'s expert-parallel layout.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import pytree, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, moe, rglru, ssm
from repro_torch.models.attention import KVCache
from repro_torch.models.moe import MoEAux
from repro_torch.parallel import collectives, shardctx
from repro_torch.parallel.shardctx import P


# ---------------------------------------------------------------------------
# Runtime options
# ---------------------------------------------------------------------------

class Runtime(NamedTuple):
    """Execution knobs threaded through the stack.

    ``production`` and ``seq_shard`` are read only under a device mesh:
    without one the MoE is ``moe_dense`` whatever ``production`` says, as
    in the reference.  The kernels have no backward: a training step keeps
    ``use_kernels`` off, as the reference's ``Trainer`` does.
    """
    use_kernels: bool = False     # hand-written CUDA kernels vs torch ops
    production: bool = True       # sharded MoE vs dense oracle
    remat: bool = True            # per-block activation checkpointing
    q_block: int = 512            # chunked-attention q/kv block sizes
    kv_block: int = 1024
    loss_chunk: int = 512         # LM-loss sequence chunk
    # Megatron-SP: residual stream sharded over 'model' on the sequence dim
    # between blocks (saved remat residuals shrink by the model width)
    seq_shard: bool = False
    kv_quant: bool = False        # int8 KV cache + per-vector scales


DEFAULT_RT = Runtime()


def _pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.block_pattern is not None:
        return tuple(cfg.block_pattern)
    return ("ssm",) if cfg.family == "ssm" else ("attn",)


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return kind != "ssm" and (cfg.moe is not None or cfg.d_ff > 0)


def _zero_aux(cfg: ModelConfig, device) -> MoEAux:
    e = cfg.moe.num_experts if cfg.moe is not None else 1
    z = lambda *shape: torch.zeros(shape, device=device)  # noqa: E731
    return MoEAux(aux_loss=z(), load=z(e), dropped=z())


def _add_aux(a: MoEAux, b: MoEAux) -> MoEAux:
    return MoEAux(aux_loss=a.aux_loss + b.aux_loss,
                  load=a.load + b.load, dropped=a.dropped + b.dropped)


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
    return shardctx.select(tree, r)


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
    return shardctx.stack(trees)


def _write_(dst, src) -> None:
    """In place: copy tree ``src`` into the same-shaped views ``dst``
    (a tensor that already is its destination is left as it is).  A
    ``DTensor`` view takes ``src``'s local tensor into its own: each
    rank's shard, laid out alike, no collective."""
    if isinstance(dst, dict):
        for k in dst:
            _write_(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s_ in zip(dst, src):
            _write_(d, s_)
    elif dst is not None and dst is not src:
        shardctx.local(dst).copy_(shardctx.local(src))


def _depth(blocks) -> int:
    """R, the leading axis of a stacked block's parameters."""
    return blocks["norm1"]["scale"].shape[0]


def _unstack(tree) -> List[Any]:
    """The R layers of a block's stacked parameter dict, each leaf
    ``torch.unbind``'s view: one unbind per leaf, whose backward stacks the
    layers' gradients once (indexing layer by layer would add a
    zero-filled R-layer gradient per layer)."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        R = len(next(iter(per.values())))
        return [{k: v[r] for k, v in per.items()} for r in range(R)]
    return shardctx.unbind(tree)


def _remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward while
    autograd records a tensor of ``args`` (the reference's
    ``jax.checkpoint``); a plain call otherwise, as in serving, whose
    parameters need no gradient.  The recomputation runs on autograd's
    device thread, so it reinstalls the mesh current at the call."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in pytree.leaves(args)):
        mesh = shardctx.current_mesh()

        def on_mesh(*a):
            with shardctx.use_mesh(mesh):
                return fn(*a)

        return checkpoint(on_mesh, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# One block: norm -> mixer -> (cross-attn) -> norm -> ffn, pre-norm residual
# ---------------------------------------------------------------------------

def init_block(cfg: ModelConfig, kind: str, device,
               generator: torch.Generator, lead=(),
               cross: bool = False) -> Dict[str, Any]:
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
    if cross and kind == "attn":
        params["cross_norm"] = layers.init_rmsnorm(cfg.d_model, dtype, device,
                                                   lead)
        params["cross_attn"] = attention.init_attention(
            cfg, device, generator, cross=True, lead=lead)
    if _has_ffn(cfg, kind):
        params["norm2"] = layers.init_rmsnorm(cfg.d_model, dtype, device, lead)
        if cfg.moe is not None:
            params["ffn"] = moe.init_moe(cfg, device, generator, lead)
        else:
            params["ffn"] = layers.init_mlp(cfg.d_model, cfg.d_ff,
                                            cfg.activation, dtype, device,
                                            generator, lead)
    return params


def block_pspecs(cfg: ModelConfig, kind: str, cross: bool = False):
    """The reference's PartitionSpec tree of :func:`init_block`."""
    specs: Dict[str, Any] = {"norm1": layers.rmsnorm_pspecs()}
    if kind == "attn":
        specs["mixer"] = attention.attention_pspecs(cfg)
    elif kind == "ssm":
        specs["mixer"] = ssm.ssm_pspecs()
    else:
        specs["mixer"] = rglru.rglru_pspecs()
    if cross and kind == "attn":
        specs["cross_norm"] = layers.rmsnorm_pspecs()
        specs["cross_attn"] = attention.attention_pspecs(cfg, cross=True)
    if _has_ffn(cfg, kind):
        specs["norm2"] = layers.rmsnorm_pspecs()
        specs["ffn"] = (moe.moe_pspecs(cfg) if cfg.moe is not None
                        else layers.mlp_pspecs(cfg.activation))
    return specs


def _pin_block_params(params: Dict[str, Any],
                      production: bool = True) -> Dict[str, Any]:
    """A block's weights as its layer computes with them: the FSDP gather.

    The reference pins each layer's slice to its stored sharding so XLA
    keeps the 'data'-axis all-gather inside the (rematted) block instead of
    hoisting the whole stack's.  Here the gather is explicit and runs inside
    the block, so only one layer's weights are whole at a time: every
    ``DTensor`` leaf is all-gathered (``shardctx.gather``), except the
    routed expert banks under ``production``, which ``moe_sharded`` gathers
    over 'data' only and keeps sharded over 'model'.  A no-op without a
    mesh.
    """
    if shardctx.current_mesh() is None:
        return params

    def pin(tree, experts=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = pin(v, experts=k == "experts")
            elif experts and production:
                out[k] = v
            else:
                out[k] = shardctx.gather(v)
        return out

    return pin(params)


def _tensor_parallel() -> bool:
    """The tensor-parallel path of every entry point: under a mesh whose
    'model' axis has ranks."""
    return shardctx.axis_size("model") > 1


_NO_TP = {"mixer": False, "ffn": False, "cross": False}


def _tp_block_params(params: Dict[str, Any], cfg: ModelConfig, kind: str,
                     production: bool = True):
    """(weights, tp): a block's weights for the tensor-parallel path, and
    which of its sublayers (``"mixer"``, ``"ffn"``, ``"cross"`` for
    whisper's ``cross_attn``) compute on 'model' shards.

    Each sublayer on shards takes each leaf as its resolved spec has it
    (``shardctx.model_dim`` on the specs of ``block_pspecs``): a leaf the
    spec splits over 'model' as this rank's 'model' shard, gathered over
    'data' only (``shardctx.model_shard``); a leaf the spec replicates
    whole.  The sublayers:

    * self- and cross-attention, wherever the spec splits ``wq``, whether
      or not the model axis divides the heads or the KV heads (each rank
      computes its chunk of heads, as GSPMD pads them:
      ``attention.head_range``); whole only where the resolved spec
      replicates ``wq``;
    * the SSM and RG-LRU mixers, where every leaf their specs name 'model'
      on is split (the model axis divides ``d_inner`` or W); else whole.
      The SSM's ``in_proj`` is gathered whole and the rank's x and z
      columns taken from it (``ssm.in_proj_shard``);
    * the dense MLP, where its spec splits ``d_ff``, and an MoE FFN's
      always-on branches (deepseek's shared experts ``"shared"``, arctic's
      dense residual ``"dense"``) where every one of them splits.

    Everything else (norms, the router and the routed experts' bank,
    which ``moe_sharded`` lays out by expert) is
    :func:`_pin_block_params`'s.
    """
    specs = block_pspecs(cfg, kind, cross="cross_attn" in params)
    out: Dict[str, Any] = {}
    tp = dict(_NO_TP)

    def dims_of(tree, spec):
        return {k: shardctx.model_dim(v, spec[k]) for k, v in tree.items()}

    def take(tree, dims):
        return {k: (shardctx.gather(v) if dims[k] is None
                    else shardctx.model_shard(v, dims[k]))
                for k, v in tree.items()}

    def mlp_dims(tree, spec, what):
        dims = dims_of(tree, spec)
        if len({d is None for d in dims.values()}) > 1:
            raise ValueError(f"tensor-parallel {what}: specs split {dims} "
                             f"over 'model' inconsistently")
        return dims

    def attention(sub, key):
        dims = dims_of(params[sub], specs[sub])
        if (dims["wq"] is None) != (dims["wo"] is None) or \
                (dims["wk"] is None) != (dims["wv"] is None):
            raise ValueError(f"tensor-parallel attention: specs split "
                             f"{dims} over 'model' inconsistently")
        if dims["wq"] is not None:
            out[sub], tp[key] = take(params[sub], dims), True

    if kind == "attn":
        attention("mixer", "mixer")
    else:
        mixer, spec = params["mixer"], specs["mixer"]
        dims = dims_of(mixer, spec)
        if all(dims[k] is not None for k, sp in spec.items()
               if "model" in tuple(sp)):
            w = take({k: v for k, v in mixer.items() if k != "in_proj"},
                     dims)
            if kind == "ssm":
                w["in_proj"] = ssm.in_proj_shard(
                    shardctx.gather(mixer["in_proj"]))
            out["mixer"], tp["mixer"] = w, True
    if "cross_attn" in params:
        attention("cross_attn", "cross")
    if "ffn" in params and cfg.moe is None:
        dims = mlp_dims(params["ffn"], specs["ffn"], "MLP")
        if dims["wo"] is not None:
            out["ffn"], tp["ffn"] = take(params["ffn"], dims), True
    elif "ffn" in params:
        ffn = params["ffn"]
        dims = {k: mlp_dims(ffn[k], specs["ffn"][k], f"MoE {k}")
                for k in ("shared", "dense") if k in ffn}
        if dims and all(d["wo"] is not None for d in dims.values()):
            routed = {k: v for k, v in ffn.items() if k not in dims}
            out["ffn"] = {**_pin_block_params(routed, production),
                          **{k: take(ffn[k], d) for k, d in dims.items()}}
            tp["ffn"] = True
    rest = {k: v for k, v in params.items() if k not in out}
    out.update(_pin_block_params(rest, production))
    return out, tp


def _block_weights(params, cfg: ModelConfig, kind: str, rt: Runtime):
    """(weights, tp) of a block: :func:`_tp_block_params` on the
    tensor-parallel path, else :func:`_pin_block_params` with no sublayer
    on shards."""
    if _tensor_parallel():
        return _tp_block_params(params, cfg, kind, rt.production)
    return _pin_block_params(params, rt.production), dict(_NO_TP)


def _seq_sharded(rt: Runtime) -> bool:
    return rt.seq_shard and shardctx.axis_size("model") > 1


def _stream_rt(rt: Runtime, seq_len: int) -> Runtime:
    """``rt`` for a residual stream of ``seq_len`` positions: ``seq_shard``
    off where the model axis does not divide it (whisper's 1500 frames on
    16 model ranks), so that stream stays whole on every model rank.  Each
    sublayer computes on the whole sequence either way; the reference's
    GSPMD pads the uneven shards instead."""
    if _seq_sharded(rt) and seq_len % shardctx.axis_size("model"):
        return rt._replace(seq_shard=False)
    return rt


def _seq_scatter(y: torch.Tensor) -> torch.Tensor:
    """This rank's S chunk over 'model' (y is whole on every model rank)."""
    return shardctx.model_chunk(y, 1)


def _whole(tree: Dict[str, Any], keys=None) -> Dict[str, torch.Tensor]:
    """A flat dict of weights outside the blocks (the embedding tables, a
    final norm), the entries ``keys`` (default: all) gathered under a
    mesh."""
    return {k: shardctx.gather(tree[k]) for k in (keys or tree)}


def _table_shard(params, cfg: ModelConfig, key: str):
    """(weight, split) of the embedding table ``key`` (``"table"`` (V, D) or
    ``"out"`` (D, V)) for the entry points.  On the tensor-parallel path a
    table its resolved spec splits over 'model' comes as this rank's shard
    (the spec splits D of ``table``, V of ``out``); otherwise, or where the
    model axis does not divide that dimension (whisper-base's 51,865-entry
    ``out``), whole."""
    leaf = params["embed"][key]
    if not _tensor_parallel():
        return shardctx.gather(leaf), False
    dim = shardctx.model_dim(
        leaf, layers.embedding_pspecs(cfg.tie_embeddings)[key])
    if dim is None:
        return shardctx.gather(leaf), False
    if dim != 1:
        raise ValueError(f"tensor-parallel {key}: split over 'model' on "
                         f"dimension {dim}, not 1")
    return shardctx.model_shard(leaf, dim), True


def _lm_logits(params, x, cfg: ModelConfig, tied=None) -> torch.Tensor:
    """The LM head of ``logits_fn``, ``prefill`` and ``decode_step``: whole
    logits on every rank, from ``out`` (column-parallel where split) or the
    tied table (row-parallel where split; ``tied``: its
    :func:`_table_shard` pair when the caller already holds it)."""
    tie = cfg.tie_embeddings
    key = "table" if tie else "out"
    w, split = tied if tied is not None else _table_shard(params, cfg, key)
    return layers.unembed({key: w}, x, tie, tp=split)


def block_forward(params, x, positions, encoder_out, cfg: ModelConfig,
                  kind: str, rt: Runtime, *, causal: bool = True,
                  build_cache: bool = False,
                  cache_window: Optional[int] = None):
    """Full-sequence block. Returns (x, aux_or_None, cache_or_None).

    ``aux`` is the MoE FFN's routing telemetry, ``None`` for a block
    without one (the reference returns zeros there; ``forward_hidden``
    starts its sum from zeros, so the total is the same).  Under a mesh with
    model ranks the sublayers compute on this rank's 'model' shards
    (:func:`_tp_block_params`); with ``build_cache`` a recurrent mixer's
    state then holds the rank's channels.
    """
    params, tp = _block_weights(params, cfg, kind, rt)
    seq = _seq_sharded(rt)

    def gather_seq(h):
        # Megatron-SP transition: the residual stream and its norms live
        # S-sharded over 'model'; the sublayer runs on the gathered
        # sequence (an all-gather; its transpose is all-reduce + slice)
        return collectives.all_gather(h, 1, "model") if seq else h

    def scatter_seq(y):
        # inverse transition: the sublayer's output returns to the
        # S-sharded residual stream.  A tensor-parallel sublayer's partial
        # sums were all-reduced over 'model' inside it, so this slice
        # completes the reference's all-reduce + slice; a sublayer that
        # computes whole on each model rank needs the slice alone
        return _seq_scatter(y) if seq else y

    k = rt.use_kernels
    h = gather_seq(layers.rmsnorm(params["norm1"], x, cfg.norm_eps,
                                  use_kernel=k))
    cache = None
    if kind == "attn":
        mix = attention.full_attention(
            params["mixer"], h, positions, cfg, causal=causal, use_flash=k,
            use_kernels=k, q_block=rt.q_block, kv_block=rt.kv_block,
            tp=tp["mixer"])
        if build_cache:
            cache = {"self": attention.prefill_cache(
                params["mixer"], h, positions, cfg,
                window_override=cache_window, quant=rt.kv_quant,
                use_kernels=k, tp=tp["mixer"])}
    else:
        fwd = ssm.ssm_forward if kind == "ssm" else rglru.rglru_forward
        mix = fwd(params["mixer"], h, cfg, use_kernel=k,
                  return_state=build_cache, tp=tp["mixer"])
        if build_cache:
            mix, st = mix
            cache = {"self": st}
    x = x + scatter_seq(mix)
    if "cross_attn" in params and encoder_out is not None:
        # the chunked torch path, as the reference passes no use_flash here
        h = gather_seq(layers.rmsnorm(params["cross_norm"], x, cfg.norm_eps,
                                      use_kernel=k))
        x = x + scatter_seq(attention.full_attention(
            params["cross_attn"], h, None, cfg, causal=False,
            encoder_out=encoder_out, q_block=rt.q_block,
            kv_block=rt.kv_block, tp=tp["cross"]))
        if build_cache:
            cache["cross"] = attention.build_cross_cache(
                params["cross_attn"], encoder_out, cfg, tp=tp["cross"])
    aux = None
    if "ffn" in params:
        h = gather_seq(layers.rmsnorm(params["norm2"], x, cfg.norm_eps,
                                      use_kernel=k))
        if cfg.moe is not None:
            y, aux = moe.moe_forward(params["ffn"], h, cfg,
                                     production=rt.production, tp=tp["ffn"])
        else:
            y = layers.mlp(params["ffn"], h, cfg.activation, tp=tp["ffn"])
        x = x + scatter_seq(y)
    x = shardctx.hint(x, "batch", "model" if seq else None, None)
    return x, aux, cache


def block_decode(params, state, x_new, pos, cfg: ModelConfig, kind: str,
                 rt: Runtime, rope_pos=None):
    """One-token block step. x_new: (B,1,D). Returns (x, new_state).
    Tensor-parallel as :func:`block_forward`."""
    params, tp = _block_weights(params, cfg, kind, rt)
    k = rt.use_kernels
    h = layers.rmsnorm(params["norm1"], x_new, cfg.norm_eps, use_kernel=k)
    new_state = dict(state)
    if kind == "attn":
        mix, new_state["self"] = attention.decode_attention(
            params["mixer"], state["self"], h, pos, cfg, rope_pos=rope_pos,
            use_kernels=k, tp=tp["mixer"])
    else:
        step = ssm.ssm_step if kind == "ssm" else rglru.rglru_step
        mix, new_state["self"] = step(params["mixer"], state["self"], h, cfg,
                                      tp=tp["mixer"])
    x = x_new + mix
    if "cross" in state:
        h = layers.rmsnorm(params["cross_norm"], x, cfg.norm_eps,
                           use_kernel=k)
        enc_len = state["cross"].k.shape[1]
        enc_pos = torch.full((x.shape[0],), enc_len, dtype=torch.long,
                             device=x.device)
        out, _ = attention.decode_attention(
            params["cross_attn"], state["cross"], h, enc_pos, cfg,
            update=False, cross=True, use_kernels=k, tp=tp["cross"])
        x = x + out
    if "ffn" in params:
        h = layers.rmsnorm(params["norm2"], x, cfg.norm_eps, use_kernel=k)
        if cfg.moe is not None:
            y, _ = moe.moe_forward(params["ffn"], h, cfg,
                                   production=rt.production, tp=tp["ffn"])
        else:
            y = layers.mlp(params["ffn"], h, cfg.activation, tp=tp["ffn"])
        x = x + y
    return x, new_state


# ---------------------------------------------------------------------------
# Whole-model parameters
# ---------------------------------------------------------------------------

def init_model(cfg: ModelConfig, generator: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    """Random parameters from ``generator`` (which must live on ``device``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(cfg.vocab_size, cfg.d_model, dtype,
                                       cfg.tie_embeddings, dev, generator),
        "final_norm": layers.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    pattern = _pattern(cfg)
    R, rem = divmod(cfg.num_layers, len(pattern))
    cross = cfg.cross_attention
    if R > 0:
        params["reps"] = tuple(init_block(cfg, kind, dev, generator, (R,),
                                          cross=cross) for kind in pattern)
    if rem:
        params["rest"] = tuple(init_block(cfg, pattern[j], dev, generator,
                                          cross=cross) for j in range(rem))
    if cfg.encoder_layers:
        params["encoder"] = init_block(cfg, "attn", dev, generator,
                                       (cfg.encoder_layers,))
        params["enc_norm"] = layers.init_rmsnorm(cfg.d_model, dtype, dev)
    return params


def _lead(specs):
    """Specs of a tree stacked on a leading (unsharded) layer axis."""
    return pytree.map_(lambda s: P(None, *s), specs)


def model_pspecs(cfg: ModelConfig):
    """(parameters on the ``meta`` device, their PartitionSpec tree): the
    reference's ``model_pspecs``, without allocating any parameters."""
    params = init_model(cfg, torch.Generator(), device="meta")
    specs: Dict[str, Any] = {
        "embed": layers.embedding_pspecs(cfg.tie_embeddings),
        "final_norm": layers.rmsnorm_pspecs()}
    pattern = _pattern(cfg)
    R, rem = divmod(cfg.num_layers, len(pattern))
    cross = cfg.cross_attention
    if R > 0:
        specs["reps"] = tuple(_lead(block_pspecs(cfg, kind, cross))
                              for kind in pattern)
    if rem:
        specs["rest"] = tuple(block_pspecs(cfg, pattern[j], cross)
                              for j in range(rem))
    if cfg.encoder_layers:
        specs["encoder"] = _lead(block_pspecs(cfg, "attn"))
        specs["enc_norm"] = layers.rmsnorm_pspecs()
    return params, specs


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(count_params(v) for v in params)
    return int(params.numel())


# ---------------------------------------------------------------------------
# Input embedding / positions per family
# ---------------------------------------------------------------------------

def _mrope_side(n_vision: int) -> int:
    return max(1, int(math.ceil(math.sqrt(max(n_vision, 1)))))


def _mrope_positions(B: int, S: int, n_vision: int,
                     device=None) -> torch.Tensor:
    """(B, 3, S) (temporal, h, w) M-RoPE indices: a vision-patch grid prefix
    followed by text positions (all three components advance together)."""
    idx = torch.arange(S, device=device)
    side = _mrope_side(n_vision)
    is_vis = idx < n_vision
    text = idx - n_vision + side
    t = torch.where(is_vis, torch.zeros_like(idx), text)
    h = torch.where(is_vis, idx // side, text)
    w = torch.where(is_vis, idx % side, text)
    return torch.stack([t, h, w])[None].expand(B, 3, S)


def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 rt: Runtime = DEFAULT_RT):
    """-> (x (B,S,D), positions, encoder_out_or_None).

    ``positions`` is (B, S), (B, 3, S) under M-RoPE, or ``None`` for
    whisper's sinusoidal positions.  Under a mesh with model ranks, tokens
    are looked up in this rank's 'model' shard of the table (D / n of each
    embedding, all-gathered over 'model').
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    dev = tokens.device
    table, split = _table_shard(params, cfg, "table")
    x = layers.embed({"table": table}, tokens, tp=split)
    encoder_out = None
    if cfg.encoder_layers:
        # whisper: the conv frontend is a stub — precomputed frame embeddings
        enc = batch["audio_embeds"]
        enc = enc + layers.sinusoidal_positions(
            enc.shape[1], cfg.d_model, dev).to(enc.dtype)
        encoder_out = encode(params, enc, cfg, rt)
        x = x + layers.sinusoidal_positions(S, cfg.d_model, dev).to(x.dtype)
        positions = None                      # sinusoidal, no RoPE
    elif cfg.vision_stub and "vision_embeds" in batch:
        vis = batch["vision_embeds"].to(x.dtype)              # (B, V, D)
        V = vis.shape[1]
        x = torch.cat([vis, x[:, V:]], dim=1)
        positions = _mrope_positions(B, S, V, dev)
    elif cfg.mrope:
        positions = _mrope_positions(B, S, 0, dev)
    else:
        positions = torch.arange(S, device=dev)[None].expand(B, S)
    x = shardctx.hint(x, "batch", None, None)
    return x, positions, encoder_out


def encode(params, enc_in: torch.Tensor, cfg: ModelConfig,
           rt: Runtime = DEFAULT_RT) -> torch.Tensor:
    """Whisper encoder: bidirectional attention over frame embeddings.

    The reference's ``lax.scan`` over the stacked ``params["encoder"]``
    becomes a loop over its leading axis.
    """
    rt = _stream_rt(rt, enc_in.shape[1])

    def one(p, x):
        return block_forward(p, x, None, None, cfg, "attn", rt,
                             causal=False)[0]

    seq = _seq_sharded(rt)
    x = _seq_scatter(enc_in) if seq else enc_in
    for p in _unstack(params["encoder"]):
        x = _remat(one, p, x) if rt.remat else one(p, x)
    if seq:
        x = collectives.all_gather(x, 1, "model")
    return layers.rmsnorm(_whole(params["enc_norm"]), x, cfg.norm_eps,
                          use_kernel=rt.use_kernels)


# ---------------------------------------------------------------------------
# Full-sequence forward (shared by loss / logits / prefill)
# ---------------------------------------------------------------------------

def forward_hidden(params, x, positions, encoder_out, cfg: ModelConfig,
                   rt: Runtime, build_cache: bool = False,
                   cache_window: Optional[int] = None):
    """Runs the decoder stack. Returns (hidden, aux, (caches_rep, caches_rest)).

    Each cache part is ``None`` unless ``build_cache``; ``caches_rep`` has
    one entry per pattern position, stacked on R.  ``aux`` sums the MoE
    blocks' telemetry (zeros without MoE).  Each block is checkpointed
    under ``rt.remat`` unless it builds a cache.  Under ``seq_shard`` the
    stream is cut into this rank's S chunk before the first block and
    gathered after the last.
    """
    pattern = _pattern(cfg)
    rt = _stream_rt(rt, x.shape[1])
    aux = _zero_aux(cfg, x.device)
    caches_rep, caches_rest = None, None
    remat = rt.remat and not build_cache
    seq = _seq_sharded(rt)
    if seq:
        x = _seq_scatter(x)

    def one(p, x, kind):
        nonlocal aux

        def run(p, x):
            return block_forward(p, x, positions, encoder_out, cfg, kind, rt,
                                 causal=True, build_cache=build_cache,
                                 cache_window=cache_window)

        x, a, c = _remat(run, p, x) if remat else run(p, x)
        if a is not None:
            aux = _add_aux(aux, a)
        return x, c

    if "reps" in params:
        per_kind: List[List[Any]] = [[] for _ in pattern]
        stacks = [_unstack(blocks) for blocks in params["reps"]]
        for r in range(len(stacks[0])):
            for i, kind in enumerate(pattern):
                x, c = one(stacks[i][r], x, kind)
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
    if seq:
        x = collectives.all_gather(x, 1, "model")
    x = layers.rmsnorm(_whole(params["final_norm"]), x, cfg.norm_eps,
                       use_kernel=rt.use_kernels)
    return x, aux, (caches_rep, caches_rest)


def logits_fn(params, batch, cfg: ModelConfig, rt: Runtime = DEFAULT_RT):
    """Full (B,S,V) logits and the MoE aux — smoke-test scale only.  Under
    a mesh, the rank's rows, whole over V (:func:`_lm_logits`)."""
    x, positions, enc = embed_inputs(params, batch, cfg, rt)
    x, aux, _ = forward_hidden(params, x, positions, enc, cfg, rt)
    return _lm_logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# Training loss (chunked over the sequence)
# ---------------------------------------------------------------------------

def _vocab_parallel_nll(lg, tc, vc) -> torch.Tensor:
    """Summed NLL from this rank's V / n logits lg (B, c, V / n) fp32, the
    rank's vocabulary ``[rank * V / n, (rank + 1) * V / n)``: the
    reference's logits sharded ``(batch, None, model)``.  The log-sum-exp
    adds its sums over 'model' about a shift that is their all-reduced
    maximum (outside autograd: its value cancels); the target's logit is
    taken on the rank whose range holds it, zero elsewhere, and added over
    'model'."""
    m = collectives.pmax(lg.amax(dim=-1), "model")              # (B, c)
    sums = collectives.psum(torch.exp(lg - m[..., None]).sum(dim=-1),
                            "model")
    logz = m + torch.log(sums)
    n = lg.shape[-1]
    local = tc - shardctx.axis_index("model") * n
    mine = (local >= 0) & (local < n)
    picked = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = collectives.psum(torch.where(mine, picked,
                                          torch.zeros_like(picked)), "model")
    return torch.sum((logz - picked) * vc[None, :])


def _chunk_nll(w, xc, tc, vc, tie: bool, split: bool) -> torch.Tensor:
    """Summed NLL of one chunk: xc (B, c, D), tc (B, c), vc (c,) validity;
    ``(w, split)`` the LM head's table as :func:`_table_shard` gives it.

    Split ``out`` (D, V / n): the rank's V / n logits, column-parallel.
    Split tied ``table`` (V, D / n): the row-parallel product, its partial
    logits added over 'model', of which the rank keeps its V chunk
    (all-reduce + slice).  Either way :func:`_vocab_parallel_nll`; where
    the table is whole, or the model axis does not divide V, the NLL of
    whole logits."""
    if split and not tie:
        lg = xc @ w
    else:
        lg = layers.unembed({"table" if tie else "out": w}, xc, tie,
                            tp=split)
        split = split and lg.shape[-1] % shardctx.axis_size("model") == 0
        if split:
            lg = shardctx.model_chunk(lg, -1)
    lg = lg.float()
    if split:
        return _vocab_parallel_nll(lg, tc, vc)
    logz = torch.logsumexp(lg, dim=-1)                          # (B, c)
    picked = torch.gather(lg, -1, tc[..., None])[..., 0]
    return torch.sum((logz - picked) * vc[None, :])


def _chunked_lm_loss(params, x, tokens, cfg: ModelConfig, chunk: int):
    """Mean NLL of tokens[:,1:] given hidden x[:,:-1]; O(chunk·V) memory.

    The reference's ``lax.scan`` over zero-padded chunks, summed in the
    same order; each chunk is checkpointed, so its fp32 logits live only
    while that chunk's loss or gradient is computed.  Under a mesh with
    model ranks each chunk is vocab-parallel (:func:`_chunk_nll`); its
    collectives rerun in the backward's recomputation, in the same order on
    every rank.
    """
    B, S, D = x.shape
    n = S - 1
    xs, tg = x[:, :-1], tokens[:, 1:].long()
    c = min(chunk, n)
    nc = -(-n // c)
    pad = nc * c - n
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        tg = F.pad(tg, (0, pad))
    valid = (torch.arange(nc * c, device=x.device) < n).float()
    total = torch.zeros((), device=x.device)
    tie = cfg.tie_embeddings
    w, split = _table_shard(params, cfg, "table" if tie else "out")
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        total = total + _remat(_chunk_nll, w, xs[:, sl], tg[:, sl],
                               valid[sl], tie, split)
    return total / (B * n)


def loss_fn(params, batch, cfg: ModelConfig, rt: Runtime = DEFAULT_RT):
    """-> (loss, metrics). metrics carries the AMOEBA divergence signals:
    for an MoE model the load-balance loss (``moe_aux``), the mean expert
    load (``expert_load``, (E,)) and the dropped fraction, each averaged
    over the MoE layers.  Under a mesh ``batch`` holds this rank's rows and
    the loss is the whole batch's, the mean over the batch axes; the layers
    and the LM loss are tensor-parallel over 'model' (module docstring)."""
    x, positions, enc = embed_inputs(params, batch, cfg, rt)
    x, aux, _ = forward_hidden(params, x, positions, enc, cfg, rt)
    lm = _chunked_lm_loss(params, x, batch["tokens"], cfg, rt.loss_chunk)
    lm = collectives.pmean(lm, shardctx.batch_axes())
    loss = lm
    n_moe = sum(1 for k in cfg.layer_kinds if k != "ssm") or 1
    metrics = {"lm_loss": lm}
    if cfg.moe is not None:
        aux_mean = aux.aux_loss / n_moe
        loss = loss + cfg.moe.router_aux_loss * aux_mean
        metrics.update(moe_aux=aux_mean, expert_load=aux.load / n_moe,
                       dropped_frac=aux.dropped / n_moe)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode state: prefill + one-token step
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    pos: torch.Tensor          # (B,) next absolute position
    rope_offset: torch.Tensor  # (B,) rope_pos = pos + offset (M-RoPE)
    reps: Any                  # tuple per pattern position, stacked (R, B, ...)
    rest: Any                  # tuple per remainder layer, (B, ...)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      enc_len: int = 0, kv_quant: bool = False,
                      device="cuda") -> DecodeState:
    """Zero-initialized state sized for a seq_len-token context window.

    Attention caches hold ``min(seq_len, attn_window)`` slots; SSM and
    RG-LRU states are fixed-size; whisper's decoder blocks also hold a
    ``"cross"`` cache of ``enc_len`` encoder positions.
    """
    dev = resolve_device(device)
    pattern = _pattern(cfg)
    R, rem = divmod(cfg.num_layers, len(pattern))

    def one(kind, lead):
        if kind == "attn":
            st = {"self": attention.init_cache(
                cfg, batch, seq_len, num_layers=lead[0] if lead else None,
                quant=kv_quant, device=dev)}
            if cfg.cross_attention:
                z = torch.zeros(lead + (batch, enc_len, cfg.num_kv_heads,
                                        cfg.resolved_head_dim),
                                dtype=getattr(torch, cfg.dtype), device=dev)
                st["cross"] = KVCache(k=z, v=z.clone())
            return st
        if kind == "ssm":
            return {"self": ssm.init_ssm_state(cfg, batch, dev, lead)}
        return {"self": rglru.init_rglru_state(cfg, batch, dev, lead)}

    reps = tuple(one(kind, (R,)) for kind in pattern) if R else ()
    rest = tuple(one(pattern[j], ()) for j in range(rem))
    zeros = torch.zeros((batch,), dtype=torch.long, device=dev)
    return DecodeState(pos=zeros, rope_offset=zeros.clone(), reps=reps,
                       rest=rest)


def decode_state_pspecs(cfg: ModelConfig, kv_quant: bool = False):
    """PartitionSpec tree matching init_decode_state (leading layer dim on
    reps), with the 'batch' placeholder resolved by ``parallel.resolve``."""
    pattern = _pattern(cfg)
    R, rem = divmod(cfg.num_layers, len(pattern))

    def one(kind):
        if kind == "attn":
            st = {"self": attention.cache_pspec(quant=kv_quant)}
            if cfg.cross_attention:
                st["cross"] = KVCache(k=P("batch", None, None, None),
                                      v=P("batch", None, None, None))
            return st
        if kind == "ssm":
            return {"self": ssm.ssm_state_pspec()}
        return {"self": rglru.rglru_state_pspec()}

    reps = tuple(_lead(one(k)) for k in pattern) if R else ()
    rest = tuple(one(pattern[j]) for j in range(rem))
    return DecodeState(pos=P("batch"), rope_offset=P("batch"), reps=reps,
                       rest=rest)


def prefill(params, batch, cfg: ModelConfig, rt: Runtime = DEFAULT_RT,
            window: Optional[int] = None):
    """Full-sequence forward that also builds the decode state.

    Returns (last_logits (B, V), DecodeState).  ``window`` sets the decode
    horizon (cache length); defaults to the prompt length.  After a
    qwen2-vl vision prefix of V patches, text positions run ``i - V +
    side`` (``side = ceil(sqrt(V))``), so the state carries ``rope_offset
    = side - V`` for decode.
    """
    x, positions, enc = embed_inputs(params, batch, cfg, rt)
    x, _, (caches_rep, caches_rest) = forward_hidden(
        params, x, positions, enc, cfg, rt, build_cache=True,
        cache_window=window)
    logits = _lm_logits(params, x[:, -1:], cfg)[:, 0]
    B, S = batch["tokens"].shape
    dev = x.device
    offset = 0
    if cfg.vision_stub and "vision_embeds" in batch:
        V = batch["vision_embeds"].shape[1]
        offset = _mrope_side(V) - V
    return logits, DecodeState(
        pos=torch.full((B,), S, dtype=torch.long, device=dev),
        rope_offset=torch.full((B,), offset, dtype=torch.long, device=dev),
        reps=caches_rep or (), rest=caches_rest or ())


def decode_step(params, state: DecodeState, new_tokens: torch.Tensor,
                cfg: ModelConfig, rt: Runtime = DEFAULT_RT):
    """new_tokens: (B, 1) int -> (logits (B, V), new DecodeState).

    The layer states in ``state.reps`` are updated in place and carried
    into the returned state (attention writes its KV slot in place, see
    ``attention``; the recurrent states are copied into their layer's
    rows), so ``state`` itself must not be decoded from again.
    """
    pattern = _pattern(cfg)
    pos = state.pos
    rope_pos = pos + state.rope_offset
    emb = _table_shard(params, cfg, "table")
    x = layers.embed({"table": emb[0]}, new_tokens, tp=emb[1])  # (B,1,D)
    if cfg.encoder_layers:
        # sinusoidal position of the new token
        x = x + layers.sinusoidal_at(pos, cfg.d_model).to(x.dtype)[:, None]
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
    x = layers.rmsnorm(_whole(params["final_norm"]), x, cfg.norm_eps,
                       use_kernel=rt.use_kernels)
    logits = _lm_logits(params, x, cfg,
                        emb if cfg.tie_embeddings else None)[:, 0]
    return logits, DecodeState(pos=pos + 1, rope_offset=state.rope_offset,
                               reps=state.reps, rest=tuple(new_rest))
