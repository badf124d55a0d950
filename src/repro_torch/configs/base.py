"""Config schema for models, shapes, meshes, and the AMOEBA runtime.

Every assigned architecture gets one module in this package exporting
``CONFIG: ModelConfig``. The registry in ``__init__`` maps the dashed public
ids (``--arch deepseek-moe-16b``) onto those modules.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Fine-grained MoE: ``shared`` always-on experts + ``routed`` top-k."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    # arctic-style: a dense FFN residual branch that runs in parallel with MoE
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.001


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 block hyperparameters."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default: d_model // 16

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else max(1, d_model // 16)


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block hyperparameters."""
    lru_width: Optional[int] = None   # default: d_model
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // num_heads
    activation: str = "swiglu"                # swiglu | relu2 | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False                       # qwen2-vl 3-section M-RoPE
    mrope_sections: Sequence[int] = (16, 24, 24)  # fractions of head_dim//2
    attn_window: Optional[int] = None         # local (sliding window) attention
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    # block pattern for hybrid archs: tokens 'attn' | 'rglru' | 'ssm';
    # pattern tiles to num_layers.  None => all 'attn' (or all 'ssm' for ssm family)
    block_pattern: Optional[Sequence[str]] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # encoder-decoder (whisper): number of encoder layers; frontend is a stub
    # that consumes precomputed frame embeddings of shape (B, S, d_model).
    encoder_layers: int = 0
    cross_attention: bool = False
    # vlm: precomputed patch embeddings merged into the token stream.
    vision_stub: bool = False
    max_vision_tokens: int = 1024
    dtype: str = "bfloat16"

    # ---- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def layer_kinds(self) -> tuple:
        if self.block_pattern is None:
            kind = "ssm" if self.family == "ssm" else "attn"
            return tuple(kind for _ in range(self.num_layers))
        pat = list(self.block_pattern)
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def uses_rope(self) -> bool:
        """Whisper-style enc-dec stacks use sinusoidal positions, not RoPE."""
        return self.encoder_layers == 0

    @property
    def is_attention_free(self) -> bool:
        return all(k == "ssm" for k in self.layer_kinds)

    @property
    def supports_long_context(self) -> bool:
        """True when attention history is bounded (SSM state / local window)."""
        for k in self.layer_kinds:
            if k == "attn" and self.attn_window is None:
                return False
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytics ---------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count of the JAX implementation (repro.models)."""
        d, hd = self.d_model, self.resolved_head_dim
        q_dim = self.num_heads * hd
        kv_dim = self.num_kv_heads * hd
        n = 0
        # embeddings
        n += self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer_attn = d * q_dim + 2 * d * kv_dim + q_dim * d
        if self.qk_norm:
            per_layer_attn += 2 * hd
        if self.activation == "swiglu":
            per_layer_ffn = 3 * d * self.d_ff
        else:  # relu2 / gelu: up + down
            per_layer_ffn = 2 * d * self.d_ff
        for kind in self.layer_kinds:
            # pre-norms: ssm blocks are mixer-only (1 norm); others norm1+norm2
            n += d if kind == "ssm" else 2 * d
            if kind == "attn":
                n += per_layer_attn
            elif kind == "rglru":
                cfg = self.rglru or RGLRUConfig()
                w = cfg.lru_width or d
                # in/out proj (2 branches) + conv + gates (2) + lambda params
                n += 2 * d * w + w * d + cfg.conv_width * w + 2 * w * w + 2 * w
            elif kind == "ssm":
                cfg = self.ssm or SSMConfig()
                di = cfg.expand * d
                dtr = cfg.resolved_dt_rank(d)
                n += d * 2 * di            # in_proj (x and z branches)
                n += cfg.d_conv * di       # depthwise conv
                n += di * (dtr + 2 * cfg.d_state)  # x_proj
                n += dtr * di + di         # dt_proj
                n += di * cfg.d_state + di  # A_log, D
                n += di * d                # out_proj
            if kind != "ssm":
                if self.moe is not None:
                    m = self.moe
                    e_p = 3 * d * m.d_ff_expert if self.activation == "swiglu" \
                        else 2 * d * m.d_ff_expert
                    n += (m.num_experts + m.num_shared) * e_p
                    n += d * m.num_experts  # router
                    if m.dense_residual:
                        n += per_layer_ffn
                elif kind in ("attn", "rglru"):
                    # griffin-style blocks: every non-ssm block has an MLP
                    n += per_layer_ffn
        # encoder stack (whisper): same attn+ffn blocks + cross-attn in decoder
        if self.encoder_layers:
            enc = self.encoder_layers * (2 * d + per_layer_attn + per_layer_ffn)
            n += enc + d  # + encoder final norm
            if self.cross_attention:
                n += self.num_layers * (d + per_layer_attn)  # cross-attn + norm
        n += d  # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        e_p = (3 if self.activation == "swiglu" else 2) * self.d_model * m.d_ff_expert
        inactive = (m.num_experts - m.top_k) * e_p * sum(
            1 for k in self.layer_kinds if k != "ssm")
        return self.param_count() - inactive


# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES = {s.name: s for s in LM_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_* decode needs sub-quadratic attention (see DESIGN.md §4)."""
    if shape.name.startswith("long_") and not model.supports_long_context:
        return False
    return True


# ---------------------------------------------------------------------------
# Hardware model (the reference's TPU v5e and the port's H100)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareConfig:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bandwidth: float = 819e9        # B/s per chip
    ici_bandwidth: float = 50e9         # B/s per link
    hbm_bytes: float = 16 * 2**30       # per chip
    vmem_bytes: float = 128 * 2**20


V5E = HardwareConfig()

# NVIDIA H100 SXM data sheet (dense, no sparsity):
# https://www.nvidia.com/en-us/data-center/h100/ — 989 TFLOP/s bf16,
# 3.35 TB/s HBM3, 80 GB, 900 GB/s NVLink (450 GB/s each way).  These
# rates assume the 700 W power limit.
H100 = HardwareConfig(name="h100-sxm", peak_flops=989e12,
                      hbm_bandwidth=3.35e12, ici_bandwidth=450e9,
                      hbm_bytes=80e9, vmem_bytes=227 * 2**10)


# ---------------------------------------------------------------------------
# Runtime / AMOEBA controller configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AmoebaConfig:
    """Paper §4: controller + split/fuse policy knobs.

    ``policy`` selects the repro.control decision stack: ``threshold``
    (fixed-ratio hysteresis), ``predictor`` (logistic inference; needs
    ``predictor_path`` or an injected model), ``oracle`` (true
    slot-cost argmax — the upper bound), ``online`` (predictor with
    periodic refits from the replay buffer).
    """
    enabled: bool = True
    # fraction of divergent warps (mesh level: divergent requests / tokens)
    # above which a fused group splits — paper's fixed-ratio threshold.
    split_threshold: float = 0.25
    # hysteresis: re-fuse when divergence drops below this.
    fuse_threshold: float = 0.10
    # minimum steps between reconfigurations (amortize resharding cost).
    min_phase_steps: int = 8
    regroup_policy: str = "warp_regroup"   # "direct_split" | "warp_regroup"
    predictor_path: Optional[str] = None   # trained coefficient file
    # -- repro.control plane ------------------------------------------------
    policy: str = "threshold"       # threshold | predictor | oracle | online
    max_ways: int = 2               # max parts per group topology
    # heterogeneous compositions: allow unequal part sizes like (5, 3)
    # with per-part split/fuse moves; False pins the balanced
    # power-of-two ladder (1x8/2x4/4x2) with whole-group moves
    hetero: bool = True
    min_gain: float = 0.0           # amortization floor for further splits
    proba_band: float = 0.10        # predictor hysteresis band around 0.5
    oracle_margin: float = 0.02     # oracle's required improvement to move
    refit_every: int = 64           # online: decisions between refits
    replay_capacity: int = 4096     # online: replay buffer size
    label_margin: float = 0.02      # realized-win labeling threshold

    def replace(self, **kw) -> "AmoebaConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MigrationConfig:
    """Chip-level work stealing and KV-costed request migration.

    Knobs for :class:`repro.fleet.migrate.MigrationPlanner`.  Queue
    steals move *queued* requests from an overflowing group to a
    starving group's best-fitting part (no state travels, only the
    prompt).  Live migrations move *in-flight* requests with their
    decode state; the KV transfer is priced by
    :class:`repro.fleet.migrate.KVTransferCost` — bytes follow from the
    request's sequence length and the model config, the configured
    ``link_bandwidth`` converts them into stall ticks charged to the
    destination part — and the move must clear ``min_gain`` on the same
    normalized move-gain scale the topology lattice uses.
    """
    enabled: bool = False
    # plan cadence in wall ticks when FleetConfig.rebalance_every == 0
    # (when rebalancing is on, plans ride the rebalance tick instead)
    every: int = 4
    steal_threshold: int = 2        # donor queue depth that opens stealing
    max_steals: int = 4             # queue steals per plan tick
    live: bool = True               # allow KV-costed live migrations
    max_live: int = 1               # live migrations per plan tick
    link_bandwidth: float = 4e9     # KV bytes per wall tick over the link
    kv_dtype_bytes: int = 2         # bf16 KV cache entries
    # ship the KV cache int8-quantized (kernels/quantize.py row layout:
    # one int8 code per entry + one fp32 scale per row) — ~4x fewer
    # migration bytes, so live moves amortize at lower bandwidths
    quantized_kv: bool = False
    min_gain: float = 0.02          # amortization floor (move_gain scale)
    # admission spill: when a router-pinned group's expected ticks-to-
    # drain (the planner's pressure view) exceeds this, sticky admissions
    # spill to the least-pressured group instead; 0 disables
    spill_threshold: float = 0.0

    def replace(self, **kw) -> "MigrationConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class LeaseConfig:
    """Slack leases: sub-reconfiguration slot borrowing between parts.

    Knobs for :class:`repro.fleet.lease.LeasePlanner`.  A part with idle
    slots lends them to a sibling part — same group, or an adjacent
    same-chip group over the NoC — for a bounded term: no topology
    move, no dwell clock, no reconfiguration stall.  The borrowed slots
    widen the borrower part's next admission wave; the lender's
    resident budget shrinks by the same amount, so fleet-wide effective
    capacity is conserved.  Each grant must clear ``min_gain`` on the
    same normalized ``move_gain`` scale the topology lattice and the
    migration planner use: gain = borrowed-queue drain minus the
    lender's expected backfill loss over the term, over the lender's
    fused cost.
    """
    enabled: bool = False
    # ticks a lease may run before it expires (the bounded term)
    max_term: int = 16
    # max fraction of a part's slot budget out on lease at once; the
    # planner additionally always keeps >= 1 resident slot per part
    max_frac: float = 0.5
    # lender pressure (expected ticks-to-drain) that force-revokes its
    # outstanding leases early — the lender's own queue heated up
    revoke_threshold: float = 4.0
    max_grants: int = 2             # new grants per plan tick
    min_gain: float = 0.02          # amortization floor (move_gain scale)

    def replace(self, **kw) -> "LeaseConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ClusterConfig:
    """Hierarchical fleet-of-fleets on a 2D chip mesh with tiered links.

    Knobs for ``repro.cluster``: groups sit at 2D coordinates and are
    partitioned into chips (optionally grouped further into nodes);
    moving state between two groups is priced by the *tier* of the pair
    — intra-chip NoC, inter-chip link, or inter-node network — with a
    per-hop latency on top of the bandwidth term (see
    :class:`repro.cluster.TieredTransferCost`).  The
    :class:`repro.cluster.ClusterController` steers each chip's
    split-mix, authorizes cross-chip steals/live-migrations only when
    the tiered cost amortizes, and gathers regions of adjacent groups
    for long-context tail mass (``region_*``).
    """
    groups_per_chip: int = 4
    chips_per_node: Optional[int] = None   # None = every chip on one node
    # per-tier transfer: bytes per wall tick + per-hop latency ticks
    noc_bandwidth: float = 4e9      # intra-chip network-on-chip
    noc_latency: float = 0.0
    link_bandwidth: float = 2e8     # inter-chip link (same node)
    link_latency: float = 1.0
    net_bandwidth: float = 5e7      # inter-node network
    net_latency: float = 4.0
    # A/B baseline: plan with the flat (distance-blind) cost model over
    # one global pool; execution still pays the true tiered costs
    distance_blind: bool = False
    max_cross_steals: int = 2       # cross-chip steals per plan tick
    # region gather: fuse adjacent same-chip groups into one deep
    # logical group while the chip's long-tail mass persists
    region_gather: bool = True
    region_long_frac: float = 0.5   # chip long fraction that opens a region
    region_release_frac: float = 0.2
    region_max_groups: int = 2
    region_dwell: int = 24          # min ticks a region stays gathered

    def replace(self, **kw) -> "ClusterConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FleetConfig:
    """A serving fleet of N independently reconfigurable pairs.

    The serving analogue of the paper's full chip (24 SM pairs, each free
    to fuse or split on its own): ``num_groups`` pairs behind one request
    router.  ``mode`` pins every pair's allowed configuration — ``fused``
    and ``split`` are the static baselines, ``dynamic`` is AMOEBA.
    """
    num_groups: int = 4
    capacity: int = 8               # decode slots per pair (fused width)
    window: int = 256               # KV window passed to prefill
    # round_robin | least_loaded | length_aware | sticky
    router: str = "least_loaded"
    mode: str = "dynamic"           # dynamic | fused | split
    # tick engine: "object" decodes real tokens through the jitted model
    # (per-part jax calls); "vec" is the struct-of-arrays core
    # (repro.fleet.vec) — same control plane, same summary stats, no
    # model, orders of magnitude faster for scheduling-only sweeps
    engine: str = "object"
    long_threshold: int = 24        # length_aware: predicted-long cutoff
    telemetry_window: int = 256     # rolling-stat window, wall ticks
    # chip-level FleetController: re-evaluate the fleet's split mix every
    # N wall ticks (0 = no chip-wide rebalancing; groups act alone)
    rebalance_every: int = 0
    # cross-group work stealing / live migration (repro.fleet.migrate)
    migrate: MigrationConfig = MigrationConfig()
    # slack leases: bounded slot borrowing below the reconfiguration
    # layer (repro.fleet.lease)
    lease: LeaseConfig = LeaseConfig()
    # reserve a 1-slot quarantine part on this group (exact-composition
    # fleet hint); reserved parts are steal-ineligible for the planner
    quarantine_group: Optional[int] = None
    amoeba: AmoebaConfig = AmoebaConfig()
    # the hierarchical layer above the fleet (repro.cluster): groups on
    # a 2D chip mesh with tiered transfer costs; None = flat fleet
    cluster: Optional[ClusterConfig] = None
    # structured event tracing (repro.obs): "off" keeps summaries
    # bit-identical, "summary" counts events, "full" retains the ring
    # buffer + per-tick metrics for the exporters and decision audit
    obs: str = "off"

    def replace(self, **kw) -> "FleetConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    zero1: bool = True                      # shard optimizer state over data axis
    remat: str = "full"                     # none | full
    micro_steps: int = 1                    # gradient-accumulation microbatches
    grad_compression: bool = False          # int8 DP all-reduce compression
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """A named factorization of the chip grid (an AMOEBA 'plan')."""
    name: str
    shape: tuple
    axes: tuple

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n
