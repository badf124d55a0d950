"""2D chip-mesh geometry and the tiered transfer-cost model.

AMOEBA's design-parameter study makes the NoC a first-order term: how
far fusing pays off depends on what moving state between cores costs,
and that cost is not flat — it depends on where the cores sit.  The
fleet layer prices every migration over one ``link_bandwidth`` as if all
groups were equidistant.  This module adds the missing geometry:

* :class:`ClusterMesh` places every group at a 2D coordinate and
  partitions groups into **chips** (and chips into **nodes**), following
  the mesh-of-Amlets shape: a chip is a small contiguous tile of groups
  wired by a fast network-on-chip, chips on one node share a board-level
  link, and nodes talk over the datacenter network.

* :class:`TieredTransferCost` generalizes
  :class:`repro_torch.fleet.migrate.KVTransferCost`: the bytes model is
  inherited unchanged (including quantized int8 pricing), but the
  stall conversion picks per-**tier** bandwidth and a per-hop latency
  from the pair's position — intra-chip NoC, inter-chip link, or
  inter-node network — so a same-chip move can amortize where the
  identical move across nodes is vetoed.  A zero bandwidth on any tier
  prices that tier at infinity, which vetoes every move that must cross
  it while leaving the cheaper tiers flowing.

Counterpart of ``repro/cluster/mesh.py``, with its own copy of ``TIERS``
and ``TOKEN_BYTES``.  int8 pricing stays on the int8 wire layout of
:class:`~repro_torch.fleet.migrate.KVTransferCost`, including its one
scale per cached row (2.7 % under the int8 cache's bytes for qwen3-14b),
so tiered stalls equal the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import List, Optional, Tuple

from repro_torch.configs.base import ClusterConfig, ModelConfig
from repro_torch.fleet.migrate import KVTransferCost

# transfer tiers, cheapest first; "self" (same group) never transfers
TIERS = ("noc", "link", "net")

# a pinned request handoff (a queue steal) ships the prompt tokens, not
# the KV cache; int32 token ids on the wire
TOKEN_BYTES = 4


@dataclass(frozen=True)
class ClusterMesh:
    """Group placement: chips of groups tiled on a 2D grid.

    Groups ``[0, num_groups)`` are assigned to chips contiguously
    (``chip_of(g) = g // groups_per_chip``).  Each chip lays its groups
    out row-major on a near-square sub-grid, and the chips themselves
    tile row-major on a near-square chip grid, so every group gets a
    global ``(x, y)`` coordinate and distances are Manhattan hop counts
    — the standard 2D-mesh NoC metric.
    """
    num_groups: int
    groups_per_chip: int = ClusterConfig.groups_per_chip
    chips_per_node: Optional[int] = ClusterConfig.chips_per_node

    def __post_init__(self):
        if self.num_groups < 1 or self.groups_per_chip < 1:
            raise ValueError("mesh needs >=1 group and >=1 group per chip")
        if self.chips_per_node is not None and self.chips_per_node < 1:
            raise ValueError("chips_per_node must be >=1 (or None)")

    # -- partition -------------------------------------------------------------

    @property
    def num_chips(self) -> int:
        return -(-self.num_groups // self.groups_per_chip)

    @property
    def num_nodes(self) -> int:
        if self.chips_per_node is None:
            return 1
        return -(-self.num_chips // self.chips_per_node)

    def chip_of(self, gi: int) -> int:
        return gi // self.groups_per_chip

    def node_of(self, ci: int) -> int:
        return 0 if self.chips_per_node is None else ci // self.chips_per_node

    def chip_groups(self, ci: int) -> List[int]:
        lo = ci * self.groups_per_chip
        return list(range(lo, min(lo + self.groups_per_chip,
                                  self.num_groups)))

    # -- geometry --------------------------------------------------------------

    @cached_property
    def _chip_cols(self) -> int:
        return max(int(math.ceil(math.sqrt(self.groups_per_chip))), 1)

    @cached_property
    def _chip_shape(self) -> Tuple[int, int]:
        w = self._chip_cols
        return w, -(-self.groups_per_chip // w)

    @cached_property
    def _grid_cols(self) -> int:
        return max(int(math.ceil(math.sqrt(self.num_chips))), 1)

    def coord(self, gi: int) -> Tuple[int, int]:
        """Global 2D coordinate of group ``gi``."""
        if not 0 <= gi < self.num_groups:
            raise IndexError(f"group {gi} outside mesh of {self.num_groups}")
        ci, li = divmod(gi, self.groups_per_chip)
        w, h = self._chip_shape
        ox, oy = (ci % self._grid_cols) * w, (ci // self._grid_cols) * h
        return ox + li % w, oy + li // w

    def hops(self, a: int, b: int) -> int:
        """Manhattan distance between two groups' coordinates."""
        (ax, ay), (bx, by) = self.coord(a), self.coord(b)
        return abs(ax - bx) + abs(ay - by)

    def adjacent(self, a: int, b: int) -> bool:
        """Same-chip nearest neighbors — region-gather's fuse criterion."""
        return a != b and self.chip_of(a) == self.chip_of(b) \
            and self.hops(a, b) == 1

    def tier(self, a: int, b: int) -> str:
        """Transfer tier of the pair: self | noc | link | net."""
        if a == b:
            return "self"
        ca, cb = self.chip_of(a), self.chip_of(b)
        if ca == cb:
            return "noc"
        if self.node_of(ca) == self.node_of(cb):
            return "link"
        return "net"

    def layout(self) -> dict:
        """JSON-able placement map for trace exporters (repro_torch.obs).

        Keys are strings so the dict survives a JSONL round-trip
        unchanged — json object keys are always strings.
        """
        return {
            "num_groups": self.num_groups,
            "groups_per_chip": self.groups_per_chip,
            "chips_per_node": self.chips_per_node,
            "chip_of": {str(g): self.chip_of(g)
                        for g in range(self.num_groups)},
            "node_of_chip": {str(c): self.node_of(c)
                             for c in range(self.num_chips)},
            "coord": {str(g): list(self.coord(g))
                      for g in range(self.num_groups)},
        }

    def describe(self) -> str:
        """One line per chip — the example/demo layout dump."""
        lines = []
        for ci in range(self.num_chips):
            coords = ", ".join(f"g{g}@{self.coord(g)}"
                               for g in self.chip_groups(ci))
            lines.append(f"chip {ci} (node {self.node_of(ci)}): {coords}")
        return "\n".join(lines)


@dataclass(frozen=True)
class TieredTransferCost(KVTransferCost):
    """Distance-tiered pricing for moving state between groups.

    The bytes model is the parent's (attention KV rows + recurrent
    state, window-capped, optionally int8-quantized); only the
    bytes-to-stall conversion changes.  A transfer between groups
    ``src`` and ``dst`` is priced

    ``ticks = ceil(hop_latency(tier) * hops(src, dst) + bytes / bandwidth(tier))``

    with ``(bandwidth, hop_latency)`` chosen by the pair's tier — the
    wormhole-routing shape where the head of the message pays one
    latency per hop while the body streams at the bottleneck tier's
    bandwidth.  Without ``src``/``dst`` the parent's flat pricing
    applies (``link_bandwidth``, no hop term), so a tiered cost object
    degrades gracefully wherever a flat one is expected.
    """
    mesh: Optional[ClusterMesh] = None
    noc_bandwidth: float = ClusterConfig.noc_bandwidth
    noc_latency: float = ClusterConfig.noc_latency
    # link_bandwidth inherited: the inter-chip tier
    link_latency: float = ClusterConfig.link_latency
    net_bandwidth: float = ClusterConfig.net_bandwidth
    net_latency: float = ClusterConfig.net_latency

    @classmethod
    def from_config(cls, mesh: ClusterMesh, ccfg: ClusterConfig,
                    dtype_bytes: int, quantized: bool
                    ) -> "TieredTransferCost":
        return cls(mesh=mesh, dtype_bytes=dtype_bytes, quantized=quantized,
                   noc_bandwidth=ccfg.noc_bandwidth,
                   noc_latency=ccfg.noc_latency,
                   link_bandwidth=ccfg.link_bandwidth,
                   link_latency=ccfg.link_latency,
                   net_bandwidth=ccfg.net_bandwidth,
                   net_latency=ccfg.net_latency)

    def tier_params(self, tier: str) -> Tuple[float, float]:
        """(bandwidth bytes/tick, per-hop latency ticks) for a tier."""
        return {"noc": (self.noc_bandwidth, self.noc_latency),
                "link": (self.link_bandwidth, self.link_latency),
                "net": (self.net_bandwidth, self.net_latency)}[tier]

    def transfer_ticks(self, nbytes: int, src: Optional[int],
                       dst: Optional[int]) -> float:
        """Wall ticks for ``nbytes`` between two groups (0 if same)."""
        if src is None or dst is None or self.mesh is None:
            # flat fallback: the parent's link pricing, no hop term
            if self.link_bandwidth <= 0:
                return math.inf
            return math.ceil(nbytes / self.link_bandwidth)
        tier = self.mesh.tier(src, dst)
        if tier == "self":
            return 0.0
        bw, lat = self.tier_params(tier)
        if bw <= 0:
            return math.inf
        t = lat * self.mesh.hops(src, dst) + nbytes / bw
        # the wall tick is the cost quantum: a transfer that fits in a
        # fraction of a tick (a NoC hop) hides behind the decode tick,
        # and a vanishing bandwidth term must not bump an exact integer
        # latency to the next tick
        return math.ceil(t - 1e-6) if t >= 1.0 else 0.0

    def stall_ticks(self, seq_len: int, model_cfg: ModelConfig,
                    window: Optional[int] = None,
                    src: Optional[int] = None,
                    dst: Optional[int] = None) -> float:
        return self.transfer_ticks(self.kv_bytes(seq_len, model_cfg, window),
                                   src, dst)

    def steal_ticks(self, prompt_len: int, src: Optional[int],
                    dst: Optional[int]) -> float:
        """In-flight ticks for a queue steal (only the prompt travels)."""
        return self.transfer_ticks(max(int(prompt_len), 1) * TOKEN_BYTES,
                                   src, dst)
