"""Cluster-mesh launcher: hierarchical fleet-of-fleets with tiered costs.

Counterpart of ``examples/cluster_mesh.py``, the ``repro_torch.cluster``
layer end to end:

1. **ClusterMesh** — groups at 2D coordinates, tiled into chips (and
   chips into nodes); distances are Manhattan hops, and every pair of
   groups sits on a transfer tier: intra-chip NoC, inter-chip link, or
   inter-node network.

2. **TieredTransferCost** — the same KV bytes model the flat planner
   prices, walked across the tiers: a same-chip hop hides behind the
   decode tick while the identical transfer across chips pays per-hop
   latency over a slow wire, and a zero-bandwidth tier prices at
   infinity (the veto).

3. **Cluster A/B** — one multi-chip imbalanced trace (a hot chip bursts
   fat-tailed work while the other chips trickle) replayed through the
   same mesh twice: ``hierarchical`` (chip-first stealing, amortized
   crossings) vs ``flat_blind`` (``ClusterConfig.distance_blind``: one
   flat pool at plan time, physical tier prices at execution).

On a CUDA device the model runs through the hand-written kernels
(``Runtime(use_kernels=True)``); ``--device cpu`` runs their plain
versions.  ``--kv-quant`` keeps the KV cache in int8 and prices moves on
the int8 wire layout.

    PYTHONPATH=src python -m repro_torch.launch.serve_cluster --horizon 40 \
        [--kv-quant] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.cluster import ClusterEngine, ClusterMesh, TieredTransferCost
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (AmoebaConfig, ClusterConfig,
                                      FleetConfig, MigrationConfig)
from repro_torch.fleet import multichip_imbalanced_trace
from repro_torch.models import transformer as T
from repro_torch.serve.engine import make_decode_fn


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=2)
    ap.add_argument("--groups-per-chip", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (Runtime.kv_quant)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    groups = args.chips * args.groups_per_chip

    # -- 1: the mesh ---------------------------------------------------------
    print("== ClusterMesh: groups tiled into chips on a 2D grid ==")
    mesh = ClusterMesh(num_groups=groups,
                       groups_per_chip=args.groups_per_chip)
    print(mesh.describe())

    # -- 2: tiered pricing ---------------------------------------------------
    print("\n== TieredTransferCost: one transfer, three distances ==")
    ccfg = ClusterConfig(groups_per_chip=args.groups_per_chip,
                         link_bandwidth=256.0, link_latency=12.0,
                         net_bandwidth=64.0, net_latency=24.0)
    cost = TieredTransferCost.from_config(mesh, ccfg, dtype_bytes=2,
                                          quantized=args.kv_quant)
    seq = 32
    nbytes = cost.kv_bytes(seq, cfg, window=256)
    pairs = [(0, 1)]
    if groups > args.groups_per_chip:
        pairs.append((0, args.groups_per_chip))
        pairs.append((0, groups - 1))
    for a, b in pairs:
        tier = mesh.tier(a, b)
        print(f"  g{a} -> g{b} ({tier:4s}, {mesh.hops(a, b)} hops): "
              f"{nbytes / 1e3:6.1f} KB of seq={seq} KV -> "
              f"stall {cost.stall_ticks(seq, cfg, window=256, src=a, dst=b):.0f} "
              f"tick(s)")
    dead = TieredTransferCost.from_config(
        mesh, ccfg.replace(link_bandwidth=0.0, net_bandwidth=0.0),
        dtype_bytes=2, quantized=args.kv_quant)
    print(f"  dead inter-chip tiers: cross-chip stall = "
          f"{dead.stall_ticks(seq, cfg, src=0, dst=groups - 1)} "
          f"(crossings vetoed; the NoC keeps flowing)")

    # -- 3: cluster A/B — hierarchical vs distance-blind ---------------------
    print("\n== cluster: one hot chip, tiered links, two cost models ==")
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    rt = T.Runtime(use_kernels=True, kv_quant=args.kv_quant)
    decode = make_decode_fn(cfg, rt)
    amoeba = AmoebaConfig(split_threshold=0.3, fuse_threshold=0.05,
                          min_phase_steps=2)
    for label, cluster in (("flat_blind", ccfg.replace(distance_blind=True)),
                           ("hierarchical", ccfg)):
        trace = multichip_imbalanced_trace(
            horizon=args.horizon, vocab_size=cfg.vocab_size,
            seed=args.seed, chips=args.chips,
            groups_per_chip=args.groups_per_chip)
        eng = ClusterEngine(cfg, params, rt=rt, decode_fn=decode,
                            fleet=FleetConfig(
                                num_groups=groups, capacity=args.capacity,
                                router="sticky", mode="dynamic",
                                rebalance_every=4,
                                migrate=MigrationConfig(
                                    enabled=True,
                                    quantized_kv=args.kv_quant),
                                amoeba=amoeba, cluster=cluster))
        eng.submit(trace)
        s = eng.run()
        lat, m, cl = s["latency"], s["migration"], s["cluster"]
        print(f"  {label:12s} ticks={s['wall_ticks']:4d} "
              f"p50={lat['p50']:5.1f} p99={lat['p99']:5.1f} "
              f"steals noc={m['intra_chip_steals']} "
              f"cross={m['cross_chip_steals']} "
              f"vetoed={m['vetoed_cross_chip']} "
              f"link_stall={cl['tier_stall_ticks']['link']}")
    print("device:", str(dev) if dev.type == "cpu"
          else torch.cuda.get_device_name(dev))


if __name__ == "__main__":
    main()
