"""Work-stealing launcher: cross-group migration on an imbalanced fleet.

Counterpart of ``examples/work_stealing.py``; the chip-level scheduling
story of ``repro_torch.fleet.migrate``, end to end:

1. **KVTransferCost** — what moving a live request costs: KV bytes as a
   function of sequence length and the model config, turned into
   destination-part stall ticks by the link bandwidth.

2. **Fleet A/B** — replay one shard-skewed trace (``imbalanced_trace``:
   a hot router shard hammers one group under sticky routing while its
   neighbors starve) through the same fleet with migration disabled and
   enabled, and compare p99 latency plus the steal/migration counters.
   On a CUDA device the model runs through the hand-written kernels
   (``Runtime(use_kernels=True)``); ``--device cpu`` runs their plain
   versions.

    PYTHONPATH=src python -m repro_torch.launch.work_stealing --horizon 60 \
        [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (AmoebaConfig, FleetConfig,
                                      MigrationConfig)
from repro_torch.fleet import FleetEngine, KVTransferCost, imbalanced_trace
from repro_torch.models import transformer as T
from repro_torch.serve.engine import make_decode_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    out = {"cost": {}, "fleet": {}}

    # -- 1: the transfer-cost model -----------------------------------------
    print("== KVTransferCost: what a live migration costs ==")
    cost = KVTransferCost(link_bandwidth=4e9)
    for seq in (16, 64, 256):
        b = cost.kv_bytes(seq, cfg)
        stall = cost.stall_ticks(seq, cfg)
        out["cost"][seq] = (b, stall)
        print(f"  seq_len={seq:4d}: {b/1e6:7.3f} MB "
              f"-> stall {stall:.0f} tick(s)")
    zero = KVTransferCost(link_bandwidth=0).stall_ticks(64, cfg)
    out["cost"]["zero_bandwidth"] = zero
    print(f"  zero-bandwidth link: stall = {zero} "
          f"(live migration never amortizes; steals still flow)")

    # -- 2: fleet A/B — stealing off vs on ----------------------------------
    print("\n== fleet: sticky routing on a shard-skewed trace ==")
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    rt = T.Runtime(use_kernels=True, production=False, remat=False)
    decode = make_decode_fn(cfg, rt)
    amoeba = AmoebaConfig(split_threshold=0.3, fuse_threshold=0.05,
                          min_phase_steps=2)
    for label, mig in (("no_stealing", MigrationConfig(enabled=False)),
                       ("stealing", MigrationConfig(enabled=True))):
        trace = imbalanced_trace(horizon=args.horizon,
                                 vocab_size=cfg.vocab_size,
                                 seed=args.seed, shards=args.groups)
        eng = FleetEngine(cfg, params, rt=rt, decode_fn=decode,
                          fleet=FleetConfig(
                              num_groups=args.groups,
                              capacity=args.capacity,
                              router="sticky", mode="dynamic",
                              rebalance_every=4, migrate=mig,
                              amoeba=amoeba))
        eng.submit(trace)
        s = eng.run()
        out["fleet"][label] = s
        lat = s["latency"]
        line = (f"  {label:12s} ticks={s['wall_ticks']:4d} "
                f"p50={lat['p50']:5.1f} p99={lat['p99']:5.1f} "
                f"util={s['utilization']:.2f}")
        mig_s = s.get("migration")
        if mig_s:
            line += (f"  steals={mig_s['steals']} "
                     f"live={mig_s['live_migrations']} "
                     f"stall={mig_s['stall_ticks']}")
        print(line)
    print("device:", str(dev) if dev.type == "cpu"
          else torch.cuda.get_device_name(dev))
    return out


if __name__ == "__main__":
    main()
