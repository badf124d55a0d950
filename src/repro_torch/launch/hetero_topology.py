"""Heterogeneous-topology launcher: the composition lattice end to end.

Counterpart of ``examples/hetero_topology.py``; the paper's §5 headline
capability, "dynamic creation of heterogeneous SMs through independent
fusing or splitting", at four levels:

1. **ConfigSpace lattice** — enumerate the composition topologies of a
   capacity-8 group, show the skew-aware partitioner picking the
   ``(5, 3)`` cut that no equal-ways ladder can express.

2. **GroupController walk** — feed a skewed batch through the oracle
   policy and watch the controller climb the lattice one amortization-
   checked per-part move at a time.

3. **gpusim static chips (Fig 12)** — rank heterogeneous chip
   compositions (n fused pairs + rest split) and see workloads whose
   best static chip is a *mix*, not either homogeneous end.

4. **Fleet A/B** — replay one skewed long-tail trace through an
   equal-ladder fleet and a heterogeneous-composition fleet and compare
   p99 latency / slot efficiency.  On a CUDA device the model runs through
   the hand-written kernels (``Runtime(use_kernels=True)``); ``--device
   cpu`` runs their plain versions.

    PYTHONPATH=src python -m repro_torch.launch.hetero_topology \
        --horizon 60 [--device cpu] [--skip-fleet]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import AmoebaConfig, FleetConfig
from repro_torch.control import (ConfigSpace, FeatureVector, GroupController,
                                 OraclePolicy, topology_name)
from repro_torch.core.gpusim import WORKLOADS, rank_chip_mixes
from repro_torch.fleet import FleetEngine, skewed_longtail_trace
from repro_torch.models import transformer as T
from repro_torch.serve.engine import make_decode_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--skip-fleet", action="store_true",
                    help="lattice + gpusim only (no model init)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = {}

    # -- 1: the composition lattice -----------------------------------------
    print("== ConfigSpace: composition lattice ==")
    sp = ConfigSpace(capacity=args.capacity, max_ways=args.capacity)
    comps = sp.compositions()
    print(f"capacity={args.capacity}: {len(comps)} topologies "
          f"(ladder had {len(sp.topologies())})")
    skew = np.array([2.0, 2.0, 2.0, 2.0, 2.0, 90.0, 90.0, 90.0]
                    [:args.capacity])
    best, gain = sp.best_topology(skew)
    print(f"skewed batch {skew.astype(int).tolist()}:")
    print(f"  best topology   {topology_name(best, args.capacity):10s} "
          f"gain={gain:.3f}")
    print(f"  balanced pair   {topology_name(2, args.capacity):10s} "
          f"gain={sp.gain(skew, 2):.3f}")
    parts = sp.partition(list(range(skew.size)), skew, best)
    for slots, p in zip(best, parts):
        lens = [int(skew[i]) for i in p]
        print(f"  part x{slots} slots <- remaining {lens}")
    out["lattice"] = dict(compositions=len(comps),
                          ladder=len(sp.topologies()), best=tuple(best),
                          gain=gain, pair_gain=sp.gain(skew, 2),
                          parts=[list(p) for p in parts])

    # -- 2: the controller climbs the lattice -------------------------------
    print("\n== GroupController: per-part moves under the oracle ==")
    gc = GroupController(OraclePolicy(space=sp, margin=0.01), sp, dwell=1)
    fv = FeatureVector.from_group(skew, 0, 0.0, args.capacity)
    for _ in range(6):
        gc.observe(fv)
    for step, frm, to, g, reason in gc.state.transitions:
        print(f"  tick {step}: {sp.name(frm)} -> {sp.name(to)} "
              f"(gain {g:.3f}; {reason})")
    out["walk"] = [(step, sp.name(frm), sp.name(to), g, reason)
                   for step, frm, to, g, reason in gc.state.transitions]

    # -- 3: gpusim heterogeneous static chips (Fig 12) ----------------------
    print("\n== gpusim: static chip-composition ranking ==")
    out["chips"] = {}
    for name in ("SM", "RAY", "CP"):
        rows = rank_chip_mixes(WORKLOADS[name], epochs=16)
        tag = " <- heterogeneous wins" \
            if 0 < rows[0]["n_fused"] < 24 else ""
        print(f"  {name:4s} best {rows[0]['mix']:8s} "
              f"ipc={rows[0]['ipc']:.1f}{tag}")
        out["chips"][name] = (rows[0]["mix"], rows[0]["ipc"])

    if args.skip_fleet:
        return out

    # -- 4: fleet A/B — ladder vs compositions ------------------------------
    print("\n== fleet: equal ladder vs heterogeneous compositions ==")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    rt = T.Runtime(use_kernels=True, production=False, remat=False)
    decode = make_decode_fn(cfg, rt)
    base = AmoebaConfig(split_threshold=0.3, fuse_threshold=0.05,
                        min_phase_steps=2, policy="oracle",
                        max_ways=min(args.capacity, 8))
    out["fleet"] = {}
    for label, hetero in (("equal-ladder", False), ("heterogeneous", True)):
        trace = skewed_longtail_trace(horizon=args.horizon,
                                      vocab_size=cfg.vocab_size,
                                      seed=args.seed)
        eng = FleetEngine(cfg, params, rt=rt, decode_fn=decode,
                          fleet=FleetConfig(
                              num_groups=args.groups,
                              capacity=args.capacity,
                              router="length_aware", mode="dynamic",
                              amoeba=base.replace(hetero=hetero)))
        eng.submit(trace)
        s = eng.run()
        out["fleet"][label] = s
        lat = s["latency"]
        topos = s["control"].get("topologies_visited", [])
        print(f"  {label:14s} eff={s['efficiency']:.3f} "
              f"p50={lat['p50']:5.1f} p99={lat['p99']:5.1f} "
              f"topologies={['+'.join(map(str, t)) for t in topos]}")
    print("device:", str(dev) if dev.type == "cpu"
          else torch.cuda.get_device_name(dev))
    return out


if __name__ == "__main__":
    main()
