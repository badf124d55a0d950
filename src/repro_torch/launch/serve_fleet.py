"""Fleet serving launcher: N reconfigurable pairs vs the static chips.

Counterpart of ``examples/serve_fleet.py``: replays one bursty long-tail
multi-tenant trace through three fleet configurations (all-fused,
all-split, AMOEBA-dynamic with length-aware routing) with
:func:`repro_torch.fleet.replay_modes`, and prints the fleet-wide
telemetry plus a per-group breakdown for the dynamic run.  On a CUDA
device the model runs through the hand-written kernels
(``Runtime(use_kernels=True)``); ``--device cpu`` runs their plain
versions.  ``--kv-quant`` keeps the KV cache in int8, every K/V vector
written through the int8 quantize kernel.

    PYTHONPATH=src python -m repro_torch.launch.serve_fleet --groups 4 \
        --horizon 120 [--kv-quant] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import AmoebaConfig
from repro_torch.fleet import bursty_longtail_trace, replay_modes
from repro_torch.models import transformer as T


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (Runtime.kv_quant)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    rt = T.Runtime(use_kernels=True, kv_quant=args.kv_quant)

    summaries = replay_modes(
        cfg, params, rt,
        lambda: bursty_longtail_trace(horizon=args.horizon,
                                      vocab_size=cfg.vocab_size,
                                      seed=args.seed),
        groups=args.groups, capacity=args.capacity,
        amoeba=AmoebaConfig(split_threshold=0.3, fuse_threshold=0.05,
                            min_phase_steps=2))

    dyn = summaries["amoeba_dynamic"]
    print("\namoeba_dynamic per-group:")
    for g in dyn["groups"]:
        print(f"  g{g['gid']} split={str(g['is_split']):5s} "
              f"eff={g['efficiency']:.3f} "
              f"splits={g['splits']} fuses={g['fuses']} "
              f"completed={g['completed']}")
    if "per_tenant" in dyn:
        for t, ts in dyn["per_tenant"].items():
            print(f"  tenant {t:6s} n={ts['n']:3d} "
                  f"p50={ts['p50']:5.1f} p99={ts['p99']:5.1f}")
    fus = summaries["static_fused"]
    print(f"\ndynamic vs static-fused: "
          f"p99 {fus['latency']['p99'] / max(dyn['latency']['p99'], 1e-9):.2f}x, "
          f"efficiency {dyn['efficiency'] / max(fus['efficiency'], 1e-9):.2f}x")
    print("device:", str(dev) if dev.type == "cpu"
          else torch.cuda.get_device_name(dev))


if __name__ == "__main__":
    main()
