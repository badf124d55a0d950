"""Control-plane launcher: one policy stack from the simulator to the fleet.

Counterpart of ``examples/control_plane.py``; the two levels of the
unified ``repro_torch.control`` plane:

1. **gpusim level** — build the paper's offline corpus (§4.1.3: run both
   static configurations, label with the winner), train the logistic
   scalability predictor, and drive the simulator's per-kernel fuse
   decision through the shared ``PredictorPolicy``, against the run-both
   oracle.

2. **fleet level** — serve a bursty long-tail trace under
   ``OnlinePolicy``: the fleet starts on the threshold rule, logs
   (features, realized-win) samples into the telemetry replay buffer,
   refits its logistic model mid-run, and finishes predictor-in-the-loop.
   On a CUDA device the model runs through the hand-written kernels
   (``Runtime(use_kernels=True)``); ``--device cpu`` runs their plain
   versions.

    PYTHONPATH=src python -m repro_torch.launch.control_plane --horizon 80 \
        [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import AmoebaConfig, FleetConfig
from repro_torch.control import PredictorPolicy
from repro_torch.core.gpusim import WORKLOADS, profile_features
from repro_torch.core.gpusim.corpus import train_sim_predictor
from repro_torch.core.gpusim.sim import run_benchmark
from repro_torch.fleet import FleetEngine, bursty_longtail_trace
from repro_torch.models import transformer as T


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=80)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", type=int, default=4,
                    help="gpusim corpus variants per workload")
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # -- level 1: the paper's offline predictor drives the simulator --------
    print("== gpusim: offline corpus -> logistic predictor ==")
    model, info = train_sim_predictor(variants_per_workload=args.variants,
                                      seed=args.seed, epochs=24)
    print(f"corpus n={info['n']}  train_acc={info['train_accuracy']:.3f}  "
          f"base-profile acc={info['base_profile_accuracy']:.3f}")
    policy = PredictorPolicy(model=model, positive_means_split=False)
    decisions, agree = {}, 0
    for name, w in WORKLOADS.items():
        fused = policy.choose_static(profile_features(w))
        a = run_benchmark(w, "baseline", epochs=24)
        b = run_benchmark(w, "scale_up", epochs=24)
        agree += fused == (b.ipc > a.ipc)
        decisions[name] = (bool(fused), bool(b.ipc > a.ipc))
        print(f"  {name:4s} predictor says {'fuse ' if fused else 'split'} "
              f"(oracle: {'fuse' if b.ipc > a.ipc else 'split'})")
    print(f"predictor/oracle agreement: {agree}/{len(WORKLOADS)}")
    out["gpusim"] = dict(n=info["n"], train_accuracy=info["train_accuracy"],
                         base_profile_accuracy=info["base_profile_accuracy"],
                         decisions=decisions, agree=agree)

    # -- level 2: the same stack, online, in the serving fleet --------------
    print("\n== fleet: bursty long-tail trace under OnlinePolicy ==")
    cfg = get_config(args.arch, reduced=True)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    trace = bursty_longtail_trace(horizon=args.horizon,
                                  vocab_size=cfg.vocab_size, seed=args.seed)
    eng = FleetEngine(cfg, params, rt=T.Runtime(use_kernels=True),
                      fleet=FleetConfig(
                          num_groups=args.groups, capacity=args.capacity,
                          router="length_aware", mode="dynamic",
                          amoeba=AmoebaConfig(split_threshold=0.3,
                                              fuse_threshold=0.05,
                                              min_phase_steps=2,
                                              policy="online",
                                              refit_every=48)))
    eng.submit(trace)
    s = eng.run()
    lat, ctl = s["latency"], s["control"]
    print(f"completed {s['completed']}/{s['submitted']}  "
          f"eff={s['efficiency']:.3f}  p50={lat['p50']:.1f}  "
          f"p99={lat['p99']:.1f}")
    print(f"replay samples={ctl['replay_samples']}  "
          f"refits={ctl.get('refits', 0)}")
    if ctl.get("last_refit"):
        lr = ctl["last_refit"]
        print(f"last refit: n={lr['n']}  acc={lr['train_accuracy']:.3f}  "
              f"nll tail={lr['loss_history_tail']}")
    out["fleet"] = s
    print("device:", str(dev) if dev.type == "cpu"
          else torch.cuda.get_device_name(dev))
    return out


if __name__ == "__main__":
    main()
