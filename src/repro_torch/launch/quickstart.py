"""Quickstart: the AMOEBA loop end to end.

Counterpart of ``examples/quickstart.py``:

1. Run the faithful GPU reproduction on one benchmark (paper Fig 12).
2. Train the scalability predictor and inspect its decision (Fig 20).
3. Train a reduced LM for a few steps with divergence telemetry (the
   trainer's plain PyTorch path: the kernels have no backward).
4. Serve a small request trace with dynamic group splitting (Fig 19),
   through the hand-written kernels on a CUDA device
   (``Runtime(use_kernels=True)``); ``--device cpu`` runs their plain
   versions.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import AmoebaConfig, ShapeConfig, TrainConfig
from repro_torch.core import predictor as P
from repro_torch.core.gpusim import WORKLOADS, profile_features, run_benchmark
from repro_torch.core.gpusim.corpus import train_sim_predictor
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}

    # --- 1. the paper's machine --------------------------------------------
    base = run_benchmark(WORKLOADS["RAY"], "baseline", epochs=64)
    amoeba = run_benchmark(WORKLOADS["RAY"], "warp_regroup", epochs=64)
    out["gpusim"] = dict(baseline_ipc=base.ipc, amoeba_ipc=amoeba.ipc,
                         switches=amoeba.switches)
    print(f"[gpusim] RAY: baseline IPC {base.ipc:.1f} -> AMOEBA "
          f"{amoeba.ipc:.1f} ({amoeba.ipc / base.ipc:.2f}x), "
          f"{amoeba.switches} fuse/split switches")

    # --- 2. the scalability predictor ---------------------------------------
    model, info = train_sim_predictor(variants_per_workload=4, epochs=24)
    p = float(P.predict_proba(model, profile_features(WORKLOADS["RAY"])))
    out["predictor"] = dict(train_accuracy=info["train_accuracy"],
                            p_fuse_ray=p)
    print(f"[predictor] acc={info['train_accuracy']:.2f}, "
          f"P(fuse RAY)={p:.2f}")

    # --- 3. train a reduced LM ----------------------------------------------
    cfg = get_config("qwen3-14b", reduced=True)
    tr = Trainer(cfg, ShapeConfig("demo", 64, 4, "train"),
                 TrainConfig(total_steps=8, warmup_steps=2,
                             learning_rate=1e-3), device=dev)
    hist = tr.train(8)["history"]
    out["train"] = dict(losses=[h.loss for h in hist])
    print(f"[train] qwen3-14b (reduced): loss {hist[0].loss:.3f} -> "
          f"{hist[-1].loss:.3f} over {len(hist)} steps")

    # --- 4. serve with dynamic splitting -------------------------------------
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    rng = np.random.default_rng(0)
    reqs = [Request(i, list(map(int, rng.integers(0, cfg.vocab_size, 8))),
                    int(rng.choice([3, 24], p=[0.7, 0.3])))
            for i in range(12)]
    eng = ServeEngine(cfg, params, rt=T.Runtime(use_kernels=True),
                      amoeba=AmoebaConfig(
                          regroup_policy="warp_regroup", split_threshold=0.3,
                          fuse_threshold=0.05, min_phase_steps=2),
                      capacity=4)
    eng.submit(reqs)
    st = eng.run(dynamic=True)
    out["serve"] = dataclasses.asdict(st)
    print(f"[serve] {st.completed} requests, efficiency "
          f"{st.efficiency:.2f} tokens/slot-step, "
          f"{st.splits} splits / {st.fuses} re-fuses")
    print("device:", str(dev) if dev.type == "cpu"
          else torch.cuda.get_device_name(dev))
    return out


if __name__ == "__main__":
    main()
