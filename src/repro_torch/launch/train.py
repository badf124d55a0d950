"""Training launcher.

Counterpart of ``repro/launch/train.py``, with the same flags plus
``--device``: it trains on CUDA unless given ``--device cpu``, and prints
the reference's JSON summary.

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \\
        --steps 10 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch deepseek-moe-16b --steps 30 --reduced --amoeba
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import AmoebaConfig, ShapeConfig, TrainConfig
from repro_torch.core.controller import AmoebaController
from repro_torch.train import Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--amoeba", action="store_true",
                    help="attach the AMOEBA controller (divergence telemetry)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    tcfg = TrainConfig(learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps,
                       checkpoint_every=args.ckpt_every,
                       grad_compression=args.grad_compression, seed=args.seed)
    controller = AmoebaController(AmoebaConfig()) if args.amoeba else None
    trainer = Trainer(cfg, shape, tcfg, controller=controller,
                      device=args.device)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    out = trainer.train(args.steps, ckpt=ckpt)
    hist = out["history"]
    print(json.dumps({
        "arch": args.arch,
        "steps": len(hist),
        "loss_first": hist[0].loss if hist else None,
        "loss_last": hist[-1].loss if hist else None,
        "mean_dt_s": float(np.mean([m.dt for m in hist[3:]])) if len(hist) > 3
        else None,
        "straggles": len(out["monitor"].events),
        "resumes": out["resumes"],
        "divergence_mean": float(np.mean([m.divergence for m in hist]))
        if hist else None,
    }, indent=1))


if __name__ == "__main__":
    main()
