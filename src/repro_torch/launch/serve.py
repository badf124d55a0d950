"""Serving launcher: AMOEBA policy comparison on a real decode workload.

Counterpart of ``repro/launch/serve.py``: runs the engine three times on
the identical request trace — fused baseline, direct_split, warp_regroup —
and reports slot-efficiency, makespan, and the split/fuse dynamics.  On a
CUDA device the model runs through the hand-written kernels
(``Runtime(use_kernels=True)``); ``--device cpu`` runs their plain
versions.  Every arch of ``configs`` runs, reduced, except whisper-base:
the engine prefills from token prompts alone, as the reference's does, and
has no way to feed whisper's ``audio_embeds``, so the launcher refuses it.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --requests 24 --capacity 8
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import AmoebaConfig
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine

RT = T.Runtime(use_kernels=True)


def make_requests(cfg, n: int, seed: int):
    """The reference launcher's trace: same numpy draws, same requests."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.choice([8, 16, 32]))
        mx = int(rng.choice([4, 8, 16, 64], p=[0.3, 0.3, 0.2, 0.2]))
        reqs.append(Request(i, list(map(int, rng.integers(
            0, cfg.vocab_size, plen))), mx))
    return reqs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    if cfg.encoder_layers:
        ap.error(f"--arch {args.arch}: an encoder-decoder model needs "
                 "audio_embeds at prefill, and ServeEngine prefills from "
                 "token prompts alone; run it through the model's own "
                 "prefill and decode_step")
    dev = resolve_device(args.device)
    params = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)

    report = {}
    for name, dynamic, policy in [("fused_baseline", False, "warp_regroup"),
                                  ("direct_split", True, "direct_split"),
                                  ("warp_regroup", True, "warp_regroup")]:
        eng = ServeEngine(cfg, params, rt=RT, amoeba=AmoebaConfig(
            regroup_policy=policy, split_threshold=0.3,
            fuse_threshold=0.05, min_phase_steps=2),
            capacity=args.capacity)
        eng.submit(make_requests(cfg, args.requests, args.seed))
        st = eng.run(dynamic=dynamic)
        report[name] = {
            "ticks": st.ticks, "slot_steps": st.slot_steps,
            "useful_tokens": st.useful_tokens,
            "efficiency": round(st.efficiency, 4),
            "splits": st.splits, "fuses": st.fuses,
            "completed": st.completed,
        }
    base = report["fused_baseline"]["efficiency"]
    for k in report:
        report[k]["vs_fused"] = round(report[k]["efficiency"] / base, 3)
    report["device"] = str(dev) if dev.type == "cpu" \
        else torch.cuda.get_device_name(dev)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
