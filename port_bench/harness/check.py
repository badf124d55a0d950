"""What decides ``correct``: served tokens against the plain reference.

Once the window has closed, a sample of the finished requests is drawn
from the seed: the one with the most tokens, one whose decode state a
reconfiguration (split, fuse or re-cut) moved where there is one, and
others, the shortest prompts first and in an order drawn from the seed
among equal ones, until the cell's ``ref_tokens`` budget of reference
positions is spent.  Short prompts first give the most served tokens for
the reference's time: every served token costs its whole prompt.  The reference (:mod:`port_bench.reference.model`,
float32, TF32 off) runs once over each prompt followed by its served
tokens, and at every position that produced a served token reads the gap
by which that token's logit lies below the reference's best (0 where the
reference ranks the served token first).

The number compared is the mean gap over the sample's served tokens
(``mean_gap``).  The widest gap (``max_gap``) is reported beside it but
not compared: on the chip it swings from seed to seed, and the float8
control's widest gap lies within twice the program's (PERF.md), while the
mean gap separates the two by about ten times.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Sequence

import torch

from port_bench.harness import weights
from port_bench.reference.model import Plain


def choose(recs: Sequence, spec: dict, seed: int) -> List:
    """The sample of finished requests the check compares."""
    done = [r for r in recs if r.req.done]
    if not done:
        return []
    rng = random.Random(int(seed) ^ 0x5EED)
    size = lambda r: r.prompt_len + len(r.req.generated)  # noqa: E731
    longest = max(done, key=lambda r: (size(r), -r.req.rid))
    picked = [longest]
    moved = [r for r in done if r.reconfigured and r is not longest]
    if moved:
        picked.append(rng.choice(moved))
    rest = [r for r in done if all(r is not p for p in picked)]
    rng.shuffle(rest)
    rest.sort(key=lambda r: r.prompt_len)
    budget = int(spec["ref_tokens"]) - sum(size(r) for r in picked)
    for r in rest:
        if size(r) > budget:
            continue
        picked.append(r)
        budget -= size(r)
    return picked


def _positions(sample, device):
    seqs, pos, served = [], [], []
    for r in sample:
        p, g = list(r.req.prompt), list(r.req.generated)
        seqs.append(torch.tensor(p + g[:-1], dtype=torch.long,
                                 device=device))
        pos.append(torch.arange(len(p) - 1, len(p) + len(g) - 1,
                                device=device))
        served.append(torch.tensor(g, dtype=torch.long, device=device))
    return seqs, pos, served


def _pattern_len(model: dict) -> int:
    pat = model.get("block_pattern")
    return len(pat) if pat else 1


def gap_of(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus that of ``tokens``."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None])[:, 0]


def gaps(model: dict, params, sample: Sequence, device,
         control: bool = False) -> Dict:
    """The reference's readings on ``sample``; with ``control`` also the
    float8 control's (the gap of the token it ranks first)."""
    t0 = time.perf_counter()
    view = weights.reference_view(params, _pattern_len(model))
    seqs, pos, served = _positions(sample, device)
    out = {"served": sum(len(s) for s in served), "max_gap": 0.0,
           "flips": 0, "mean_gap": 0.0}
    if not sample:
        out["seconds"] = time.perf_counter() - t0
        return out
    with torch.no_grad():
        ref = Plain(model, view).logits_at(seqs, pos)
        g = torch.cat([gap_of(r, s) for r, s in zip(ref, served)])
        out.update(max_gap=float(g.max()), flips=int((g > 0).sum()),
                   mean_gap=float(g.mean()))
        if control:
            low = Plain(model, view, "fp8").logits_at(seqs, pos)
            gc_ = torch.cat([gap_of(r, lo.argmax(-1))
                             for r, lo in zip(ref, low)])
            out.update(control_max_gap=float(gc_.max()),
                       control_flips=int((gc_ > 0).sum()),
                       control_mean_gap=float(gc_.mean()))
    out["seconds"] = time.perf_counter() - t0
    return out


def compare(readings: Dict, limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit."""
    return {k: {"value": readings[k], "limit": float(v)}
            for k, v in limits.items()}
