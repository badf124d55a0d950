"""Trace timeline launcher: per-decision observability over a skewed run.

Counterpart of ``examples/trace_timeline.py``, the ``repro_torch.obs``
pipeline end to end on the vec engine over a cluster mesh.  The vec
engine needs no model weights, so this runs on the host and touches no
device:

1. run a shard-skewed trace with ``FleetConfig(obs="full")`` and an
   ``online`` policy so decisions carry realized labels;
2. export the event stream to JSONL and to Chrome trace-event JSON —
   open the latter at https://ui.perfetto.dev to see group topologies
   as spans, steals as flow arrows, reconfigs as instants;
3. print the text timeline, the decisions-preceding-reconfigs table
   ("which decision caused each topology change?"), and the decision
   audit's top-K misprediction table.

    PYTHONPATH=src python -m repro_torch.launch.trace_timeline \
        --horizon 40 --out-dir build/trace
"""
from __future__ import annotations

import argparse
import os

from repro_torch.cluster import ClusterEngine
from repro_torch.configs import get_config
from repro_torch.configs.base import (AmoebaConfig, ClusterConfig,
                                      FleetConfig, MigrationConfig)
from repro_torch.fleet import multichip_imbalanced_trace
from repro_torch.obs import (decision_rows, render_attribution,
                             render_mispredictions, render_timeline,
                             verify_replay, write_chrome_trace, write_jsonl)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=2)
    ap.add_argument("--groups-per-chip", type=int, default=2)
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--out-dir", default="build/trace")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=True)
    groups = args.chips * args.groups_per_chip

    # -- 1: an observed cluster run -----------------------------------------
    print("== observed run: skewed trace, online policy, obs='full' ==")
    fleet = FleetConfig(
        num_groups=groups, capacity=args.capacity, router="sticky",
        mode="dynamic", engine="vec", rebalance_every=4,
        migrate=MigrationConfig(enabled=True),
        amoeba=AmoebaConfig(split_threshold=0.3, fuse_threshold=0.05,
                            min_phase_steps=2, policy="online"),
        cluster=ClusterConfig(groups_per_chip=args.groups_per_chip),
        obs="full")
    eng = ClusterEngine(cfg, None, fleet=fleet)
    trace = multichip_imbalanced_trace(
        horizon=args.horizon, vocab_size=cfg.vocab_size, seed=args.seed,
        chips=args.chips, groups_per_chip=args.groups_per_chip)
    eng.submit(trace)
    s = eng.run()
    obs = s["obs"]
    print(f"  {s['completed']}/{s['submitted']} requests drained in "
          f"{s['wall_ticks']} ticks; {obs['total_events']} events: "
          + ", ".join(f"{k}={v}" for k, v in obs["by_kind"].items()))

    # -- 2: exporters --------------------------------------------------------
    os.makedirs(args.out_dir, exist_ok=True)
    jsonl = os.path.join(args.out_dir, "trace_timeline.jsonl")
    chrome = os.path.join(args.out_dir, "trace_timeline_chrome.json")
    n = write_jsonl(jsonl, eng.obs.events(), meta=eng.obs.meta)
    m = write_chrome_trace(chrome, eng.obs.events(), meta=eng.obs.meta)
    print(f"\n== exports ==\n  {jsonl}: {n} events (JSONL)\n"
          f"  {chrome}: {m} trace events — open at ui.perfetto.dev")

    # -- 3: the reports ------------------------------------------------------
    print("\n== timeline (first 25 events) ==")
    print(render_timeline(eng.obs.events(), limit=25))
    print("\n== which decision preceded each topology change? ==")
    print(render_attribution(eng.obs.events()))
    print("\n== decision audit: top-5 mispredictions ==")
    print(render_mispredictions(eng.obs.events(), k=5))
    rows = decision_rows(e.as_dict() for e in eng.obs.events())
    checked = verify_replay(rows, eng.policy.replay)
    print(f"\naudit cross-check: {checked} decision labels verified "
          f"against the live replay buffer")


if __name__ == "__main__":
    main()
