"""The readings a cell's correctness limit is set from, seed by seed.

    python port_bench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed, in one process, a whole run of the cell
(``serve.run_cell``) at its own load for a window of ``--seconds``, with
the float8 control put in the program's place where the check is judged
(``fault="control"``): the control is the reference computed with every
projection's inputs rounded to float8 e4m3, read at the token it ranks
first.  Each row holds the run's ``correct`` (false where the control
fails the cell's limit, as it must), the program's reading on the same
sample (``mean_gap``, the lower reading) and the control's
(``control_mean_gap``, the upper one), with the widest gaps beside them.
A limit lies above every program reading and below every control
reading.  The benchmark's own runs never compute the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

READINGS = ("mean_gap", "control_mean_gap", "max_gap", "control_max_gap",
            "served_tokens", "requests", "reference_s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from port_bench.harness import manifest, serve
    cell = manifest.load_cell(ROOT, args.workload)
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        res = serve.run_cell(ROOT, cell, seed, args.seconds, False,
                             fault="control")
        r = {k: res["sample"][k] for k in READINGS}
        r.update(seed=seed, correct=res["correct"],
                 compared=res["compared"], run_s=time.perf_counter() - t)
        rows.append(r)
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    summary = {"workload": args.workload, "seeds": len(rows),
               "control_correct": sorted({r["correct"] for r in rows})}
    for k in ("mean_gap", "max_gap"):
        summary[k] = {"lower": max(r[k] for r in rows),
                      "upper": min(r[f"control_{k}"] for r in rows)}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
