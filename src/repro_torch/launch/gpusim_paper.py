"""The paper's Fig 12 in one command: every scheme over the 12 calibrated
benchmarks, with the paper's headline targets alongside.

Counterpart of ``examples/gpusim_paper.py``; the same table, from the
port's ``core.gpusim`` (numpy on the host: nothing runs on a device).

    PYTHONPATH=src python -m repro_torch.launch.gpusim_paper
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.gpusim import SCHEMES, WORKLOADS, run_all


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    res = {s: run_all(s) for s in SCHEMES}
    base = res["baseline"]
    speedup = {s: {n: res[s][n].ipc / base[n].ipc for n in WORKLOADS}
               for s in SCHEMES[1:]}
    print(f"{'bench':8s}" + "".join(f"{s:>14s}" for s in SCHEMES[1:]))
    for name in WORKLOADS:
        print(f"{name:8s}" + "".join(f"{speedup[s][name]:14.3f}"
                                     for s in SCHEMES[1:]))
    print("-" * 78)
    geomean = {s: float(np.exp(np.mean(np.log(list(speedup[s].values())))))
               for s in SCHEMES[1:]}
    for s in SCHEMES[1:]:
        print(f"geomean {s:14s} {geomean[s]:.3f}")
    wr = speedup["warp_regroup"]
    print(f"\npaper targets: SM 4.25x (got {wr['SM']:.2f}), "
          f"MUM 2.11x (got {wr['MUM']:.2f}), geomean ~1.47 "
          f"(got {geomean['warp_regroup']:.3f})")
    return {"speedup": speedup, "geomean": geomean}


if __name__ == "__main__":
    main()
