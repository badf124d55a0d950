"""Run one benchmark cell once and print its result line.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration, traffic
and deployment are read from ``BENCHMARK.json`` and the files it names;
the program under test is the port, ``src/repro_torch``.  With
``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics.  The last line of standard output
is one JSON object; the numbers the correctness check compared, each
with its limit, are the last lines of standard error.

Exits 2 without a result where no CUDA device is found, or fewer than
the cell asks for, and 3 where a module of ``jax``, ``jaxlib``, ``flax``
or the JAX package ``repro`` is loaded once the window has closed.
Build and kernel caches stay inside the checkout (``build/``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _caches(root: Path) -> None:
    """Fixed cache directories inside the checkout."""
    cache = root / "build" / "bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches(ROOT)
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from port_bench.harness import manifest
    cell = manifest.load_cell(ROOT, args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 2
    from port_bench.harness import serve

    def device_info():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
                "count": cell.chips}

    result = serve.run_cell(ROOT, cell, args.seed, args.seconds,
                            bool(args.trace), t_start=T_START,
                            device_info=device_info)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the run's process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    lines = [f"check {k} {c['value']!r} limit {c['limit']!r}"
             for k, c in result["compared"].items()]
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
