"""The share of the profiler's sub-windows in which no operation ran on
the device (union of kernel, copy and set intervals), in %."""
from port_bench.harness import trace

LAYER = "device"
UNIT = "%"
MOVES = {"chat": "output_tok_s", "docs": "prompt_tok_s"}


def read(rec):
    busy = win = 0.0
    for sub in rec.subwindows:
        b, w = trace.busy_window_us(sub)
        busy, win = busy + b, win + w
    return 100.0 * (1.0 - busy / win) if win > 0 else None
