"""Median wait from a request's due time to the start of the tick whose
prefill gave its first token (censored at the window's close), seconds.
"""
from port_bench.harness.stats import percentile

LAYER = "fleet and serving engine"
UNIT = "s"
MOVES = "output_tok_s"


def read(rec):
    waits = []
    for r in rec.due_in_window():
        if r.first is not None and r.first <= rec.close_t:
            waits.append(r.first_tick - r.due)
        else:
            waits.append(rec.close_t - r.due)
    return percentile(waits, 50)
