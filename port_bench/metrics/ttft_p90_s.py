"""90th percentile, over every request due in the window, of the time
from its due time to its first token; a request without one at the
window's close counts at its age then (seconds)."""
from port_bench.harness.serve import end_to_end

LAYER = "fleet and serving engine"
UNIT = "s"
MOVES = "output_tok_s"


def read(rec):
    return end_to_end(rec, {"ttft_p90_s"})["ttft_p90_s"]
