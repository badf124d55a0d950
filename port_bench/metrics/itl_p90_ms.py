"""90th percentile, over every request with two or more tokens in the
window, of its mean gap between output tokens (first to last token over
n - 1), milliseconds."""
from port_bench.harness.serve import end_to_end

LAYER = "model step"
UNIT = "ms"
MOVES = "output_tok_s"


def read(rec):
    return end_to_end(rec, {"itl_p90_ms"})["itl_p90_ms"]
