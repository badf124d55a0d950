"""Device milliseconds of the prefill calls (CUDA events around each
``transformer.prefill``) per 1,000 prompt tokens, over the window."""
LAYER = "model step"
UNIT = "ms/ktok"
MOVES = "prompt_tok_s"


def read(rec):
    calls = [p for p in rec.prefills
             if p["start"] < rec.close_t and p["device_ms"] is not None]
    toks = sum(p["batch"] * p["seq"] for p in calls)
    if not toks:
        return None
    return 1e3 * sum(p["device_ms"] for p in calls) / toks
