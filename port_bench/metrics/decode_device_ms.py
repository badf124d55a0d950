"""Milliseconds between CUDA events recorded before and after each decode
call (the same calls as ``decode_host_ms``), the mean over the window."""
LAYER = "model step"
UNIT = "ms"
MOVES = "output_tok_s"


def read(rec):
    calls = [d["device_ms"] for d in rec.decodes
             if d["start"] < rec.close_t and d["device_ms"] is not None]
    return sum(calls) / len(calls) if calls else None
