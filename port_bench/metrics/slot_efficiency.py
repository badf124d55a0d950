"""Useful tokens over slot-steps in the window (``ServeStats``), in %.

A fused part decodes every slot until its longest member finishes, so a
slot-step that yields no token is waste the AMOEBA split exists to cut.
"""
LAYER = "fleet and serving engine"
UNIT = "%"
MOVES = "output_tok_s"


def read(rec):
    steps = rec.counters["slot_steps"]
    if steps <= 0:
        return None
    return 100.0 * rec.counters["useful_tokens"] / steps
