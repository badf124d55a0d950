"""Host milliseconds to enqueue one decode call (the ``decode_fn`` hook:
``transformer.decode_step`` for one part), the mean over the window."""
LAYER = "model step"
UNIT = "ms"
MOVES = "output_tok_s"


def read(rec):
    calls = [d["host_s"] for d in rec.decodes if d["start"] < rec.close_t]
    return 1e3 * sum(calls) / len(calls) if calls else None
