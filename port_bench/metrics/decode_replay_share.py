"""The share of decode calls that replayed a CUDA graph without capturing
one, in %: of the program's ``group.decode`` spans inside the profiler's
sub-windows, those that enclose a ``model.decode_replay`` span and no
``model.decode_capture`` span.  The program's spans reach the profiler as
``record_function`` annotations (``repro_torch.obs.spans``); a program
that neither captures nor replays gives no reading."""
LAYER = "model step"
UNIT = "%"
MOVES = {"chat": "output_tok_s", "docs": "prompt_tok_s"}

GRAPH = ("model.decode_replay", "model.decode_capture")


def read(rec):
    calls, replayed, seen = 0, 0, False
    for sub in rec.subwindows:
        lo, hi = sub["start_us"], sub["end_us"]
        inside = [(n, s, e) for n, s, e in sub["spans"]
                  if lo <= s and e <= hi]
        graph = [(n, s, e) for n, s, e in inside if n in GRAPH]
        seen = seen or bool(graph)
        for n, s, e in inside:
            if n != "group.decode":
                continue
            calls += 1
            held = {g for g, gs, ge in graph if s <= gs and ge <= e}
            replayed += held == {"model.decode_replay"}
    return 100.0 * replayed / calls if seen and calls else None
