"""Host milliseconds of the control plane a tick: the program's own
``group.control`` (the group controller's features and ``observe``) and
``engine.rebalance`` (the fleet controller) spans inside the profiler's
sub-windows, over the ``engine.tick`` spans there (one a pass of
``FleetEngine.run``'s loop).  The program's spans reach the profiler as
``record_function`` annotations (``repro_torch.obs.spans``); a program
without them gives no reading."""
LAYER = "fleet and serving engine"
UNIT = "ms"
MOVES = "output_tok_s"

CONTROL = ("group.control", "engine.rebalance")


def read(rec):
    ticks, us = 0, 0.0
    for sub in rec.subwindows:
        lo, hi = sub["start_us"], sub["end_us"]
        for name, s, e in sub["spans"]:
            if lo <= s and e <= hi:
                ticks += name == "engine.tick"
                us += e - s if name in CONTROL else 0.0
    return 1e-3 * us / ticks if ticks else None
