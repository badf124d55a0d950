"""Observability for the serving stack.

``repro_torch.obs`` gives the monitor -> predict -> reconfigure loop a
decision-level record: a structured :class:`EventLog` (what happened,
where, when), a :class:`MetricsRegistry` (what the fleet looked like,
per tick), a decision audit joining predictions to realized outcomes,
and exporters (JSONL + Chrome trace-event for Perfetto).  Select with
``FleetConfig.obs`` — ``"off"`` (default, near-zero overhead and
bit-identical summaries), ``"summary"`` (counters only), or ``"full"``
(ring buffer + metrics + audit).  Counterpart of ``repro/obs``.
"""
from repro_torch.obs.audit import (decision_rows, misprediction_rate,
                                   top_mispredictions, verify_replay)
from repro_torch.obs.events import (EVENT_KINDS, NULL_LOG, OBS_MODES, Event,
                                    EventLog, jsonable)
from repro_torch.obs.export import (chrome_trace, read_jsonl,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.report import (attribution_rows, render_attribution,
                                    render_mispredictions, render_report,
                                    render_timeline)

__all__ = [
    "EVENT_KINDS", "OBS_MODES", "Event", "EventLog", "NULL_LOG", "jsonable",
    "Histogram", "MetricsRegistry",
    "decision_rows", "top_mispredictions", "misprediction_rate",
    "verify_replay",
    "write_jsonl", "read_jsonl", "chrome_trace", "write_chrome_trace",
    "attribution_rows", "render_timeline", "render_attribution",
    "render_mispredictions", "render_report",
]
