"""Observability for the serving stack: the structured event log and the
per-tick metrics registry."""
from repro_torch.obs.events import (EVENT_KINDS, NULL_LOG, OBS_MODES, Event,
                                    EventLog, jsonable)
from repro_torch.obs.metrics import Histogram, MetricsRegistry

__all__ = ["EVENT_KINDS", "OBS_MODES", "Event", "EventLog", "NULL_LOG",
           "jsonable", "Histogram", "MetricsRegistry"]
