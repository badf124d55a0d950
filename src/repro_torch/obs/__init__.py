"""Observability for the serving stack: the structured event log."""
from repro_torch.obs.events import (EVENT_KINDS, NULL_LOG, OBS_MODES, Event,
                                    EventLog, jsonable)

__all__ = ["EVENT_KINDS", "OBS_MODES", "Event", "EventLog", "NULL_LOG",
           "jsonable"]
