"""The null run observer.

The JAX package's ``obs/events.py`` records a run's timeline; the port
has no timeline yet, so the serving tier (serve/scheduler.py,
serve/executable.py, obs/serve.py) talks to this observer, whose every
method does nothing and whose ``enabled`` is false.  Callers test
``enabled`` before building an event, so the hot path pays one
attribute read.
"""
from __future__ import annotations


class NullObserver:
    """Observer with nothing to record: every hook is a no-op."""

    enabled = False

    def event(self, ev, **fields):
        pass

    def flush(self):
        pass

    def add_flight_provider(self, fn):
        pass

    def remove_flight_provider(self, fn):
        pass

    def watchdog_arm(self, label):
        pass

    def watchdog_disarm(self):
        pass

    def incident_signal(self, kind, detail=None):
        pass


NULL_OBSERVER = NullObserver()
