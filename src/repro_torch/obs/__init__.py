"""Observability, after ``repro/obs/__init__.py``: the structured tracer
(``trace``), the typed metrics registry with ``scrape`` (``metrics``)
and the bounded crash flight recorder (``recorder``), each a copy of the
reference's module.  The reference's Perfetto export is a later part of
the port."""
from repro_torch.obs import metrics, recorder, trace
from repro_torch.obs.metrics import scrape
from repro_torch.obs.recorder import FlightRecorder

__all__ = ["trace", "metrics", "recorder", "scrape", "FlightRecorder"]
