"""Observability, after ``repro/obs/__init__.py``: the structured tracer
(``trace``), the typed metrics registry with ``scrape`` (``metrics``),
the Chrome/Perfetto ``trace_event`` JSON export (``export``) and the
bounded crash flight recorder (``recorder``), each a copy of the
reference's module.  ``__all__`` is the reference's."""
from repro_torch.obs import export, metrics, recorder, trace
from repro_torch.obs.metrics import scrape
from repro_torch.obs.recorder import FlightRecorder

__all__ = ["trace", "metrics", "export", "recorder"]
