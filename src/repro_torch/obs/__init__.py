"""Observability: the structured tracer (``trace``).  The metrics
registry, the Perfetto export and the flight recorder of the reference's
``repro.obs`` are later parts of the port."""
from repro_torch.obs import trace

__all__ = ["trace"]
