"""Production serving gateway (DESIGN.md §Serving gateway): SLA-aware
scheduling, session-keyed prefix reuse and streaming HTTP on top of one
interruptible rollout engine; copies of ``repro/serve/``, which needs no JAX."""
from repro_torch.serve.gateway import Gateway
from repro_torch.serve.http import GatewayServer

__all__ = ["Gateway", "GatewayServer"]
