"""Serving engines: long-lived, device-resident, submit / step APIs.

  * ``ServeEngine`` (``serve_loop.py``) — continuous-batching LM decode over
    fixed-capacity KV slots.
  * ``ColoringService`` (``repro_torch.dynamic.service``) — incremental
    graph recoloring over mutating graphs, re-exported here as part of the
    serving surface, as the reference does.
"""
from repro_torch.serving.serve_loop import Request, ServeEngine  # noqa: F401
from repro_torch.dynamic.service import ColoringService  # noqa: F401
