"""Serving engines: ``ServeEngine`` (``serve_loop.py``), continuous-batching
LM decode over fixed-capacity KV slots.  The reference also re-exports its
``ColoringService`` here; the port's dynamic stack is not ported yet
(ROADMAP queue A.3)."""
from repro_torch.serving.serve_loop import Request, ServeEngine  # noqa: F401
