"""Metrics and tracing modules, copied verbatim from ``src/repro/obs/``
because the copied I/O modules record into them."""
