"""Host utilities of the port: the in-process span tracer
(utils/tracing.py)."""
