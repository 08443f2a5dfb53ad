"""Observability of the port: off-process metrics export (DESIGN.md
§15; obs/metrics.py, a copy of the reference's)."""
from .metrics import (CallbackSink, Emitter, JsonlSink, MetricsConfig,
                      MetricsSink, NullSink, RingSink, TeeSink, make_sink)

__all__ = [
    "CallbackSink", "Emitter", "JsonlSink", "MetricsConfig",
    "MetricsSink", "NullSink", "RingSink", "TeeSink", "make_sink",
]
