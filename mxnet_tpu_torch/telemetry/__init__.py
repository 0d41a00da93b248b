"""Telemetry for the PyTorch port: copies of the JAX package's
stdlib-only modules the decode-serving slice uses (metric registry,
trace ids, spans, structured events, stage attribution)."""
from __future__ import annotations

from . import attribution, events, spans, trace
from .registry import REGISTRY

__all__ = ["REGISTRY", "attribution", "events", "spans", "trace"]
