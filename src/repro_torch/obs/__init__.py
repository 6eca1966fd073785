"""Observability for the port: spans, the metrics registry, byte reports.

* :func:`span` — nested host-side tracing spans (free when disabled);
* :func:`get_registry` — named counters/gauges/histograms;
* :func:`register_reporter` — weak byte reporters (:mod:`.memory`);
* :func:`publish_materialisation`, :func:`publish_distributed` — stats
  dataclass -> registry.
"""

from .adapters import publish_distributed, publish_materialisation
from .memory import MemoryAccountant, get_accountant, register_reporter
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from .trace import Tracer, get_tracer, instant, set_tracer, span

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MemoryAccountant",
    "MetricsRegistry",
    "Tracer",
    "get_accountant",
    "get_registry",
    "get_tracer",
    "instant",
    "publish_distributed",
    "publish_materialisation",
    "register_reporter",
    "set_registry",
    "set_tracer",
    "span",
]
