"""Observability for the port: spans, the metrics registry, byte reports.

* :func:`span` — nested host-side tracing spans (free when disabled);
* :func:`get_registry` — named counters/gauges/histograms;
* :func:`register_reporter` — weak byte reporters (:mod:`.memory`);
* :func:`publish_materialisation`, :func:`publish_distributed`,
  :func:`publish_incremental`, :func:`publish_query_cache`,
  :func:`publish_serving` — stats -> registry;
* :func:`sample_memory`, :func:`publish_predicate_effectiveness` — the
  ``mem.*`` roll-up; :class:`MemorySampler` — span-driven peak watermarks;
* :func:`get_journal`, :class:`Explainer`, :func:`proof_to_json`,
  :func:`proof_to_dot` — derivation provenance (:mod:`.provenance`);
* :func:`write_chrome_trace`, :func:`write_metrics` — exporters.
"""

from .adapters import (
    publish_distributed,
    publish_incremental,
    publish_materialisation,
    publish_query_cache,
    publish_serving,
)
from .export import chrome_trace, write_chrome_trace, write_metrics
from .memory import (
    MemoryAccountant,
    MemorySampler,
    get_accountant,
    publish_predicate_effectiveness,
    register_reporter,
    sample_memory,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from .provenance import (
    DerivationJournal,
    DerivationRecord,
    Explainer,
    get_journal,
    proof_to_dot,
    proof_to_json,
)
from .trace import Tracer, get_tracer, instant, set_tracer, span

__all__ = [
    "Counter",
    "DerivationJournal",
    "DerivationRecord",
    "Explainer",
    "Gauge",
    "Histogram",
    "MemoryAccountant",
    "MemorySampler",
    "MetricsRegistry",
    "Tracer",
    "chrome_trace",
    "get_accountant",
    "get_journal",
    "get_registry",
    "get_tracer",
    "instant",
    "proof_to_dot",
    "proof_to_json",
    "publish_distributed",
    "publish_incremental",
    "publish_materialisation",
    "publish_predicate_effectiveness",
    "publish_query_cache",
    "publish_serving",
    "register_reporter",
    "sample_memory",
    "set_registry",
    "set_tracer",
    "span",
    "write_chrome_trace",
    "write_metrics",
]
