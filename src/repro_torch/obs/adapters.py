"""Publish an engine's stats dataclass into the metrics registry.

Counters are incremented by the published value (a registry scope
accumulates across runs until its owner resets it); levels are gauges and
overwrite.  Field names are kept under the prefix: ``cmat.rounds`` is
``MaterialisationStats.rounds``, ``dist.rows_joined`` is
``DistributedStats.rows_joined``.
"""

from __future__ import annotations

from .metrics import MetricsRegistry, get_registry

__all__ = [
    "DISTRIBUTED_COUNTERS",
    "MATERIALISATION_COUNTERS",
    "MATERIALISATION_GAUGES",
    "publish_distributed",
    "publish_materialisation",
]

#: MaterialisationStats fields that accumulate (counter semantics)
MATERIALISATION_COUNTERS = (
    "rounds",
    "n_rule_applications",
    "rule_applications_skipped",
    "old_snapshot_scans",
    "time_compress",
    "time_match",
    "time_join",
    "time_dedup",
    "time_total",
)

#: MaterialisationStats fields that are levels (gauge semantics)
MATERIALISATION_GAUGES = ("n_strata", "n_meta_facts", "n_facts")


#: DistributedStats extras beyond the materialisation base
DISTRIBUTED_COUNTERS = (
    "rows_joined",
    "exchanges",
    "exchanges_skipped",
    "exchange_regrows",
    "n_del_explicit",
    "n_add_explicit",
    "n_overdeleted",
    "n_rederived",
    "n_deleted",
    "n_inserted",
)


def _publish_rule_scope(reg: MetricsRegistry, stats) -> None:
    """Per-stratum breakdown (gauges of the last run) and the (rule,
    pivot) skip counter under the ``rule.*`` scope."""
    for s in getattr(stats, "per_stratum", ()) or ():
        si = s.get("stratum", 0)
        for f in ("rounds", "rules", "rule_applications"):
            if f in s:
                reg.gauge(f"rule.stratum{si}.{f}").set(s[f])
    reg.counter("rule.applications_skipped").inc(
        getattr(stats, "rule_applications_skipped", 0)
    )


def publish_materialisation(
    stats, registry: MetricsRegistry | None = None, prefix: str = "cmat"
) -> None:
    """Publish a :class:`~repro_torch.core.engine.MaterialisationStats`
    (``CMatEngine.materialise`` calls this at its end)."""
    reg = registry if registry is not None else get_registry()
    for f in MATERIALISATION_COUNTERS:
        reg.counter(f"{prefix}.{f}").inc(getattr(stats, f))
    for f in MATERIALISATION_GAUGES:
        reg.gauge(f"{prefix}.{f}").set(getattr(stats, f))
    _publish_rule_scope(reg, stats)
    # plan-cache counters are cumulative on the cache object: gauges
    for key, val in (stats.plan_cache or {}).items():
        reg.gauge(f"{prefix}.plan_cache.{key}").set(val)


def publish_distributed(
    stats, registry: MetricsRegistry | None = None, prefix: str = "dist"
) -> None:
    """Publish a :class:`~repro_torch.core.distributed.DistributedStats`
    (after ``materialise`` and after every ``apply``): the materialisation
    fields, then the exchange and maintenance counters and the epoch."""
    reg = registry if registry is not None else get_registry()
    publish_materialisation(stats, reg, prefix)
    for f in DISTRIBUTED_COUNTERS:
        reg.counter(f"{prefix}.{f}").inc(getattr(stats, f))
    reg.gauge(f"{prefix}.epoch").set(stats.epoch)
