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
    "INCREMENTAL_COUNTERS",
    "MATERIALISATION_COUNTERS",
    "MATERIALISATION_GAUGES",
    "publish_distributed",
    "publish_incremental",
    "publish_materialisation",
    "publish_query_cache",
    "publish_serving",
    "SERVING_GAUGES",
]

#: ServingTier.stats() keys mirrored as gauges (lifetime-cumulative on
#: the tier, so re-publishing is idempotent)
SERVING_GAUGES = (
    "queries",
    "batches",
    "mean_batch",
    "max_batch",
    "grouped_queries",
    "single_queries",
    "cache_hits",
    "dedup_hits",
    "groups",
    "stale_reads",
    "applies",
    "checkpoints",
    "compactions",
    "compactions_deferred",
    "max_queue_depth",
    "epoch_lag_max",
    "epochs_published",
    "epochs_retired",
    "epochs_live",
    "epochs_pinned",
    "epoch",
)

#: MaterialisationStats fields that accumulate (counter semantics)
MATERIALISATION_COUNTERS = (
    "rounds",
    "n_rule_applications",
    "rule_applications_skipped",
    "old_snapshot_scans",
    "time_total",
)

#: MaterialisationStats fields that are levels (gauge semantics)
MATERIALISATION_GAUGES = ("n_strata", "n_meta_facts", "n_facts")


#: IncrementalStats extras (per-batch deltas -> counters)
INCREMENTAL_COUNTERS = (
    "n_del_explicit",
    "n_add_explicit",
    "n_overdeleted",
    "n_rederived",
    "n_deleted",
    "n_inserted",
    "n_count_updates",
    "counting_strata",
    "dred_strata",
    "time_overdelete",
    "time_delete",
    "time_rederive",
    "time_counting",
    "time_insert",
)

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
    _publish_plan_cache(reg, prefix, stats.plan_cache)


def _publish_plan_cache(reg: MetricsRegistry, prefix: str, plan_cache) -> None:
    """Plan-cache counters are cumulative on the cache object: gauges."""
    for key, val in (plan_cache or {}).items():
        reg.gauge(f"{prefix}.plan_cache.{key}").set(val)


def publish_incremental(
    stats, registry: MetricsRegistry | None = None, prefix: str = "inc"
) -> None:
    """Publish an :class:`~repro_torch.incremental.IncrementalStats`
    (the store calls this after every ``apply`` batch)."""
    reg = registry if registry is not None else get_registry()
    reg.counter(f"{prefix}.batches").inc()
    for f in INCREMENTAL_COUNTERS + ("n_rule_applications", "time_total"):
        reg.counter(f"{prefix}.{f}").inc(getattr(stats, f))
    reg.gauge(f"{prefix}.epoch").set(stats.epoch)
    reg.gauge(f"{prefix}.n_facts").set(stats.n_facts)
    reg.gauge(f"{prefix}.n_meta_facts").set(stats.n_meta_facts)
    reg.gauge(f"{prefix}.journal_bytes").set(stats.journal_bytes)
    reg.histogram(f"{prefix}.apply_s").observe(stats.time_total)
    _publish_plan_cache(reg, prefix, stats.plan_cache)


def publish_query_cache(
    engine, registry: MetricsRegistry | None = None, prefix: str = "query"
) -> None:
    """Publish a :class:`~repro_torch.query.QueryEngine`'s cache counters
    (lifetime-cumulative on the engine, so gauges)."""
    reg = registry if registry is not None else get_registry()
    for key, val in engine.cache_stats().items():
        reg.gauge(f"{prefix}.{key}").set(val)
    reg.gauge(f"{prefix}.epoch").set(engine.epoch)


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


def publish_serving(
    tier, registry: MetricsRegistry | None = None, prefix: str = "serve.tier"
) -> None:
    """Publish a :class:`~repro_torch.serving.ServingTier`'s lifetime
    stats under ``serve.tier.*`` gauges (its live counters and histograms
    already stream into the registry under ``serve.*``)."""
    reg = registry if registry is not None else get_registry()
    stats = tier.stats()
    for key in SERVING_GAUGES:
        if key in stats:
            reg.gauge(f"{prefix}.{key}").set(stats[key])
