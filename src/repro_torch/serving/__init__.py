"""Epoch-based MVCC serving tier.

Readers pin immutable epoch snapshots through a refcounted registry, a
single writer thread applies update batches and publishes new epochs,
and queries are admitted in micro-batches executed with shared-plan
grouping, all on the store's device.  The entry point is
``repro_torch.launch.serve_datalog --mvcc``.
"""

from .admission import AdmissionQueue, Request
from .epochs import EpochEntry, EpochLease, EpochRegistry
from .tier import ServeResponse, ServingLease, ServingTier

__all__ = [
    "AdmissionQueue",
    "EpochEntry",
    "EpochLease",
    "EpochRegistry",
    "Request",
    "ServeResponse",
    "ServingLease",
    "ServingTier",
]
