"""Tiered context-state store — backward-compatible facade.

The store implementation lives in ``repro_torch.kvcache.hierarchy``: a
``TieredStore`` composing capacity-bounded ``StorageBackend``s into an
ordered hierarchy (host_dram -> local_nvme -> io2/gp3 -> s3/peer_dram) with
pinning, link concurrency limits, spill-on-pressure, and economics-driven
promotion/demotion.  ``ContextStore`` is the legacy name, kept as a thin
wrapper: with a single-tier hierarchy, no concurrency limits, and no
migration policy it is behaviorally identical to the pre-hierarchy store
(golden-parity pinned by tests/test_serving.py)."""
from __future__ import annotations

from repro_torch.kvcache.hierarchy import (  # noqa: F401
    BreakEvenMigrator,
    StoredEntry,
    TieredStore,
    TierMigration,
    TierSpec,
    TierState,
    _FALLBACK_GB_HOUR_RATE,
)


class ContextStore(TieredStore):
    """Multi-tier, content-addressed store for per-context model state
    (legacy name; see ``hierarchy.TieredStore``)."""
