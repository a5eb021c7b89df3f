"""Pluggable byte-level storage backends behind the ContextStore.

The paper's storage half splits into two concerns: *what* is stored (tier
metadata, the content-addressed trie, eviction economics — ContextStore) and
*where the bytes live and how long they take to move* (this module).  A
``StorageBackend`` owns opaque payloads keyed by entry id and returns a
``TransferHandle`` per movement, carrying the modeled delay and SimClock
completion time.  Straggler hedging (tail-at-scale duplicate reads) is a
backend property: the engine no longer special-cases it.

Two implementations ship:

  * ``HostMemoryBackend``  — host-DRAM tier; PCIe-speed loads.
  * ``ObjectStoreBackend`` — remote cloud tier (the paper's EBS/S3); delays
    flow through the TransferModel and reads may be hedged.

Both hold payloads in process memory (this container has no storage fabric);
the distinction is purely the delay/pricing model, which is the paper's
entire subject.  A real deployment would back ``ObjectStoreBackend`` with an
actual object store client behind the same protocol.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.kvcache.faults import (
    CorruptPayload,
    FaultInjector,
    KeyNotFound,
    TierUnavailable,
    payload_checksum,
)
from repro_torch.kvcache.transfer import SimClock, TransferHandle, TransferModel


@runtime_checkable
class StorageBackend(Protocol):
    """Byte-level payload storage with modeled transfer times."""

    name: str

    def put(
        self, key: str, payload: Any, nbytes: float, *, charge: bool = True
    ) -> TransferHandle:
        """Store ``payload`` under ``key``.  ``charge=False`` moves bytes
        without billing the link (tier migration, not a serving write)."""
        ...

    def get(
        self, key: str, *, nbytes: Optional[float] = None, charge: bool = True
    ) -> Tuple[Any, TransferHandle]:
        """Fetch the payload.  ``nbytes`` overrides the billed byte count for
        partial (prefix-fraction) reads; None reads the full payload."""
        ...

    def delete(self, key: str) -> bool: ...

    def contains(self, key: str) -> bool: ...

    def peek(self, key: str) -> Any:
        """Payload access with no transfer accounting (introspection only)."""
        ...

    def estimate_load_delay(self, nbytes: float) -> float:
        """Modeled read delay for ``nbytes`` (hedged), charging nothing."""
        ...


class _MemoryBackend:
    """Shared mechanics for the in-process backends: payload storage behind
    four overridable primitives (``_write``/``_read``/``_drop``/``_has``) plus
    modeled delays from the TransferModel (zero when none is attached).
    Subclasses that keep bytes elsewhere (e.g. ``hierarchy.DiskSpillBackend``)
    override only the primitives; the protocol surface and all transfer
    accounting stay here."""

    #: hedged duplicate reads enabled for this backend class
    hedgeable = False
    #: fixed per-call link overhead (e.g. an RPC round trip), applied to every
    #: modeled transfer; only meaningful when a TransferModel is attached
    link_overhead_s = 0.0

    def __init__(
        self,
        name: str,
        *,
        transfer: Optional[TransferModel] = None,
        clock: Optional[SimClock] = None,
        hedge: Optional["HedgePolicy"] = None,
        faults: Optional[FaultInjector] = None,
    ):
        self.name = name
        self.transfer = transfer
        self.clock = clock or SimClock()
        self.hedge = hedge
        self.faults = faults
        self._data: Dict[str, Tuple[Any, float]] = {}
        self._checksums: Dict[str, str] = {}

    # -- storage primitives (override to move bytes elsewhere) ----------- #
    def _write(self, key: str, payload: Any, nbytes: float) -> None:
        self._data[key] = (payload, nbytes)

    def _read(self, key: str) -> Tuple[Any, float]:
        try:
            return self._data[key]
        except KeyError:
            raise KeyNotFound(
                f"{type(self).__name__} tier {self.name!r} has no payload "
                f"under key {key!r}",
                tier=self.name, key=key, reason="not_found",
            ) from None

    def _drop(self, key: str) -> bool:
        return self._data.pop(key, None) is not None

    def _has(self, key: str) -> bool:
        return key in self._data

    # -- protocol ------------------------------------------------------- #
    def put(
        self, key: str, payload: Any, nbytes: float, *, charge: bool = True
    ) -> TransferHandle:
        if nbytes < 0:
            raise ValueError(
                f"nbytes must be >= 0, got {nbytes!r} "
                f"(tier {self.name!r}, key {key!r})"
            )
        self._check_brownout(key)
        # stamp the content checksum before the bytes land so get() can
        # verify corruption is detected, never served
        self._checksums[key] = payload_checksum(payload)
        self._write(key, payload, nbytes)
        delay = 0.0
        if self.transfer is not None and charge:
            delay = self.transfer.store_delay(nbytes, self.name) + self.link_overhead_s
        return TransferHandle(
            key=key, tier=self.name, kind="store", nbytes=nbytes,
            delay_s=delay, issued_at_s=self.clock.now,
        )

    def get(
        self, key: str, *, nbytes: Optional[float] = None, charge: bool = True
    ) -> Tuple[Any, TransferHandle]:
        self._check_brownout(key)
        payload, stored_nbytes = self._read(key)
        n = stored_nbytes if nbytes is None else nbytes
        delay = 0.0
        if self.transfer is not None:
            delay = (
                self.transfer.load_delay(n, self.name)
                if charge
                else self.transfer.estimate_load_delay(n, self.name)
            ) + self.link_overhead_s
        delay = self._hedged(delay)
        # injected transient faults fire *after* the transfer was charged:
        # the wasted bytes and delay are real dollars the failure burned
        if self.faults is not None and self.faults.should_fail(self.name, key):
            raise TierUnavailable(
                f"tier {self.name!r} dropped fetch of {key!r} (injected)",
                tier=self.name, key=key, delay_s=delay, wasted_bytes=n,
                reason="unavailable",
            )
        if self.faults is not None and self.faults.should_corrupt(self.name, key):
            raise CorruptPayload(
                f"tier {self.name!r} served corrupt bytes for {key!r} "
                f"(injected in-flight corruption)",
                tier=self.name, key=key, delay_s=delay, wasted_bytes=n,
                reason="corrupt", at_rest=False,
            )
        self._verify(key, payload, delay_s=delay, nbytes=n)
        handle = TransferHandle(
            key=key, tier=self.name, kind="load", nbytes=n,
            delay_s=delay, issued_at_s=self.clock.now,
        )
        return payload, handle

    def delete(self, key: str) -> bool:
        self._checksums.pop(key, None)
        return self._drop(key)

    def contains(self, key: str) -> bool:
        return self._has(key)

    def peek(self, key: str) -> Any:
        return self._read(key)[0]

    def estimate_load_delay(self, nbytes: float) -> float:
        if self.transfer is None:
            return 0.0
        return self._hedged(
            self.transfer.estimate_load_delay(nbytes, self.name)
            + self.link_overhead_s
        )

    # -- internals ------------------------------------------------------ #
    def _check_brownout(self, key: str) -> None:
        """Fail fast (uncharged — no bytes ever moved) while this tier is
        inside an injected brownout window."""
        if self.faults is not None and self.faults.browned_out(
            self.name, self.clock.now
        ):
            raise TierUnavailable(
                f"tier {self.name!r} is browned out at t={self.clock.now:.3f}s "
                f"(key {key!r})",
                tier=self.name, key=key, reason="brownout",
            )

    def _verify(self, key: str, payload: Any, *, delay_s: float,
                nbytes: float) -> None:
        """Compare the served payload against the checksum stamped at put
        time; a mismatch means the stored copy itself rotted (at rest)."""
        want = self._checksums.get(key)
        if want is not None and payload_checksum(payload) != want:
            raise CorruptPayload(
                f"tier {self.name!r} checksum mismatch for {key!r}: stored "
                f"copy is corrupt",
                tier=self.name, key=key, delay_s=delay_s,
                wasted_bytes=nbytes, reason="corrupt_at_rest", at_rest=True,
            )

    def _hedged(self, delay_s: float) -> float:
        if self.hedge is None:
            return delay_s
        return self.hedge.effective_delay(delay_s)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{type(self).__name__}({self.name!r}, {len(self._data)} entries)"


class HostMemoryBackend(_MemoryBackend):
    """Host-DRAM tier of the serving instance itself (PCIe-speed loads)."""

    def __init__(self, name: str = "host_dram", **kw):
        super().__init__(name, **kw)


class ObjectStoreBackend(_MemoryBackend):
    """Remote cloud tier (the paper's EBS io2 / gp3 / S3): delays are
    bandwidth+latency modeled and reads may be hedged against stragglers."""

    hedgeable = True

    def __init__(self, name: str = "io2", **kw):
        super().__init__(name, **kw)


def default_backends(
    tier_names,
    *,
    transfer: Optional[TransferModel] = None,
    clock: Optional[SimClock] = None,
    hedge: Optional["HedgePolicy"] = None,
    faults: Optional[FaultInjector] = None,
) -> Dict[str, StorageBackend]:
    """One backend per tier: host_dram -> HostMemoryBackend (never hedged —
    local reads have no straggler tail), anything else -> ObjectStoreBackend."""
    out: Dict[str, StorageBackend] = {}
    for name in tier_names:
        cls = HostMemoryBackend if name == "host_dram" else ObjectStoreBackend
        out[name] = cls(
            name, transfer=transfer, clock=clock,
            hedge=hedge if cls.hedgeable else None, faults=faults,
        )
    return out
