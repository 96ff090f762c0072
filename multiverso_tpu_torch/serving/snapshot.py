"""Versioned copy-on-publish read views over live parameter state.

Counterpart of ``multiverso_tpu/serving/snapshot.py::SnapshotManager``: a
snapshot is one copy of the source's parameters taken under its lock, and
it is republished only when the source version moved AND the published
copy is older than the staleness bound, so a reply always knows its
version and how stale it may be.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from ..log import Log


@dataclass(frozen=True)
class Snapshot:
    """Immutable published view: a params copy + its source version."""

    value: Any
    version: int
    published_at: float


class SnapshotManager:
    """Publishes/refreshes snapshots of one source (a model with the
    ``snapshot_params``/``version`` contract, or a ``(read, version_fn)``
    pair)."""

    def __init__(self, read: Callable[[], Tuple[Any, int]],
                 version_fn: Callable[[], int], name: str = "snapshot"):
        self._read = read
        self._version_fn = version_fn
        self.name = name
        self._lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self.publishes = 0  # copies actually taken (copy-on-publish)

    @classmethod
    def of(cls, source: Any, name: Optional[str] = None) -> "SnapshotManager":
        label = name or getattr(source, "name", type(source).__name__)
        if hasattr(source, "snapshot_params"):
            return cls(source.snapshot_params, lambda: source.version, label)
        if isinstance(source, tuple) and len(source) == 2:
            return cls(source[0], source[1], label)
        Log.fatal(f"SnapshotManager: {type(source).__name__} exposes "
                  "no snapshot_params")

    def publish(self) -> Snapshot:
        """Force a fresh copy (the copy-on-publish event)."""
        with self._lock:
            value, version = self._read()
            self._snap = Snapshot(value, version, time.monotonic())
            self.publishes += 1
            return self._snap

    def current(self) -> Snapshot:
        with self._lock:
            snap = self._snap
        return snap if snap is not None else self.publish()

    def ensure_fresh(self, max_staleness_s: float) -> Snapshot:
        """Republish iff the source moved AND the copy is older than the
        bound."""
        snap = self.current()
        if snap.version != self._version_fn():
            if time.monotonic() - snap.published_at > max_staleness_s:
                return self.publish()
        return snap

    def staleness_s(self, snap: Snapshot) -> float:
        """0 while the snapshot IS the live state, else the copy's age."""
        if snap.version == self._version_fn():
            return 0.0
        return time.monotonic() - snap.published_at
