"""Versioned copy-on-publish read views over live parameter state.

Counterpart of ``multiverso_tpu/serving/snapshot.py::SnapshotManager``: a
snapshot is one copy of the source's parameters taken under its lock, and
it is republished only when the source version moved AND the published
copy is older than the staleness bound, so a reply always knows its
version and how stale it may be. A source is a model (``snapshot_params``),
a table (``snapshot_array``) or a ``(read, version_fn)`` pair.

Also here: :class:`DerivedCache` (one artifact per snapshot version, for
the micro-batched workloads) and :func:`quantize_decode_params` (the int8
decode parameter pin, host numpy, once per pinned version).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..log import Log


@dataclass(frozen=True)
class Snapshot:
    """Immutable published view: a params copy + its source version, and
    for fenced sources the trainer incarnation epoch the state derives
    from (a pin carries (epoch, version) together)."""

    value: Any
    version: int
    published_at: float
    epoch: int = 0


class DerivedCache:
    """Per-snapshot-version derived artifact: ``fn(snap.value)`` computed
    once per publish and reused until training moves the source. ``get``
    is serialized, so readers racing a publish compute it once."""

    def __init__(self, fn: Callable[[Any], Any]) -> None:
        self._fn = fn
        self._cached: Tuple[int, Any] = (-1, None)
        self._lock = threading.Lock()

    def get(self, snap: Snapshot) -> Any:
        with self._lock:
            ver, value = self._cached
            if ver != snap.version:
                value = self._fn(snap.value)
                self._cached = (snap.version, value)
            return value


def quantize_decode_params(value: Dict[str, Any]) -> Dict[str, Any]:
    """int8 symmetric snapshot of a parameter dict for decode pinning.

    Every tensor becomes ``{"q": int8, "s": fp32 scale}``, per column
    (the input axis reduced, kept) for matrices and per tensor for
    vectors, on the tensor's device. The arithmetic is host numpy, the
    JAX function's (:func:`~..quantization.quantize_int8`), so both
    packages give the same bytes; it runs once per pinned snapshot
    version. ``models.transformer.dequantize_decode_params`` inverts it
    at the top of every serving program."""
    from ..quantization import quantize_int8

    def quant(leaf: torch.Tensor) -> Dict[str, torch.Tensor]:
        host = leaf.detach().to("cpu", torch.float32).numpy()
        q, s = quantize_int8(host, axis=-2 if host.ndim >= 2 else None)
        return {"q": torch.from_numpy(q).to(leaf.device),
                "s": torch.from_numpy(np.asarray(s, np.float32)).to(
                    leaf.device)}

    return {k: ({n: quant(w) for n, w in v.items()} if isinstance(v, dict)
                else quant(v)) for k, v in value.items()}


class SnapshotManager:
    """Publishes/refreshes snapshots of one source (a model with the
    ``snapshot_params``/``version`` contract, or a ``(read, version_fn)``
    pair)."""

    def __init__(self, read: Callable[[], Tuple[Any, int]],
                 version_fn: Callable[[], int], name: str = "snapshot",
                 epoch_fn: Optional[Callable[[], int]] = None):
        self._read = read
        self._version_fn = version_fn
        self._epoch_fn = epoch_fn or (lambda: 0)
        self.name = name
        self._lock = threading.Lock()
        self._snap: Optional[Snapshot] = None
        self.publishes = 0  # copies actually taken (copy-on-publish)
        # when the source version last moved, as seen by any probe here
        self._seen_version = self._version_fn()
        self._last_move = time.monotonic()

    @classmethod
    def of(cls, source: Any, name: Optional[str] = None) -> "SnapshotManager":
        label = name or getattr(source, "name", type(source).__name__)
        epoch_fn = (lambda: int(getattr(source, "epoch", 0)))
        if hasattr(source, "snapshot_array"):
            return cls(source.snapshot_array, lambda: source.version, label,
                       epoch_fn=epoch_fn)
        if hasattr(source, "snapshot_params"):
            return cls(source.snapshot_params, lambda: source.version,
                       label, epoch_fn=epoch_fn)
        if isinstance(source, tuple) and len(source) == 2:
            return cls(source[0], source[1], label)
        Log.fatal(f"SnapshotManager: {type(source).__name__} exposes "
                  "neither snapshot_array nor snapshot_params")

    def publish(self) -> Snapshot:
        """Force a fresh copy (the copy-on-publish event)."""
        with self._lock:
            value, version = self._read()
            self._snap = Snapshot(value, version, time.monotonic(),
                                  epoch=self._epoch_fn())
            self._note_version_locked(version)
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

    # -- params staleness -------------------------------------------------
    def _note_version_locked(self, version: int) -> None:
        if version != self._seen_version:
            self._seen_version = version
            self._last_move = time.monotonic()

    def params_age_s(self) -> float:
        """Seconds since the source version last moved (as observed): 0
        while training flows, growing while the trainer is silent. The
        version probe runs outside the manager lock."""
        version = self._version_fn()
        with self._lock:
            self._note_version_locked(version)
            return time.monotonic() - self._last_move

    def params_stale(self, stale_after_s: float,
                     age_s: Optional[float] = None) -> bool:
        """The source has been frozen past ``stale_after_s`` (<= 0
        disables the verdict). ``age_s`` reuses a probe already taken."""
        if age_s is None:
            age_s = self.params_age_s()
        return stale_after_s > 0 and age_s > stale_after_s
