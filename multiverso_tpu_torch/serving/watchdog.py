"""Stall/leak watchdog: the engine must produce evidence, not silence.

Counterpart of ``multiverso_tpu/serving/watchdog.py``: a daemon thread
polls one engine's public health surface (``engine.health()`` and
``engine.pool_drift()``, never private loop state) and trips when the
engine stopped behaving like one:

* **stall**: no iteration progress (``last_iter_age_s``) for longer than
  ``stall_s`` while sequences are live (slots occupied or an admission
  mid-prefill);
* **queue-age breach**: the oldest queued request has waited past
  ``queue_age_s`` (0 disables), while the loop may be iterating happily;
* **block-pool drift**: the paged allocator's books stopped balancing
  (``BlockPool.drift()``) or live blocks exist with no live sequence.
  Refcounted sharing and the cached tier are not drift. Sampled racily
  against the loop, so a drift verdict must hold for two consecutive
  polls before it trips.

The JAX watchdog also trips on a lock-order violation recorded by its
runtime lock-order witness (``analysis/lockwatch``). The port has no
witness yet (its locks are plain ``threading`` locks), so that check is
not here; it comes with the witness.

On a trip: a bundle (``stats.json`` with ``engine.stats()``,
``dashboard.json`` with ``Dashboard.snapshot()``, ``stacks.txt`` with
every thread's stack, ``ring.jsonl`` with the flight recorder's ring) is
written under ``dump_dir`` when set, ``WATCHDOG_TRIPS[<engine>]``
increments and ``on_trip(reason, bundle_dir)`` fires. Each kind trips once
per episode and re-arms when its condition clears; bundle writes stop at
``max_bundles`` and the trip list keeps the newest 64.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Deque, List, Optional, Tuple

from ..dashboard import Dashboard
from ..log import Log


def thread_stacks() -> str:
    """Every live thread's current stack, formatted."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts: List[str] = []
    for ident, frame in sorted(sys._current_frames().items()):
        parts.append(f"--- thread {names.get(ident, '?')} (ident {ident}) "
                     f"---")
        parts.append("".join(traceback.format_stack(frame)))
    return "\n".join(parts)


@dataclass
class WatchdogConfig:
    interval_s: float = 0.25     # poll period (trip latency <= ~2 polls)
    stall_s: float = 10.0        # no-progress deadline while work is live
    queue_age_s: float = 30.0    # oldest-queued-request limit; 0 disables
    dump_dir: str = ""           # bundle target; "" = count + log only
    # bundle writes per watchdog: a condition flapping around its
    # threshold re-trips every clear/re-breach cycle
    max_bundles: int = 16
    on_trip: Optional[Callable[[str, Optional[str]], None]] = None


class EngineWatchdog:
    """One engine's self-diagnosis thread (daemon; ``engine.stop()`` and
    ``Dashboard.reset()`` both retire it)."""

    def __init__(self, engine: Any, config: Optional[WatchdogConfig] = None,
                 start: bool = True) -> None:
        self.engine = engine
        self.config = config or WatchdogConfig()
        self.trip_counter = Dashboard.get_or_create_counter(
            f"WATCHDOG_TRIPS[{engine.name}]")
        self.on_trip = self.config.on_trip
        # (kind, reason, bundle_dir) per trip, oldest first, bounded;
        # trip_count keeps the true total
        self.trips: Deque[Tuple[str, str, Optional[str]]] = (
            collections.deque(maxlen=64))
        # sequence-stamped twin of `trips` for the fleet plane's
        # exactly-once forwarding (`trips_since`); same bound
        self._trip_log: Deque[Tuple[int, str, str, Optional[str]]] = (
            collections.deque(maxlen=64))
        self._trips_total = 0
        self.bundles = 0
        self.checks = 0
        self._armed = {"stall": True, "queue_age": True, "pool_drift": True}
        self._drift_streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    @property
    def trip_count(self) -> int:
        return self._trips_total

    def trips_since(self, cursor: int):
        """``(new_cursor, trips newer than cursor)``: the obs plane's
        incremental read (JAX ``watchdog.py:132``), oldest first as
        ``(kind, reason, bundle_dir)``; pass back the returned cursor
        (start at 0). Trips are sequence-stamped at append, so none is
        reported twice; only the newest 64 are kept."""
        log: List[Tuple[int, str, str, Optional[str]]] = []
        for _ in range(8):
            try:
                log = list(self._trip_log)
                break
            except RuntimeError:
                # the watchdog thread appended mid-copy; retry
                continue
        new = [(k, r, b) for seq, k, r, b in log if seq > cursor]
        if new:
            cursor = log[-1][0]      # same copy the filter saw
        return cursor, new

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "EngineWatchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"mv-watchdog-{self.engine.name}",
            daemon=True)
        self._thread.start()
        Dashboard.attach_reporter(self)
        return self

    def stop(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=10)
            self._thread = None
        Dashboard.detach_reporter(self)

    def detach(self) -> None:
        """``Dashboard.reset()`` hook."""
        self.stop()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.check_once()
            except Exception as exc:    # pragma: no cover - defensive
                Log.error("watchdog[%s]: health check failed: %s",
                          self.engine.name, exc)

    # -- the checks ---------------------------------------------------------
    def check_once(self) -> List[str]:
        """One health evaluation (also the tests' entry point). Returns
        the reasons that newly tripped on this check."""
        self.checks += 1
        health = self.engine.health()
        fired: List[str] = []
        if health.get("stopped"):
            # a retired engine is not a stalled one; re-arm everything
            for kind in self._armed:
                self._armed[kind] = True
            self._drift_streak = 0
            return fired

        live = health.get("live_seqs", 0)
        age = health.get("last_iter_age_s", 0.0)
        stalled = live > 0 and age > self.config.stall_s
        reason = (f"engine stall: no iteration progress for {age:.2f}s "
                  f"with {live} live sequence(s) "
                  f"(deadline {self.config.stall_s:g}s, iteration "
                  f"{health.get('iters_total', 0)})")
        self._gate("stall", stalled, reason, fired)

        q_age = health.get("queue_age_s", 0.0)
        breach = 0 < self.config.queue_age_s < q_age
        reason = (f"queue-age breach: oldest queued request has waited "
                  f"{q_age:.2f}s (limit {self.config.queue_age_s:g}s, "
                  f"depth {health.get('queue_depth', 0)})")
        self._gate("queue_age", breach, reason, fired)

        drift = self.engine.pool_drift()
        # the VERDICT must persist across two polls, not its message (the
        # free/live counts it embeds move under traffic)
        self._drift_streak = self._drift_streak + 1 if drift is not None else 0
        self._gate("pool_drift", self._drift_streak >= 2,
                   f"block-pool drift: {drift}", fired)
        return fired

    def _gate(self, kind: str, condition: bool, reason: str,
              fired: List[str]) -> None:
        """Edge trigger per kind: trip once when the condition appears,
        re-arm when it clears."""
        if not condition:
            self._armed[kind] = True
            return
        if not self._armed[kind]:
            return
        self._armed[kind] = False
        self._trip(kind, reason)
        fired.append(reason)

    # -- the trip -----------------------------------------------------------
    def _trip(self, kind: str, reason: str) -> None:
        self._trips_total += 1
        bundle = None
        if self.config.dump_dir and self.bundles < self.config.max_bundles:
            try:
                bundle = self.dump(kind, reason)
                self.bundles += 1
                if self.bundles == self.config.max_bundles:
                    Log.error(
                        "watchdog[%s]: bundle cap reached (%d); further "
                        "trips count and log without dumping",
                        self.engine.name, self.config.max_bundles)
            except OSError as exc:      # pragma: no cover - disk trouble
                Log.error("watchdog[%s]: bundle dump failed: %s",
                          self.engine.name, exc)
        self.trip_counter.inc()
        self.trips.append((kind, reason, bundle))
        self._trip_log.append((self._trips_total, kind, reason, bundle))
        Log.error("watchdog[%s] TRIPPED (%s): %s; bundle: %s",
                  self.engine.name, kind, reason,
                  bundle or "none (-debug_dump_dir unset)")
        callback = self.on_trip
        if callback is not None:
            try:
                callback(reason, bundle)
            except Exception as exc:    # pragma: no cover - defensive
                Log.error("watchdog[%s]: on_trip callback failed: %s",
                          self.engine.name, exc)

    def dump(self, kind: str, reason: str) -> str:
        """Write the diagnostic bundle; returns its directory (layout in
        the module docstring)."""
        stamp = time.strftime("%Y%m%d-%H%M%S")
        bundle = os.path.join(
            self.config.dump_dir,
            f"watchdog-{self.engine.name}-{kind}-{stamp}-"
            f"{self._trips_total}")
        os.makedirs(bundle, exist_ok=True)
        with open(os.path.join(bundle, "stats.json"), "w") as f:
            json.dump({"engine": self.engine.name, "kind": kind,
                       "reason": reason, "ts_epoch_s": time.time(),
                       "stats": self.engine.stats()}, f, indent=2)
        with open(os.path.join(bundle, "dashboard.json"), "w") as f:
            json.dump(Dashboard.snapshot(), f, indent=2)
        with open(os.path.join(bundle, "stacks.txt"), "w") as f:
            f.write(thread_stacks())
        recorder = getattr(self.engine, "recorder", None)
        if recorder is not None:
            recorder.export_jsonl(os.path.join(bundle, "ring.jsonl"))
        return bundle
