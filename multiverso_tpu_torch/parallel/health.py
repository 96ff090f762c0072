"""Heartbeat failure detection (absent in the reference).

Counterpart of ``multiverso_tpu/parallel/health.py``. The reference has
no failure story: registration happens once, there are no heartbeats, and
a dead node hangs the job (``src/controller.cpp:46-80``). Here every
process runs a daemon thread that bumps its heartbeat counter in the
group's coordination KV every ``interval_s``. ``dead_peers(timeout_s)``
names the peers whose counter has not moved for ``timeout_s`` on this
process's clock (no clock sync needed); a peer that left through
:meth:`FailureDetector.stop` is never named. ``start_watchdog`` turns
detection into action: ``on_failure(newly_dead)``, called once per dead
rank from the heartbeat thread (the session wires the async bus's
``mark_dead``, survivor mode), or by default a logged ``os._exit(17)``,
so a lost process ends the job within a bounded time instead of hanging
its next collective. A heartbeat that cannot be published for longer
than the watchdog's timeout reports rank 0 (the store's host) dead.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..log import Log


class FailureDetector:
    """Per-process heartbeat publisher and peer liveness monitor."""

    def __init__(self, interval_s: float = 1.0, session=None) -> None:
        from ..runtime import Session

        sess = session or Session.get()
        if not sess.started:
            Log.fatal("FailureDetector requires an initialised session")
        self._rank, self._size = sess.rank, sess.size
        self._interval = float(interval_s)
        self._client = None
        self._stop = threading.Event()
        self._watch_cb: Optional[Callable[[List[int]], None]] = None
        self._watch_timeout = 0.0
        self._reported: set = set()   # ranks already handed to the callback
        # per peer: (last counter value seen, local monotonic time of that)
        self._seen: Dict[int, tuple] = {}
        if self._size > 1:
            self._client = sess.client
            if self._client is None:
                Log.fatal("FailureDetector: the session has no "
                          "coordination KV")
            self._key = f"mvhb/{self._rank}"
            self._client.key_value_increment(self._key, 1)
            now = time.monotonic()
            self._seen = {r: (0, now) for r in range(self._size)
                          if r != self._rank}
            self._thread = threading.Thread(
                target=self._beat_loop, name="mvhb", daemon=True)
            self._thread.start()

    # -- publisher ---------------------------------------------------------
    def _beat_loop(self) -> None:
        errors = 0
        first_err: Optional[float] = None
        while not self._stop.wait(self._interval):
            try:
                self._client.key_value_increment(self._key, 1)
                errors = 0
                first_err = None
            except Exception as exc:
                # a blip must not stop the beat (peers would declare a
                # healthy process dead); a store unreachable for longer
                # than the watchdog's timeout is rank 0's death
                errors += 1
                now = time.monotonic()
                first_err = first_err or now
                if not self._stop.is_set() and errors in (1, 10, 100):
                    Log.error("heartbeat publish failed (x%d): %s",
                              errors, exc)
                cb = self._watch_cb
                if (cb is not None and self._watch_timeout > 0
                        and now - first_err > self._watch_timeout
                        and not self._stop.is_set()):
                    self._watch_cb = None
                    cb([0])
                continue
            cb = self._watch_cb
            if cb is not None:
                try:
                    dead = self.dead_peers(self._watch_timeout)
                except Exception:
                    continue
                # each dead rank is reported once and the watchdog stays
                # armed for the next
                new = [r for r in dead if r not in self._reported]
                if new:
                    self._reported.update(new)
                    cb(new)

    # -- monitor -----------------------------------------------------------
    def _peer_count(self, r: int) -> int:
        try:
            return int(self._client.key_value_try_get(f"mvhb/{r}"))
        except KeyError:
            return 0

    def _peer_finished(self, r: int) -> bool:
        try:
            self._client.key_value_try_get(f"mvhb/{r}/done")
            return True
        except KeyError:
            return False

    def dead_peers(self, timeout_s: float) -> List[int]:
        """Ranks whose heartbeat has not moved for ``timeout_s`` (peers
        that left through :meth:`stop` excepted)."""
        if self._client is None:
            return []
        now = time.monotonic()
        dead = []
        for r in list(self._seen):
            count = self._peer_count(r)
            last_count, last_time = self._seen[r]
            if count != last_count:
                self._seen[r] = (count, now)
            elif now - last_time > timeout_s:
                if self._peer_finished(r):
                    del self._seen[r]       # a clean exit: stop watching
                else:
                    dead.append(r)
        return dead

    def start_watchdog(self, timeout_s: float,
                       on_failure: Optional[Callable[[List[int]], None]]
                       = None) -> None:
        """Call ``on_failure(newly_dead_ranks)`` when peers miss their
        heartbeats for ``timeout_s``; by default log and ``os._exit(17)``
        (restart the job and resume from the latest checkpoint)."""
        if self._client is None:
            return

        def _default(dead: List[int]) -> None:
            # on the heartbeat thread: an exception would only end this
            # thread while the main one hangs in its next collective
            import os

            Log.error(f"peer rank(s) {dead} missed heartbeats for "
                      f"{timeout_s:.0f}s; exiting (restart the job and "
                      f"resume with io.checkpoint.restore_latest())")
            os._exit(17)

        self._watch_timeout = float(timeout_s)
        self._watch_cb = on_failure or _default

    def stop(self) -> None:
        """Leave cleanly: mark this rank done so the peers stop watching
        it, then end the heartbeat."""
        self._stop.set()
        if self._client is not None:
            self._thread.join(timeout=self._interval + 5.0)
            try:
                self._client.key_value_set(f"mvhb/{self._rank}/done", "1")
            except Exception:
                pass   # exiting anyway; the peers fall back to the timeout
