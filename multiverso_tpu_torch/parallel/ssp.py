"""SSP: a stale-synchronous-parallel round clock (bounded staleness).

Counterpart of ``multiverso_tpu/parallel/ssp.py``. The reference reserved
the spot and never built it (only sync and async, and a dead
``-backup_worker_ratio``, ``src/server.cpp:20-21,229-231``); this clock
completes the spectrum between BSP (``-sync=true``) and plain async:

* each worker owns a monotonic round counter in the group's coordination
  KV; ``tick()`` ends the local round (its bus publications are already
  visible: a publish is synchronous) and bumps the counter;
* ``wait()`` before round ``r`` blocks while ``r - min(peer rounds) >
  staleness``, so the fastest worker runs at most ``staleness`` rounds
  ahead of the slowest and every read sees peer state at most
  ``staleness`` rounds old (plus the bus's poll interval);
* ``finish()`` releases the peers for good (the reference SyncServer's
  FinishTrain, clock -> INT_MAX, ``src/server.cpp:82-139``).

Round keys are scoped by a generation, so clocks made one after another
in one group never read each other's rounds. The JAX clock has rank 0
draw the generation and then synchronizes every device; here each rank
counts the clocks it has made in its own KV key, and since every process
makes its clocks in the same order (the construction is collective, as in
the JAX package) the counts agree with no barrier.
"""

from __future__ import annotations

import time

from .. import config
from ..log import Log


class SSPClock:
    """Per-process SSP round clock over the group's KV.

    Usage (every process, symmetric)::

        clock = SSPClock(staleness=2)
        for round in range(R):
            clock.wait()          # at most `staleness` ahead of the slowest
            ... compute + table.add(...) ...
            clock.tick()          # publish the round's completion
        clock.finish()            # release the peers for good
    """

    _FINISHED = 1 << 30

    def __init__(self, staleness: int = 1, poll_s: float = 0.01,
                 session=None) -> None:
        from ..runtime import Session

        sess = session or Session.get()
        if not sess.started:
            Log.fatal("SSPClock requires an initialised session")
        if config.get_flag("sync"):
            Log.fatal("SSPClock is for async mode (-sync=false); BSP "
                      "already gates every round")
        self.staleness = int(staleness)
        self._poll = float(poll_s)
        self._rank, self._size = sess.rank, sess.size
        self._round = 0
        self._client = None
        if self._size > 1:
            self._client = sess.client
            if self._client is None:
                Log.fatal("SSPClock: the session has no coordination KV")
            self._gen = self._client.key_value_increment(
                f"mvssp/made/{self._rank}", 1)
            self._key = f"mvssp/{self._gen}/r{self._rank}"
            self._client.key_value_increment(self._key, 0)

    @property
    def round(self) -> int:
        return self._round

    def _peer_round(self, r: int) -> int:
        try:
            return int(self._client.key_value_try_get(
                f"mvssp/{self._gen}/r{r}"))
        except KeyError:   # NOT_FOUND: the peer has not made this clock yet
            return 0

    def wait(self, timeout_s: float = 600.0) -> None:
        """Block until this worker is at most ``staleness`` rounds ahead of
        the slowest peer (a no-op alone). Round counters only grow, so a
        peer seen past the gate is not polled again in this wait."""
        if self._client is None:
            return
        gate = self._round - self.staleness
        behind = [r for r in range(self._size) if r != self._rank]
        deadline = time.monotonic() + timeout_s
        while True:
            still = [r for r in behind if self._peer_round(r) < gate]
            if not still:
                return
            if time.monotonic() > deadline:
                Log.fatal(f"SSP wait timed out at round {self._round} "
                          f"(peers {still} behind round {gate}, "
                          f"staleness {self.staleness})")
            behind = still
            time.sleep(self._poll)

    def tick(self) -> None:
        """End the local round and advance the clock."""
        self._round += 1
        if self._client is None:
            return
        self._client.key_value_increment(self._key, 1)

    def finish(self) -> None:
        """Release the peers for good (``FinishTrain``)."""
        if self._client is None:
            return
        self._client.key_value_increment(self._key,
                                         self._FINISHED - self._round)
