"""Deterministic, seedable fault injection for the serving fleet.

Counterpart of ``multiverso_tpu/serving/faultinject.py``: the same
``-chaos`` grammar, and the same ``(spec, seed)`` gives the JAX
package's schedule, decision for decision. The trainer points parse
here; their hooks (the parameter plane and the WAL) are not ported yet.

A fault-tolerance claim that was never exercised is a comment, not a
property. This module is the exercise plane: a :class:`FaultPlan` is a
parsed, *seeded* schedule of named failure points that the replica and
its wire publisher consult at well-defined places — the same plan drives
the chaos unit tests, the 3-process acceptance test, and
``chip_smoke.py``'s fleet phase, so "recovery works" is a number
(``requests_lost == 0``, ``recovery_time_s``) a run checks, not a
belief.

Named failure points (the ``-chaos`` spec grammar; directives are
comma-separated, all optional)::

    kill_at_request=K        exit the replica process (exit code 43) the
                             moment it dequeues its K-th targeted
                             request (1-based) — mid-trace, before the
                             reply exists
    wedge_at_request=K:T     sleep T seconds before executing request K
                             (a wedged engine step: the process stays
                             alive and heartbeating while making no
                             request progress)
    wire_delay=T:P           before each outbound wire record, sleep T
                             seconds with probability P (seeded)
    wire_drop=P              suppress each outbound NON-ESSENTIAL wire
                             record (heartbeats) with probability P
                             (seeded); request/response records are
                             never dropped — TCP already owns payload
                             integrity, the interesting failure is the
                             *liveness signal* going quiet
    slow_heartbeat=X         multiply the replica's heartbeat interval
                             by X (a replica that looks dead without
                             being dead — the router must not lose its
                             requests when it flags it)
    burst=K:N                as the replica dequeues its K-th targeted
                             request, submit N EXTRA copies of that
                             prompt straight into its local engine —
                             a one-replica traffic spike that drives
                             the priority scheduler and (with a tight
                             pool) the preemption machinery under
                             real pressure
    pool_squeeze=K:F[:R]     at request K, hold fraction F (0..1) of
                             the replica engine's KV block pool
                             hostage (``engine.squeeze_pool``) so
                             live traffic sees a shrunken pool and
                             growth must preempt; release at request
                             R (omitted = held until engine stop)
    kv_xfer_drop=K           drop the K-th (1-based) outbound KV-block
                             transfer mid-flight: the prefill replica
                             strips the payload's K/V bytes
                             (``kv_transfer.drop_blocks``) before
                             publishing, keeping the header + hash
                             chain so the loss is observable. The
                             decode side splices nothing new and
                             re-prefills the prompt locally — a
                             dropped transfer must cost latency,
                             never tokens (``output_mismatches`` 0,
                             ``requests_lost`` 0)

Trainer-side failure points (the durability pipeline's chaos):

    kill_trainer_at_publish=K   exit the trainer (exit code 43) at its
                             K-th parameter publish (1-based), BEFORE
                             the record hits the wire — the
                             acknowledged-and-journaled update whose
                             publish never happened is exactly what
                             checkpoint+WAL recovery must not lose
    wal_torn_tail            at the kill, tear the journal's LAST
                             record in half (the crash caught the
                             append mid-write) — recovery must
                             truncate it deterministically
    wal_bad_crc              at the kill, flip a payload bit in the
                             journal's last record — same recovery
                             path, different corruption
    zombie_epoch=K:E         from the K-th publish on, stamp records
                             with stale epoch E — the
                             paused-then-resumed zombie trainer whose
                             publishes the fleet's epoch fence must
                             reject

Determinism: every probabilistic decision draws from one
``random.Random(seed)`` stream in consultation order, so a given
``(spec, seed)`` pair replays the identical fault schedule — a flaky
chaos test is a real bug, not an unlucky roll. Kills go through
``kill_fn`` so in-process fleets (chip_smoke.py, the unit tests) can
substitute an abrupt in-process death for ``os._exit``; subprocess
replicas get the real thing.
"""

from __future__ import annotations

import os
import random
from typing import Any, Callable, Dict, Optional

from ..log import Log

#: replica exit code for an injected kill — distinguishable from a crash
KILL_EXIT = 43


def _default_kill() -> None:    # pragma: no cover - subprocess-only path
    # os._exit, not sys.exit: the point is an ABRUPT death (no atexit,
    # no transport drain, no engine stop) — the failure mode the fleet
    # must survive, not a graceful shutdown it could negotiate with
    os._exit(KILL_EXIT)


class FaultPlan:
    """One parsed ``-chaos`` spec: the schedule a replica consults.

    All methods are cheap and safe to call with no faults configured
    (``FaultPlan("")`` is the always-healthy plan); ``counts`` records
    every fault actually fired, and rides ``ReplicaServer.stats()`` so
    a chaos run's report says what the plan *did*, not just what it
    said.
    """

    def __init__(self, spec: str = "", seed: int = 0,
                 kill_fn: Optional[Callable[[], None]] = None) -> None:
        self.spec = spec or ""
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._kill_fn = kill_fn or _default_kill
        self.kill_at: int = 0                 # 0 = never
        self.wedge_at: int = 0
        self.wedge_s: float = 0.0
        self.delay_s: float = 0.0
        self.delay_p: float = 0.0
        self.drop_p: float = 0.0
        self.heartbeat_scale: float = 1.0
        self.kill_trainer_at: int = 0         # 0 = never
        self.wal_fault: str = ""              # "", torn_tail, bad_crc
        self.zombie_at: int = 0               # 0 = never
        self.zombie_epoch: int = 0
        self.burst_at: int = 0                # 0 = never
        self.burst_count: int = 0
        self.squeeze_at: int = 0              # 0 = never
        self.squeeze_fraction: float = 0.0
        self.squeeze_release_at: int = 0      # 0 = never released
        self.xfer_drop_at: int = 0            # 0 = never
        self._wal = None                      # attach_wal() target
        self.counts: Dict[str, int] = {
            "kills": 0, "wedges": 0, "wire_delays": 0, "wire_drops": 0,
            "trainer_kills": 0, "wal_faults": 0, "zombie_publishes": 0,
            "bursts": 0, "pool_squeezes": 0, "kv_xfer_drops": 0}
        for directive in filter(None,
                                (d.strip() for d in self.spec.split(","))):
            key, _, val = directive.partition("=")
            if not val and key.strip() in ("wal_torn_tail",
                                           "wal_bad_crc"):
                val = "1"       # valueless flag directives, as documented
            if not val:
                raise ValueError(f"chaos directive {directive!r} needs "
                                 f"KEY=VALUE")
            try:
                self._apply(key.strip(), val.strip())
            except (TypeError, ValueError) as exc:
                raise ValueError(
                    f"bad chaos directive {directive!r}: {exc}") from None

    def _apply(self, key: str, val: str) -> None:
        if key == "kill_at_request":
            self.kill_at = int(val)
        elif key == "wedge_at_request":
            k, _, t = val.partition(":")
            self.wedge_at, self.wedge_s = int(k), float(t or 0.0)
        elif key == "wire_delay":
            t, _, p = val.partition(":")
            self.delay_s = float(t)
            self.delay_p = float(p) if p else 1.0
        elif key == "wire_drop":
            self.drop_p = float(val)
        elif key == "slow_heartbeat":
            self.heartbeat_scale = float(val)
            if self.heartbeat_scale < 1.0:
                raise ValueError("slow_heartbeat scale must be >= 1")
        elif key == "kill_trainer_at_publish":
            self.kill_trainer_at = int(val)
        elif key == "wal_torn_tail":
            if val not in ("1", "true"):
                raise ValueError("wal_torn_tail takes =1")
            self.wal_fault = "torn_tail"
        elif key == "wal_bad_crc":
            if val not in ("1", "true"):
                raise ValueError("wal_bad_crc takes =1")
            self.wal_fault = "bad_crc"
        elif key == "zombie_epoch":
            k, _, e = val.partition(":")
            self.zombie_at, self.zombie_epoch = int(k), int(e or 0)
            if self.zombie_at < 1:
                raise ValueError("zombie_epoch needs K >= 1 (K:E)")
        elif key == "burst":
            k, _, n = val.partition(":")
            self.burst_at, self.burst_count = int(k), int(n or 0)
            if self.burst_at < 1 or self.burst_count < 1:
                raise ValueError("burst needs K >= 1 and N >= 1 (K:N)")
        elif key == "pool_squeeze":
            k, _, rest = val.partition(":")
            f, _, r = rest.partition(":")
            self.squeeze_at = int(k)
            self.squeeze_fraction = float(f or 0.0)
            self.squeeze_release_at = int(r) if r else 0
            if self.squeeze_at < 1:
                raise ValueError("pool_squeeze needs K >= 1 (K:F[:R])")
            if not 0.0 < self.squeeze_fraction <= 1.0:
                raise ValueError("pool_squeeze fraction F must be in "
                                 "(0, 1]")
            if (self.squeeze_release_at
                    and self.squeeze_release_at <= self.squeeze_at):
                raise ValueError("pool_squeeze release R must come "
                                 "after K")
        elif key == "kv_xfer_drop":
            self.xfer_drop_at = int(val)
            if self.xfer_drop_at < 1:
                raise ValueError("kv_xfer_drop needs K >= 1")
        else:
            raise ValueError(f"unknown failure point {key!r}")

    @classmethod
    def from_flags(cls, kill_fn: Optional[Callable[[], None]] = None
                   ) -> "FaultPlan":
        """The ``-chaos`` / ``-chaos_seed`` flag pair as a plan."""
        from .. import config

        return cls(config.get_flag("chaos"),
                   seed=int(config.get_flag("chaos_seed")),
                   kill_fn=kill_fn)

    # -- failure points ------------------------------------------------------
    def on_request(self, k: int) -> float:
        """Consulted as the replica dequeues its ``k``-th (1-based)
        targeted request. Fires the kill (does not return) or returns
        the seconds to wedge before executing (0.0 = healthy)."""
        if self.kill_at and k == self.kill_at:
            self.counts["kills"] += 1
            Log.error("chaos: killing replica at request %d "
                      "(kill_at_request)", k)
            self._kill_fn()
            return 0.0          # in-process kill_fn substitutes may return
        if self.wedge_at and k == self.wedge_at and self.wedge_s > 0:
            self.counts["wedges"] += 1
            Log.error("chaos: wedging request %d for %.3f s", k,
                      self.wedge_s)
            return self.wedge_s
        return 0.0

    def attach_wal(self, wal) -> None:
        """Point the WAL-corruption faults at a journal (anything with
        ``corrupt_tail(kind)``); the trainer bootstrap wires the
        session's write-ahead journal here."""
        self._wal = wal

    def on_trainer_publish(self, k: int) -> None:
        """Consulted as the trainer issues its ``k``-th (1-based)
        parameter publish, BEFORE the record hits the wire. Fires the
        trainer kill (does not return) — first staging the armed WAL
        corruption, so the crash leaves exactly the torn/bad tail the
        recovery path must truncate."""
        if self.kill_trainer_at and k == self.kill_trainer_at:
            if self.wal_fault and self._wal is not None:
                self.counts["wal_faults"] += 1
                Log.error("chaos: corrupting WAL tail (%s) before the "
                          "trainer kill", self.wal_fault)
                self._wal.corrupt_tail(self.wal_fault)
            self.counts["trainer_kills"] += 1
            Log.error("chaos: killing trainer at publish %d "
                      "(kill_trainer_at_publish)", k)
            self._kill_fn()

    def publish_epoch(self, k: int, epoch: int) -> int:
        """Epoch to stamp the ``k``-th publish with: the claimed
        ``epoch``, or the stale zombie epoch once ``zombie_epoch=K:E``
        is in effect (the fence-rejection the acceptance test counts)."""
        if self.zombie_at and k >= self.zombie_at:
            self.counts["zombie_publishes"] += 1
            return self.zombie_epoch
        return epoch

    def burst_n(self, k: int) -> int:
        """Consulted as the replica dequeues request ``k``: how many
        EXTRA copies of it to submit to the local engine (0 = none)."""
        if self.burst_at and k == self.burst_at:
            self.counts["bursts"] += 1
            Log.error("chaos: bursting %d extra request(s) at request "
                      "%d", self.burst_count, k)
            return self.burst_count
        return 0

    def squeeze_frac(self, k: int) -> Optional[float]:
        """Pool fraction to squeeze at request ``k`` (None = none)."""
        if self.squeeze_at and k == self.squeeze_at:
            self.counts["pool_squeezes"] += 1
            Log.error("chaos: squeezing %.0f%% of the KV pool at "
                      "request %d", self.squeeze_fraction * 100, k)
            return self.squeeze_fraction
        return None

    def squeeze_release(self, k: int) -> bool:
        """True when the staged squeeze releases at request ``k``."""
        return bool(self.squeeze_release_at
                    and k == self.squeeze_release_at)

    def wire_delay_s(self) -> float:
        """Consulted before each outbound wire record: seconds to stall
        the send (0.0 = send now)."""
        if self.delay_s > 0 and self._rng.random() < self.delay_p:
            self.counts["wire_delays"] += 1
            return self.delay_s
        return 0.0

    def drop_kv_xfer(self, k: int) -> bool:
        """Consulted as the prefill replica publishes its ``k``-th
        (1-based) KV-block transfer: True = strip the payload's K/V
        bytes (``kv_transfer.drop_blocks``) before it hits the wire."""
        if self.xfer_drop_at and k == self.xfer_drop_at:
            self.counts["kv_xfer_drops"] += 1
            Log.error("chaos: dropping KV transfer %d mid-flight "
                      "(kv_xfer_drop)", k)
            return True
        return False

    def drop_heartbeat(self) -> bool:
        """Consulted per heartbeat: True = suppress this one."""
        if self.drop_p > 0 and self._rng.random() < self.drop_p:
            self.counts["wire_drops"] += 1
            return True
        return False

    def active(self) -> bool:
        return bool(self.kill_at or self.wedge_at or self.delay_s
                    or self.drop_p or self.heartbeat_scale != 1.0
                    or self.kill_trainer_at or self.wal_fault
                    or self.zombie_at or self.burst_at
                    or self.squeeze_at or self.xfer_drop_at)

    def stats(self) -> Dict[str, Any]:
        return {"spec": self.spec, "seed": self.seed, **self.counts}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"FaultPlan({self.spec!r}, seed={self.seed})"
