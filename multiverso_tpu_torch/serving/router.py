"""Failure-aware fleet router: N decode replicas, one front door.

Counterpart of ``multiverso_tpu/serving/router.py``, on the same
``mvserve`` wire. :meth:`FleetRouter.replica_rows` also carries each
replica's heartbeat ``tenants`` rows (its cost ledger's top tenants).

The :class:`FleetRouter` is the serving fleet's front-end (rank 0 on
the ``mvserve`` wire): it owns the request queue, dispatches to the
least-loaded UP replica with session affinity (a multi-turn session
sticks to the replica holding its prefix-cache blocks), enforces
per-request deadlines, and — the point of the module — keeps every
accepted request alive across replica failures:

* **liveness is observed**: a replica is UP because its heartbeats say
  so; silence past ``-fleet_dead_after_s`` (default 2 heartbeat
  intervals) or a wire-declared death (``P2PTransport.on_dead``) flags
  it DEAD. The verdict is edge-triggered: one transition, one drain.
* **death drains, never drops**: the dead replica's in-flight set moves
  into the retry queue with exponential backoff + jitter
  (:func:`retry_backoff_s`, bounded by ``-fleet_retry_max``). Requests
  carry idempotent ids and decode is deterministic greedy (the serving
  engine's invariant), so the replay executes the same prompt from scratch on a
  survivor and produces **bit-identical output** — late duplicate
  replies are deduped by id, and a duplicate whose payload differs
  increments ``fleet_redispatch_output_mismatches`` (gated at zero by
  the bench: determinism is an invariant, not a hope).
* **readmission is half-open**: a DEAD replica that heartbeats again
  (restarted process, healed partition) is PROBED — one ``ping`` must
  round-trip on the wire before any real request is dispatched to it.
* **overload degrades loudly — and BY CLASS**: past
  ``-fleet_shed_depth`` aggregate queue depth (pending + retry +
  in-flight) ``submit`` sheds with :class:`~.batcher.OverloadedError`
  ``(what="fleet", retriable=True)`` instead of queueing unboundedly —
  but it sheds the LOWEST class first: an arriving request of a higher
  priority class evicts the newest queued request of the lowest
  pending class rather than being rejected itself, so paying tenants
  keep flowing while batch traffic absorbs the burst
  (``SHED_BY_CLASS[name.pN]`` counters say who paid). Dispatch pops
  the highest class first (FIFO within a class), requests carry
  ``priority``/``deadline_s`` onto the wire and into the replica
  engines' weighted-fair schedulers, a retry whose backoff would land
  past its deadline fails fast with
  :class:`~.batcher.DeadlineExceededError` instead of burning the
  wait, and a replica's ``retriable=False`` shed (a request bigger
  than its whole KV pool) fails immediately instead of burning the
  retry budget on an impossibility.
* **disaggregated prefill/decode is a routing decision**: when the
  fleet has both a ``prefill``-role and a ``decode``-role replica UP
  (roles ride the heartbeats), dispatch goes two-stage — stage 1 sends
  the prompt to a prefill rank (with the decode rank's ``known`` chain
  hashes, so a warm prefix never crosses the wire), the finished KV
  blocks come back as a ``MSG_XFER`` payload bracketed by a
  ``kv.transfer`` span, and stage 2 lands the request + payload on the
  chosen decode rank, which splices the blocks into its pool and
  admits through the full-hit path. Either role pool going empty (or a
  prefill death mid-stage-1) falls back to classic unified admission —
  the payload is a latency optimization, never a correctness
  dependency (:mod:`.kv_transfer`, docs/SERVING.md "Disaggregated
  prefill/decode").

Observability: ``FLEET_DISPATCH``/``FLEET_RETRIES``/``FLEET_REDISPATCH``
/``FLEET_SHED`` counters, per-replica ``FLEET_REPLICA_STATE``/
``FLEET_INFLIGHT``/``FLEET_HB_AGE_MS`` gauges (the obs plane ships them
and ``tools/opscenter.py`` renders replica rows), and a
``route.dispatch`` span per attempt whose context rides the wire — the
replica's spans join the request's trace across the process boundary
(docs/SERVING.md "Serving fleet").
"""

from __future__ import annotations

import collections
import random
import threading
import time
import uuid
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import config, trace
from ..dashboard import Dashboard
from ..log import Log
from ..parallel.p2p import reconnect_backoff_s
from . import kv_transfer
from .batcher import DeadlineExceededError, OverloadedError
from .replica import (LABEL, MSG_ERR, MSG_HB, MSG_PING, MSG_PONG, MSG_REQ,
                      MSG_RSP, MSG_XFER, ROUTER_RANK, decode_msg,
                      encode_msg)

# replica lifecycle states; the numeric codes are the
# FLEET_REPLICA_STATE gauge values (ordered by serviceability)
DEAD, CONNECTING, PROBING, UP = 0, 1, 2, 3
STATE_NAMES = {DEAD: "DEAD", CONNECTING: "CONNECTING",
               PROBING: "PROBING", UP: "UP"}

# replica role codes — the FLEET_ROLE gauge values (disaggregated
# serving). Archives written before the gauge existed read -1 in the
# opscenter, the tolerance of every later gauge.
ROLE_CODES = {"unified": 0, "prefill": 1, "decode": 2}

# per-decode-rank shipped-hash book cap: past this the book clears and
# rebuilds from heartbeat advertisements (a stale book only costs a
# re-shipped block that dedups on arrival — bounded memory wins)
_SHIPPED_CAP = 8192

# NB DeadlineExceededError lives in .batcher now (both serving tiers
# raise it); the import above keeps `from .router import
# DeadlineExceededError` working.


class FleetError(RuntimeError):
    """The request exhausted its re-dispatch budget (every attempt hit
    a dying or shedding replica)."""


def retry_backoff_s(attempt: int, base_s: float, cap_s: float,
                    rng: Optional[random.Random] = None) -> float:
    """Delay before re-dispatch ``attempt`` (1-based): the capped
    exponential ceiling ``min(cap, base * 2**(attempt-1))``, jittered
    into ``[ceiling/2, ceiling]`` when ``rng`` is given (equal-jitter —
    a burst of redispatches from one death must not re-land as one
    synchronized burst). ``rng=None`` returns the deterministic
    ceiling (the unit-testable schedule). One schedule, one
    implementation: this is the transport's reconnect schedule
    (:func:`~..parallel.p2p.reconnect_backoff_s`) with
    1-based indexing."""
    if attempt < 1:
        raise ValueError(f"attempt is 1-based, got {attempt}")
    return reconnect_backoff_s(attempt - 1, base_s, cap_s, rng)


@dataclass
class FleetConfig:
    """Router knobs; ``None`` falls back to the ``-fleet_*`` flags."""

    heartbeat_ms: Optional[int] = None
    dead_after_s: Optional[float] = None      # 0/None -> 2 heartbeats
    retry_max: Optional[int] = None
    backoff_ms: Optional[float] = None
    backoff_cap_ms: Optional[float] = None
    shed_depth: Optional[int] = None
    deadline_s: Optional[float] = None

    def resolved(self) -> "FleetConfig":
        def flag(field, name):
            v = getattr(self, field)
            return config.get_flag(name) if v is None else v

        hb_ms = int(flag("heartbeat_ms", "fleet_heartbeat_ms"))
        dead = float(flag("dead_after_s", "fleet_dead_after_s"))
        if dead <= 0:
            dead = 2.0 * hb_ms / 1000.0
        return FleetConfig(
            heartbeat_ms=hb_ms, dead_after_s=dead,
            retry_max=int(flag("retry_max", "fleet_retry_max")),
            backoff_ms=float(flag("backoff_ms", "fleet_backoff_ms")),
            backoff_cap_ms=float(flag("backoff_cap_ms",
                                      "fleet_backoff_cap_ms")),
            shed_depth=int(flag("shed_depth", "fleet_shed_depth")),
            deadline_s=float(flag("deadline_s", "fleet_deadline_s")))


class _FleetRequest:
    __slots__ = ("rid", "prompt", "max_new", "session", "deadline",
                 "attempts", "future", "replica", "t_enq", "root",
                 "dispatch_span", "redispatched", "exclude", "priority",
                 "stage", "decode_rank", "xfer", "xfer_span", "tenant")

    def __init__(self, prompt: np.ndarray, max_new: Optional[int],
                 session: Optional[str], deadline: float, root,
                 priority: int = 1,
                 tenant: Optional[str] = None) -> None:
        self.rid = uuid.uuid4().hex[:16]
        self.prompt = np.asarray(prompt, np.int32).ravel()
        self.max_new = max_new
        self.session = session
        self.deadline = deadline
        self.priority = int(priority)
        self.tenant = tenant
        self.attempts = 0
        self.future: Future = Future()
        self.replica: Optional[int] = None
        self.t_enq = time.monotonic()
        self.root = root
        self.dispatch_span = None
        self.redispatched = False
        self.exclude: Optional[int] = None   # rank that just failed it
        # disaggregated two-stage dispatch state: stage is None (plain)
        # or "prefill" (stage 1 in flight at a prefill replica);
        # decode_rank is the replica the KV payload is destined for;
        # xfer holds the arrived payload while stage 2 waits to dispatch
        self.stage: Optional[str] = None
        self.decode_rank: Optional[int] = None
        self.xfer: Optional[Dict[str, Any]] = None
        self.xfer_span = None


class _ClassQueue:
    """The router's pending lanes: one FIFO deque per priority class.

    Dispatch is strict-priority (highest class first, FIFO within —
    fairness between tenants lives in the replica engines' weighted-
    fair schedulers; the router's job is just to not let low-class
    work block high-class work at the front door), and overload shed
    evicts from the LOWEST class, newest first (the request that
    waited least loses). Callers hold the router lock."""

    def __init__(self) -> None:
        self._lanes: Dict[int, collections.deque] = {}
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, req: _FleetRequest) -> None:
        self._lanes.setdefault(req.priority,
                               collections.deque()).append(req)
        self._n += 1

    def appendleft(self, req: _FleetRequest) -> None:
        """Retries re-enter at the FRONT of their class (they are the
        oldest work that class has)."""
        self._lanes.setdefault(req.priority,
                               collections.deque()).appendleft(req)
        self._n += 1

    def peek(self) -> Optional[_FleetRequest]:
        for p in sorted(self._lanes, reverse=True):
            if self._lanes[p]:
                return self._lanes[p][0]
        return None

    def popleft(self) -> Optional[_FleetRequest]:
        for p in sorted(self._lanes, reverse=True):
            if self._lanes[p]:
                self._n -= 1
                return self._lanes[p].popleft()
        return None

    def shed_lowest_below(self, priority: int) -> Optional[_FleetRequest]:
        """Evict the NEWEST queued request of the lowest non-empty
        class strictly below ``priority`` (None = nothing lower is
        queued — the arrival itself sheds)."""
        for p in sorted(self._lanes):
            if p >= priority:
                break
            if self._lanes[p]:
                self._n -= 1
                return self._lanes[p].pop()
        return None

    def expire(self, now: float) -> List[_FleetRequest]:
        """Remove and return every queued request past its deadline."""
        out: List[_FleetRequest] = []
        for lane in self._lanes.values():
            if any(r.deadline <= now for r in lane):
                keep = [r for r in lane if r.deadline > now]
                out.extend(r for r in lane if r.deadline <= now)
                lane.clear()
                lane.extend(keep)
        self._n -= len(out)
        return out

    def drain(self) -> List[_FleetRequest]:
        out: List[_FleetRequest] = []
        for lane in self._lanes.values():
            out.extend(lane)
            lane.clear()
        self._n = 0
        return out


class _Replica:
    __slots__ = ("rank", "state", "last_hb", "health", "inflight",
                 "wire_dead", "probe_rid", "deaths", "readmissions",
                 "state_gauge", "inflight_gauge", "hb_age_gauge",
                 "snap_gauge", "preempt_gauge", "role", "role_gauge")

    def __init__(self, rank: int, router_name: str) -> None:
        self.rank = rank
        self.state = CONNECTING
        self.role = "unified"               # learned from heartbeats
        self.last_hb: Optional[float] = None
        self.health: Dict[str, Any] = {}
        self.inflight: set = set()          # rids currently assigned here
        self.wire_dead = False              # transport-declared: terminal
        self.probe_rid: Optional[str] = None
        self.deaths = 0
        self.readmissions = 0
        self.state_gauge = Dashboard.get_or_create_gauge(
            f"FLEET_REPLICA_STATE[{router_name}.{rank}]")
        self.inflight_gauge = Dashboard.get_or_create_gauge(
            f"FLEET_INFLIGHT[{router_name}.{rank}]")
        self.hb_age_gauge = Dashboard.get_or_create_gauge(
            f"FLEET_HB_AGE_MS[{router_name}.{rank}]")
        # the replica's SERVED snapshot version (from its heartbeat
        # health): a fleet serving divergent or frozen versions is
        # visible at a glance in the opscenter replica rows
        self.snap_gauge = Dashboard.get_or_create_gauge(
            f"FLEET_SNAPSHOT_VERSION[{router_name}.{rank}]")
        # the replica engine's cumulative preemption count (from its
        # heartbeat health): overload churn per replica at a glance in
        # the opscenter replica rows
        self.preempt_gauge = Dashboard.get_or_create_gauge(
            f"FLEET_PREEMPTS[{router_name}.{rank}]")
        # the replica's serving role (from its heartbeat): a
        # disaggregated fleet's prefill/decode split at a glance in
        # the opscenter replica rows (ROLE_CODES)
        self.role_gauge = Dashboard.get_or_create_gauge(
            f"FLEET_ROLE[{router_name}.{rank}]")
        self.state_gauge.set(CONNECTING)
        self.role_gauge.set(ROLE_CODES["unified"])


class FleetRouter:
    """Front door for a replicated decode fleet (``mvserve`` rank 0)."""

    def __init__(self, size: int, client: Any, label: str = LABEL,
                 fleet_config: Optional[FleetConfig] = None,
                 name: str = "fleet") -> None:
        from ..parallel.p2p import P2PTransport

        if size < 2:
            raise ValueError(f"fleet size {size} needs >= 1 replica")
        self.name = name
        self.size = int(size)
        self._client = client
        self._label = label
        self.config = (fleet_config or FleetConfig()).resolved()
        self._lock = threading.Lock()
        self._replicas: Dict[int, _Replica] = {
            r: _Replica(r, name) for r in range(1, size)}
        self._pending = _ClassQueue()
        self.shed_by_class: Dict[int, int] = {}
        self._shed_class_counters: Dict[int, Any] = {}
        self._retry: List[Tuple[float, _FleetRequest]] = []
        self._inflight: Dict[str, _FleetRequest] = {}
        self._affinity: Dict[str, int] = {}
        # completed rids -> result digest, bounded: dedupes the late
        # duplicate replies the replay path makes legitimate, and is
        # what lets a duplicate's payload be CHECKED for bit-identity
        self._done: "collections.OrderedDict[str, Optional[int]]" = \
            collections.OrderedDict()
        self._done_cap = 4096
        self._expect: Dict[int, int] = {r: 0 for r in self._replicas}
        self._acked: Dict[int, int] = {r: 0 for r in self._replicas}
        self._seq = 0
        self._released = 0
        self._head_published = -1       # last head value written to KV
        self._next_ack_poll = 0.0       # ack reads run at hb cadence
        self._probe_n = 0
        self._rng = random.Random(0x466C3374)   # retry jitter stream
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.deadline_failures = 0
        self.duplicate_replies = 0
        self.output_mismatches = 0
        # disaggregated transfer-plane accounting + the per-decode-rank
        # book of KV-block hashes known to be resident there (union of
        # payloads routed to it and its heartbeat advertisements);
        # "known" hashes are told to the prefill side so warm prefixes
        # never cross the wire
        self.kv_xfers = 0
        self.kv_bytes_moved = 0
        self.xfer_blocks = 0
        self.xfer_dedup_blocks = 0
        self._shipped: Dict[int, set] = {}
        self._last_death: Optional[float] = None
        self._last_recovery: Optional[float] = None
        self._dispatch_counter = Dashboard.get_or_create_counter(
            "FLEET_DISPATCH")
        self._retries_counter = Dashboard.get_or_create_counter(
            "FLEET_RETRIES")
        self._redispatch_counter = Dashboard.get_or_create_counter(
            "FLEET_REDISPATCH")
        self._shed_counter = Dashboard.get_or_create_counter("FLEET_SHED")
        self._transport = P2PTransport(
            ROUTER_RANK, self.size, client, label=label,
            subscribe_to=sorted(self._replicas),
            on_dead=self._on_wire_dead)
        self._publish_head()
        self._stop = threading.Event()
        # one loop owns all routing state transitions: drain, liveness,
        # retries, deadlines, dispatch — ticked fast enough that the
        # DEAD verdict lands well inside the 2-heartbeat contract
        self._tick_s = max(0.005, self.config.heartbeat_ms / 4000.0)
        self._thread = threading.Thread(
            target=self._loop, name=f"mvserve-router", daemon=True)
        self._thread.start()
        Log.info("fleet: router up over %d replica(s) (hb %d ms, dead "
                 "after %.3f s, retry_max %d, shed at %d)",
                 size - 1, self.config.heartbeat_ms,
                 self.config.dead_after_s, self.config.retry_max,
                 self.config.shed_depth)

    # -- submit path ---------------------------------------------------------
    def _count_shed(self, priority: int) -> None:
        self.shed += 1
        self.shed_by_class[priority] = \
            self.shed_by_class.get(priority, 0) + 1
        counter = self._shed_class_counters.get(priority)
        if counter is None:
            counter = Dashboard.get_or_create_counter(
                f"SHED_BY_CLASS[{self.name}.p{priority}]")
            self._shed_class_counters[priority] = counter
        counter.inc()

    def submit(self, prompt: np.ndarray, max_new: Optional[int] = None,
               session: Optional[str] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[int] = None,
               tenant: Optional[str] = None) -> Future:
        """Enqueue one prompt for the fleet; resolves to the reply dict
        ``{"result", "snapshot_version", "staleness_s", "replica"}``.
        ``session`` keys affinity (multi-turn conversations hit the
        same replica's prefix cache while it stays UP); ``deadline_s``
        overrides ``-fleet_deadline_s``; ``priority`` is the tenant
        class (0..7, higher = more important; None = class 1), carried
        over the wire into the replica engines' weighted-fair
        schedulers. Past the aggregate queue cap the fleet sheds BY
        CLASS, lowest first: a higher-class arrival evicts the newest
        queued lowest-class request (that one's future fails with the
        ``OverloadedError``) instead of being rejected itself; only
        when nothing lower is queued does the arrival shed
        (``retriable=True`` either way — fleet overload is
        transient). ``tenant`` is the accounting id the replica
        engines' cost ledgers attribute usage to (rides the wire only
        when set — absent keys fall back to each replica's
        ``-default_tenant``, so old replicas keep working)."""
        root = trace.start_span("serve.request", root=True,
                                model=self.name, fleet=True)
        deadline = time.monotonic() + float(
            self.config.deadline_s if deadline_s is None else deadline_s)
        prio = 1 if priority is None else int(priority)
        if not 0 <= prio <= 7:
            root.end(error="ValueError")
            raise ValueError(f"priority {prio} outside [0, 7]")
        req = _FleetRequest(prompt, max_new, session, deadline, root,
                            priority=prio, tenant=tenant)
        victim: Optional[_FleetRequest] = None
        with self._lock:
            stopped = self._stop.is_set()
            depth = -1
            if not stopped:
                depth = (len(self._pending) + len(self._retry)
                         + len(self._inflight))
                if depth >= self.config.shed_depth:
                    # shed by class: the lowest queued class below the
                    # arrival pays; the arrival itself only sheds when
                    # nothing lower is pending
                    victim = self._pending.shed_lowest_below(prio)
                    if victim is not None:
                        self._count_shed(victim.priority)
                        self.submitted += 1
                        self._pending.append(req)
                        depth = -1
                    else:
                        self._count_shed(prio)
                else:
                    self.submitted += 1
                    self._pending.append(req)
                    depth = -1
        if stopped:
            # the root span still closes on the reject path — a raise
            # must never leave an open span in the collector
            root.end(error="stopped")
            raise RuntimeError(f"fleet router {self.name!r} is stopped")
        if victim is not None:
            # the evicted request resolves OUTSIDE the lock (its
            # done-callbacks are user code) — submitted stays counted,
            # failed balances the requests_lost identity
            with self._lock:
                self.failed += 1
            self._shed_counter.inc()
            self._apply_resolutions([(victim, OverloadedError(
                self.name, self.config.shed_depth,
                self.config.shed_depth, what="fleet"))])
        if depth >= 0:
            self._shed_counter.inc()
            root.end(error="OverloadedError")
            raise OverloadedError(self.name, depth,
                                  self.config.shed_depth, what="fleet")
        if root is not trace.NULL_SPAN:
            req.future.add_done_callback(lambda f, sp=root: sp.end(
                ok=(not f.cancelled()) and f.exception() is None))
        return req.future

    def predict(self, prompt: np.ndarray, max_new: Optional[int] = None,
                session: Optional[str] = None,
                timeout_s: float = 60.0,
                priority: Optional[int] = None,
                tenant: Optional[str] = None) -> dict:
        return self.submit(prompt, max_new, session, priority=priority,
                           tenant=tenant).result(timeout=timeout_s)

    # -- wire death hook -----------------------------------------------------
    def _on_wire_dead(self, ranks) -> None:
        """Transport-declared deaths (out-of-contract resume): terminal
        for the rank — the wire itself refuses its streams now, so
        there is no readmission path. Runs on a transport thread,
        outside every router lock."""
        resolutions: List[Tuple[_FleetRequest, Any]] = []
        with self._lock:
            for r in ranks:
                rep = self._replicas.get(int(r))
                if rep is None:
                    continue
                rep.wire_dead = True
                if rep.state != DEAD:
                    self._mark_dead_locked(rep, "wire on_dead",
                                           resolutions)
        self._apply_resolutions(resolutions)

    # -- the routing loop ----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self._tick_s):
            try:
                self.tick()
            except Exception as exc:    # pragma: no cover - defensive
                Log.error("fleet router: tick failed: %s", exc)

    def tick(self) -> None:
        """One routing pass (the loop calls it every few ms; tests call
        it directly). All state mutation happens under ``_lock``;
        future resolutions and wire sends are collected and fired
        OUTSIDE it (a future's done-callbacks are user code, and the
        send path blocks on chaos delays)."""
        now = time.monotonic()
        inbound = self._drain_wire()
        resolutions: List[Tuple[_FleetRequest, Any]] = []
        sends: List[Dict[str, Any]] = []
        with self._lock:
            for node, msg in inbound:
                self._handle_locked(node, msg, now, resolutions)
            self._check_liveness_locked(now, resolutions, sends)
            self._run_retries_locked(now)
            self._check_deadlines_locked(now, resolutions)
            self._dispatch_locked(now, sends)
            for rep in self._replicas.values():
                rep.inflight_gauge.set(len(rep.inflight))
                if rep.last_hb is not None:
                    rep.hb_age_gauge.set((now - rep.last_hb) * 1e3)
                    rep.snap_gauge.set(float(
                        (rep.health or {}).get("snapshot_version", -1)))
                    rep.preempt_gauge.set(float(
                        (rep.health or {}).get("preemptions", 0)))
        self._apply_resolutions(resolutions)
        for msg in sends:
            self._publish(msg)
        self._ack_and_release()

    # -- inbound -------------------------------------------------------------
    def _drain_wire(self) -> List[Tuple[int, Dict[str, Any]]]:
        out: List[Tuple[int, Dict[str, Any]]] = []
        for r in sorted(self._replicas):
            while True:
                payload = self._transport.pop_ready(r, self._expect[r])
                if payload is None:
                    break
                self._expect[r] += 1
                try:
                    out.append((r, decode_msg(payload)))
                except ValueError:
                    Log.error("fleet: undecodable record from replica "
                              "%d (seq %d)", r, self._expect[r] - 1)
        return out

    def _handle_locked(self, node: int, msg: Dict[str, Any], now: float,
                       resolutions) -> None:
        rep = self._replicas[node]
        kind = msg.get("t")
        if kind == MSG_HB:
            rep.last_hb = now
            rep.health = msg.get("health") or {}
            role = msg.get("role") or "unified"
            if role != rep.role and role in ROLE_CODES:
                rep.role = role
                rep.role_gauge.set(ROLE_CODES[role])
            if rep.state == CONNECTING:
                self._set_state_locked(rep, UP)
            return
        if kind == MSG_PONG:
            if rep.state == PROBING and msg.get("rid") == rep.probe_rid:
                rep.probe_rid = None
                rep.readmissions += 1
                self._set_state_locked(rep, UP)
                Log.info("fleet: replica %d readmitted (probe %s "
                         "round-tripped)", node, msg.get("rid"))
            return
        if kind == MSG_XFER:
            # stage-1 complete: a prefill replica finished chunk-
            # prefilling and shipped the paged KV blocks. Release the
            # prefill assignment and re-enqueue the request at the
            # FRONT of its class as stage 2 (payload in tow) — it is
            # the oldest work its class has, and the decode side goes
            # live at P-1 through the full-hit admission path
            rid = msg.get("rid")
            req = self._inflight.get(rid)
            if req is None:
                return          # late duplicate / already re-dispatched
            for holder in self._replicas.values():
                holder.inflight.discard(rid)
            del self._inflight[rid]
            payload = msg.get("payload") or {}
            shipped = kv_transfer.shipped_hashes(payload)
            nbytes = kv_transfer.payload_bytes(payload)
            dedup = int(payload.get("dedup_blocks", 0))
            self.kv_xfers += 1
            self.kv_bytes_moved += nbytes
            self.xfer_blocks += len(shipped)
            self.xfer_dedup_blocks += dedup
            if req.decode_rank is not None and not payload.get("dropped"):
                # every hash in an intact payload is resident at the
                # decode rank after the splice (the dedup'd ones
                # already were) — a chaos-dropped payload's blocks
                # never arrived, so its hashes stay out of the book. A
                # stale book only costs a re-ship that dedups on
                # arrival; correctness never depends on it
                book = self._shipped.setdefault(req.decode_rank, set())
                if len(book) > _SHIPPED_CAP:
                    book.clear()
                book.update(payload.get("hashes") or ())
            xsp = req.xfer_span
            if xsp is not None:
                req.xfer_span = None
                xsp.end(ok=not payload.get("dropped"),
                        xfer_blocks=len(shipped), xfer_bytes=nbytes,
                        dedup_blocks=dedup)
            sp = req.dispatch_span
            if sp is not None:
                req.dispatch_span = None
                sp.end(ok=True)
            req.stage = None
            req.xfer = payload
            req.replica = None
            self._pending.appendleft(req)
            return
        if kind not in (MSG_RSP, MSG_ERR):
            return
        rid = msg.get("rid")
        req = self._inflight.get(rid)
        if req is None:
            # late duplicate (the replay path makes these legitimate):
            # dedupe by rid, and CHECK the payload against the first
            # completion — greedy decode is deterministic, so a
            # mismatch is a real invariant break, counted and gated
            if rid in self._done:
                self.duplicate_replies += 1
                if kind == MSG_RSP:
                    digest = self._digest(msg.get("result"))
                    first = self._done[rid]
                    if first is not None and digest != first:
                        self.output_mismatches += 1
                        Log.error("fleet: duplicate reply for %s from "
                                  "replica %d DIFFERS from the first "
                                  "completion (determinism break)",
                                  rid, node)
            return
        # the reply may come from a previous assignee (re-dispatch
        # raced a slow-but-alive replica): accept it — the output is
        # deterministic — and release both assignments
        for holder in self._replicas.values():
            holder.inflight.discard(rid)
        del self._inflight[rid]
        if kind == MSG_ERR:
            if (msg.get("kind") == "overloaded"
                    and msg.get("retriable", True)):
                self._requeue_locked(req, f"replica {node} shed",
                                     resolutions)
            elif msg.get("kind") == "overloaded":
                # a PERMANENT shed (request bigger than the replica's
                # whole KV pool): retrying cannot change the verdict —
                # fail now instead of burning the retry budget on an
                # impossibility (the retriable hint, not string-
                # matching `what`)
                self.failed += 1
                self._finish_done_locked(rid, None)
                resolutions.append((req, OverloadedError(
                    self.name, int(msg.get("depth", -1)),
                    int(msg.get("cap", -1)),
                    what=msg.get("what", "replica"), retriable=False)))
            elif msg.get("what") == "DeadlineExceededError":
                # the replica engine dropped it at queue-pop time: the
                # caller sees the same typed error the router's own
                # deadline sweep raises
                self.deadline_failures += 1
                self.failed += 1
                self._finish_done_locked(rid, None)
                resolutions.append((req, DeadlineExceededError(
                    f"fleet request {rid} missed its deadline on "
                    f"replica {node}: {msg.get('msg')}")))
            else:
                self.failed += 1
                self._finish_done_locked(rid, None)
                resolutions.append((req, RuntimeError(
                    f"fleet request {rid} failed on replica {node}: "
                    f"{msg.get('what')}: {msg.get('msg')}")))
            return
        reply = {
            "result": np.asarray(msg.get("result"), np.int32),
            "snapshot_version": msg.get("snapshot_version"),
            "staleness_s": msg.get("staleness_s", 0.0),
            "replica": node,
        }
        self.completed += 1
        if req.redispatched:
            self._last_recovery = now
        self._finish_done_locked(rid, self._digest(msg.get("result")))
        resolutions.append((req, reply))

    @staticmethod
    def _digest(result) -> int:
        return hash(tuple(result or ()))

    def _finish_done_locked(self, rid: str, digest: Optional[int]) -> None:
        self._done[rid] = digest
        while len(self._done) > self._done_cap:
            self._done.popitem(last=False)

    # -- liveness ------------------------------------------------------------
    def _set_state_locked(self, rep: _Replica, state: int) -> None:
        rep.state = state
        rep.state_gauge.set(state)

    def _mark_dead_locked(self, rep: _Replica, why: str,
                          resolutions) -> None:
        """One death transition: flag, drain the in-flight set into the
        retry queue (bounded re-dispatch), drop affinity pins."""
        self._set_state_locked(rep, DEAD)
        rep.deaths += 1
        self._last_death = time.monotonic()
        drained = [self._inflight[rid] for rid in sorted(rep.inflight)
                   if rid in self._inflight]
        rep.inflight.clear()
        for session, r in list(self._affinity.items()):
            if r == rep.rank:
                del self._affinity[session]
        # a dead decode rank's KV pool is gone with it: forget what we
        # shipped there (its heartbeat advertisements rebuild the book)
        self._shipped.pop(rep.rank, None)
        Log.error("fleet: replica %d DEAD (%s); re-dispatching %d "
                  "in-flight request(s)", rep.rank, why, len(drained))
        for req in drained:
            req.redispatched = True
            self._redispatch_counter.inc()
            self._requeue_locked(req, why, resolutions)

    def _requeue_locked(self, req: _FleetRequest, why: str,
                        resolutions) -> None:
        """Push one in-flight request back through the bounded
        retry/backoff path (or fail it once the budget is spent)."""
        sp = req.dispatch_span
        if sp is not None:
            sp.end(error=why)
            req.dispatch_span = None
        xsp = req.xfer_span
        if xsp is not None:
            xsp.end(error=why)
            req.xfer_span = None
        self._inflight.pop(req.rid, None)
        req.exclude = req.replica        # prefer a DIFFERENT survivor
        req.replica = None
        # a failed stage-1 re-decides its route at redispatch time: the
        # surviving fleet may have no prefill rank left, in which case
        # the request falls back to unified admission (any role's
        # engine handles a plain request). A carried stage-2 payload
        # (req.xfer) survives — the blocks are still good
        req.stage = None
        if req.attempts > self.config.retry_max:
            self.failed += 1
            self._finish_done_locked(req.rid, None)
            resolutions.append((req, FleetError(
                f"fleet request {req.rid} exhausted "
                f"{self.config.retry_max} re-dispatch attempt(s): {why}")))
            return
        delay = retry_backoff_s(req.attempts,
                                self.config.backoff_ms / 1000.0,
                                self.config.backoff_cap_ms / 1000.0,
                                self._rng)
        now = time.monotonic()
        if now + delay >= req.deadline:
            # the retry queue respects deadlines: a backoff that lands
            # past the deadline is a wait for an answer nobody will
            # read — fail fast instead of burning it
            self.deadline_failures += 1
            self.failed += 1
            self._finish_done_locked(req.rid, None)
            resolutions.append((req, DeadlineExceededError(
                f"fleet request {req.rid} cannot retry within its "
                f"deadline (backoff {delay:.3f}s, "
                f"{max(0.0, req.deadline - now):.3f}s left): {why}")))
            return
        self._retries_counter.inc()
        self._retry.append((now + delay, req))

    def _check_liveness_locked(self, now: float, resolutions,
                               sends) -> None:
        for rep in self._replicas.values():
            age = None if rep.last_hb is None else now - rep.last_hb
            if rep.state == UP:
                if age is not None and age > self.config.dead_after_s:
                    self._mark_dead_locked(
                        rep, f"heartbeat age {age:.3f}s", resolutions)
            elif rep.state == PROBING:
                if age is not None and age > self.config.dead_after_s:
                    # went silent again mid-probe: back to DEAD (no
                    # in-flight to drain — PROBING never dispatches)
                    rep.probe_rid = None
                    self._mark_dead_locked(
                        rep, f"silent during probe ({age:.3f}s)",
                        resolutions)
            elif rep.state == DEAD and not rep.wire_dead:
                if age is not None and age <= self.config.dead_after_s:
                    # heartbeats resumed: half-open — ONE probe must
                    # round-trip before any real request lands here
                    self._probe_n += 1
                    rep.probe_rid = f"probe-{rep.rank}-{self._probe_n}"
                    self._set_state_locked(rep, PROBING)
                    Log.info("fleet: replica %d heartbeating again; "
                             "probing (%s)", rep.rank, rep.probe_rid)
                    sends.append({"t": MSG_PING, "target": rep.rank,
                                  "rid": rep.probe_rid})

    # -- retries / deadlines -------------------------------------------------
    def _run_retries_locked(self, now: float) -> None:
        due = [req for t, req in self._retry if t <= now]
        if due:
            self._retry = [(t, req) for t, req in self._retry if t > now]
            # retries go to the FRONT of their class: they are the
            # oldest requests that class has
            for req in reversed(due):
                self._pending.appendleft(req)

    def _check_deadlines_locked(self, now: float, resolutions) -> None:
        def expire(req: _FleetRequest) -> None:
            self.deadline_failures += 1
            self.failed += 1
            sp = req.dispatch_span
            if sp is not None:
                sp.end(error="deadline")
                req.dispatch_span = None
            xsp = req.xfer_span
            if xsp is not None:
                xsp.end(error="deadline")
                req.xfer_span = None
            self._finish_done_locked(req.rid, None)
            resolutions.append((req, DeadlineExceededError(
                f"fleet request {req.rid} missed its deadline "
                f"({(now - req.t_enq):.3f}s since submit)")))

        expired = self._pending.expire(now)
        for t, req in list(self._retry):
            if req.deadline <= now:
                expired.append(req)
        self._retry = [(t, r) for t, r in self._retry
                       if r.deadline > now]
        for rid, req in list(self._inflight.items()):
            if req.deadline <= now:
                del self._inflight[rid]
                for rep in self._replicas.values():
                    rep.inflight.discard(rid)
                expired.append(req)
        for req in expired:
            expire(req)

    # -- dispatch ------------------------------------------------------------
    def _pick_locked(self, req: _FleetRequest,
                     pool: Optional[List[_Replica]] = None
                     ) -> Optional[_Replica]:
        up = (pool if pool is not None else
              [rep for rep in self._replicas.values()
               if rep.state == UP])
        if not up:
            return None
        # a retried request prefers a DIFFERENT replica than the one
        # that just died/shed it (when any other is up) — re-dispatch
        # exists to escape the failure, not to re-queue behind it
        if req.exclude is not None and len(up) > 1:
            up = [rep for rep in up if rep.rank != req.exclude] or up
        if req.session:
            pin = self._affinity.get(req.session)
            if pin is not None and pin != req.exclude:
                rep = self._replicas.get(pin)
                if rep is not None and rep.state == UP \
                        and (pool is None or rep in up):
                    return rep
        def load(rep: _Replica) -> Tuple[int, int]:
            return (len(rep.inflight)
                    + int((rep.health or {}).get("queue_depth", 0)),
                    rep.rank)
        return min(up, key=load)

    def _role_pools_locked(self) -> Tuple[List[_Replica], List[_Replica]]:
        prefills = [rep for rep in self._replicas.values()
                    if rep.state == UP and rep.role == "prefill"]
        decodes = [rep for rep in self._replicas.values()
                   if rep.state == UP and rep.role == "decode"]
        return prefills, decodes

    def _dispatch_locked(self, now: float, sends) -> None:
        while self._pending:
            req = self._pending.peek()
            # two-stage route decision, re-made at EVERY dispatch (the
            # role pools may have changed since the last attempt):
            #   stage 1 — both role pools populated and no payload yet:
            #     prefill rank computes the KV, decode rank is chosen
            #     NOW so its cached chains can be advertised upstream;
            #   stage 2 — payload in tow: land on the chosen decode
            #     rank (or any survivor — the payload degrades to a
            #     local re-prefill if its blocks cannot splice);
            #   otherwise — classic unified admission (fallback when a
            #   role pool is empty: every role serves plain requests).
            prefills, decodes = self._role_pools_locked()
            stage1 = False
            extra: Dict[str, Any] = {}
            if req.xfer is not None:
                rep = None
                if req.decode_rank is not None:
                    cand = self._replicas.get(req.decode_rank)
                    if cand is not None and cand.state == UP:
                        rep = cand
                if rep is None:
                    rep = self._pick_locked(req, decodes or None)
                extra["xfer"] = req.xfer
            elif prefills and decodes:
                dec = self._pick_locked(req, decodes)
                rep = self._pick_locked(req, prefills)
                if dec is not None and rep is not None:
                    stage1 = True
                    req.stage = "prefill"
                    req.decode_rank = dec.rank
                    # the decode side's known chains (our shipping book
                    # + its own heartbeat advertisement): a warm prefix
                    # never crosses the wire
                    known = set(self._shipped.get(dec.rank, ()))
                    known.update(
                        (dec.health or {}).get("cached_chains") or ())
                    extra["stage"] = "prefill"
                    extra["known"] = sorted(known)
                else:
                    rep = self._pick_locked(req)
            else:
                rep = self._pick_locked(req)
            if rep is None:
                return                   # nobody UP: requests wait
            self._pending.popleft()
            req.attempts += 1
            req.replica = rep.rank
            rep.inflight.add(req.rid)
            self._inflight[req.rid] = req
            if req.session:
                # affinity pins the rank that HOLDS the KV — the
                # decode side of a disaggregated route
                self._affinity[req.session] = (req.decode_rank
                                               if stage1 else rep.rank)
            self._dispatch_counter.inc()
            sp = trace.start_span(
                "route.dispatch",
                parent=req.root.context if req.root is not trace.NULL_SPAN
                else None,
                replica=rep.rank, rid=req.rid, attempt=req.attempts)
            req.dispatch_span = sp
            if stage1 and req.xfer_span is None:
                # the kv.transfer span brackets the whole stage-1 →
                # payload round trip; closed at MSG_XFER (or error'd by
                # the requeue/deadline paths)
                req.xfer_span = trace.start_span(
                    "kv.transfer",
                    parent=req.root.context
                    if req.root is not trace.NULL_SPAN else None,
                    rid=req.rid, prefill_replica=rep.rank,
                    decode_replica=req.decode_rank)
            wire_ctx = None
            if sp is not trace.NULL_SPAN:
                wire_ctx = [sp.trace_id, sp.span_id]
            sends.append({
                "t": MSG_REQ, "target": rep.rank, "rid": req.rid,
                "session": req.session, "prompt": req.prompt.tolist(),
                "max_new": req.max_new, "trace": wire_ctx,
                # priority + REMAINING deadline budget ride the wire
                # (remaining, not absolute: the replica's monotonic
                # clock is not ours) so the replica engine's scheduler
                # sees the same class and the same urgency
                "prio": req.priority,
                "deadline_ms": max(0.0, (req.deadline - now) * 1e3),
                # tenant rides only when set: absent keys decode as
                # the replica's -default_tenant, so pre-ledger
                # replicas (and archived payloads) stay valid
                **({"tenant": req.tenant} if req.tenant else {}),
                **extra})

    # -- outbound ------------------------------------------------------------
    def _publish(self, msg: Dict[str, Any]) -> None:
        payload = encode_msg(msg)
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
        self._transport.send(seq, payload)

    def _publish_head(self) -> None:
        # only when the head MOVED: an idle router must not rewrite an
        # identical value into the coordination service every tick
        if self._seq == self._head_published:
            return
        try:
            self._client.key_value_set(f"{self._label}/head",
                                       str(self._seq),
                                       allow_overwrite=True)
            self._head_published = self._seq
        except Exception:               # pragma: no cover - kv trouble
            pass

    def _ack_and_release(self) -> None:
        """Ack every replica stream we consumed, advance the request
        stream's release frontier to the min ack over serviceable
        replicas (DEAD ranks are excluded — a permanently silent
        replica must not pin the retained window; its successor
        resumes from the published head, not from its ack), and
        re-publish the head for restart bootstraps. The ack READS run
        at heartbeat cadence, not tick cadence: release latency is not
        liveness, and a KV client whose only read is a blocking get
        (the ``_read_ack`` fallback) must never stall the routing
        thread once per replica per tick — that path flagged healthy
        replicas DEAD at boot."""
        for r, rep in self._replicas.items():
            if self._expect[r] > self._acked[r]:
                try:
                    self._client.key_value_set(
                        f"{self._label}/rack/{r}", str(self._expect[r]),
                        allow_overwrite=True)
                    self._acked[r] = self._expect[r]
                except Exception:       # pragma: no cover - kv trouble
                    pass
        now = time.monotonic()
        if now < self._next_ack_poll or self._released >= self._seq:
            self._publish_head()
            return
        self._next_ack_poll = now + self.config.heartbeat_ms / 1000.0
        live_acks = []
        for r, rep in self._replicas.items():
            if rep.state == DEAD or rep.last_hb is None:
                # DEAD ranks and never-connected CONNECTING ranks (a
                # replica that crashed at boot) must not pin the
                # frontier at 0 forever — their (re)incarnations resume
                # from the published head, not from their ack, so
                # releasing past them is in contract
                continue
            live_acks.append(self._read_ack(r))
        if live_acks:
            frontier = min(live_acks)
            while self._released < frontier:
                self._transport.release(self._released)
                self._released += 1
        self._publish_head()

    def _read_ack(self, r: int) -> int:
        key = f"{self._label}/ack/{r}"
        try:
            if hasattr(self._client, "key_value_try_get"):
                return int(str(self._client.key_value_try_get(key)))
            return int(str(self._client.blocking_key_value_get(key, 100)))
        except Exception:
            return 0

    def _apply_resolutions(self, resolutions) -> None:
        """Fire future results/exceptions OUTSIDE every router lock —
        done-callbacks are user code."""
        for req, outcome in resolutions:
            sp = req.dispatch_span
            if sp is not None:
                req.dispatch_span = None
                sp.end(ok=not isinstance(outcome, Exception))
            xsp = req.xfer_span
            if xsp is not None:
                req.xfer_span = None
                xsp.end(ok=not isinstance(outcome, Exception))
            if not req.future.set_running_or_notify_cancel():
                continue
            if isinstance(outcome, Exception):
                req.future.set_exception(outcome)
            else:
                req.future.set_result(outcome)

    # -- introspection -------------------------------------------------------
    def replica_rows(self) -> List[Dict[str, Any]]:
        now = time.monotonic()
        with self._lock:
            return [{
                "rank": rep.rank,
                "state": STATE_NAMES[rep.state],
                "role": rep.role,
                "inflight": len(rep.inflight),
                "hb_age_ms": (None if rep.last_hb is None
                              else round((now - rep.last_hb) * 1e3, 1)),
                "deaths": rep.deaths,
                "readmissions": rep.readmissions,
                "queue_depth": (rep.health or {}).get("queue_depth", 0),
                "snapshot_version": (rep.health or {}).get(
                    "snapshot_version", -1),
                "params_stale": bool((rep.health or {}).get(
                    "params_stale", False)),
                "preemptions": (rep.health or {}).get("preemptions", -1),
                # the replica engine's cost ledger, top tenants by cost
                # (empty when its ledger is off)
                "tenants": dict((rep.health or {}).get("tenants") or {}),
            } for rep in sorted(self._replicas.values(),
                                key=lambda x: x.rank)]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            pending = len(self._pending)
            retrying = len(self._retry)
            inflight = len(self._inflight)
            recovery = None
            if self._last_death is not None \
                    and self._last_recovery is not None \
                    and self._last_recovery >= self._last_death:
                recovery = self._last_recovery - self._last_death
            return {
                "replicas": len(self._replicas),
                "up": sum(1 for rep in self._replicas.values()
                          if rep.state == UP),
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "shed": self.shed,
                "shed_by_class": {f"p{p}": n for p, n in
                                  sorted(self.shed_by_class.items())},
                "deadline_failures": self.deadline_failures,
                "pending": pending,
                "retrying": retrying,
                "inflight": inflight,
                "requests_lost": (self.submitted - self.completed
                                  - self.failed - pending - retrying
                                  - inflight),
                "duplicate_replies": self.duplicate_replies,
                "output_mismatches": self.output_mismatches,
                "kv_xfers": self.kv_xfers,
                "kv_bytes_moved": self.kv_bytes_moved,
                "xfer_blocks": self.xfer_blocks,
                "xfer_dedup_blocks": self.xfer_dedup_blocks,
                "xfer_dedup_hit_rate": (
                    self.xfer_dedup_blocks
                    / (self.xfer_blocks + self.xfer_dedup_blocks)
                    if (self.xfer_blocks + self.xfer_dedup_blocks)
                    else 0.0),
                "deaths": sum(rep.deaths
                              for rep in self._replicas.values()),
                "readmissions": sum(rep.readmissions
                                    for rep in self._replicas.values()),
                "recovery_time_s": recovery,
            }

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Block until every accepted request resolved (or timeout):
        the bench/test barrier between "trace submitted" and "verdict
        read"."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not (self._pending or self._retry or self._inflight):
                    return True
            time.sleep(0.005)
        return False

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        resolutions: List[Tuple[_FleetRequest, Any]] = []
        with self._lock:
            leftovers = (self._pending.drain()
                         + [r for _, r in self._retry]
                         + list(self._inflight.values()))
            self._retry = []
            self._inflight.clear()
        for req in leftovers:
            resolutions.append((req, RuntimeError(
                f"fleet router {self.name!r} stopped with request "
                f"{req.rid} unresolved")))
        self._apply_resolutions(resolutions)
        self._transport.stop()
