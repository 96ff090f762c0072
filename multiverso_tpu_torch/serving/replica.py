"""Decode-engine replica: one fleet member's request/response stream.

Counterpart of ``multiverso_tpu/serving/replica.py``: the same
``mvserve`` messages (:func:`encode_msg` writes the same JSON bytes), so
a JAX router drives port replicas and a port router drives JAX ones.

One :class:`ReplicaServer` wraps one decode engine (any object with the
``submit(prompt, max_new, ctx) -> Future`` / ``health()`` / ``stats()``
/ ``stop()`` surface — a :class:`~.decode_engine.DecodeEngine` in
production, a deterministic fake in the router unit tests) and exposes
it to the :class:`~.router.FleetRouter` over the existing
:class:`~..parallel.p2p.P2PTransport` wire under the
label ``mvserve``. Topology is the obs plane's hub, inverted twice:

* the ROUTER (rank 0) is the only publisher of requests — every replica
  subscribes to its stream and executes the records targeted at it
  (``target`` field; the per-publisher stream is a replay log, so
  non-targets are skipped, not an error);
* every REPLICA publishes its own response stream — the router is its
  only subscriber. Responses, errors and heartbeats ride it in
  publish order.

Liveness is *observed, not assumed*: a heartbeat thread publishes
``engine.health()`` every ``-fleet_heartbeat_ms`` — the router's DEAD
verdict is heartbeat-age over the wire, never a local guess. Requests
carry idempotent ids; a replica replays whatever the stream hands it
and the router dedupes by rid, which is what makes the resume/replay
path after a death boring instead of subtle.

Restart contract (the half-open readmission path): a restarted replica
process re-advertises its endpoint (the KV outlives it), resumes its
SUBSCRIPTION from the router's published stream head
(``{label}/head``) — requests before the head were already drained and
re-dispatched when the router flagged the death, so replaying them
would be wasted work — and resumes its PUBLISH sequence from the
router's ack (``{label}/rack/<rank>``) so the router's in-order
consumer sees one contiguous stream across incarnations.

Fault injection (:mod:`.faultinject`) hooks exactly three places:
request dequeue (kill/wedge), outbound publish (delay), and the
heartbeat (drop/slow) — enough to stage every failure the router
claims to survive, few enough to audit.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from .. import config, trace
from ..log import Log
from .batcher import OverloadedError
from .faultinject import FaultPlan

LABEL = "mvserve"
ROUTER_RANK = 0

#: wire message kinds (one JSON object per transport record)
MSG_REQ = "req"        # router -> replica: execute a prompt
MSG_PING = "ping"      # router -> replica: half-open readmission probe
MSG_RSP = "rsp"        # replica -> router: completed generation
MSG_ERR = "err"        # replica -> router: shed / engine failure
MSG_PONG = "pong"      # replica -> router: probe answer
MSG_HB = "hb"          # replica -> router: engine.health() heartbeat
MSG_XFER = "xfer"      # replica -> router: prefilled KV-block payload
                       # (disaggregated stage 1 -> the router carries it
                       # to the chosen decode replica in stage 2)

#: replica roles (disaggregated serving). "unified" is the back-compat
#: default: the replica both prefills and decodes, exactly the pre-PR
#: fleet. A "prefill" replica only serves stage-1 prefill-only
#: admissions; a "decode" replica serves stage-2 (splice + generate) —
#: and either still handles a plain unified request, which is what
#: makes the router's no-prefill-UP fallback safe.
ROLES = ("unified", "prefill", "decode")


def encode_msg(msg: Dict[str, Any]) -> bytes:
    return json.dumps(msg, default=str).encode()


def decode_msg(payload: bytes) -> Dict[str, Any]:
    return json.loads(bytes(payload).decode())


class ReplicaServer:
    """One decode replica on the ``mvserve`` wire (ranks 1..N; rank 0
    is the router). ``engine`` must already be constructed/warm —
    building it is the caller's business (``serve_replica`` below is
    the flag-wired standalone entry the subprocess tests use)."""

    def __init__(self, rank: int, size: int, client: Any, engine: Any,
                 label: str = LABEL, heartbeat_ms: Optional[int] = None,
                 chaos: Optional[FaultPlan] = None,
                 kill_fn: Optional[Callable[[], None]] = None,
                 role: str = "unified") -> None:
        from ..parallel.p2p import P2PTransport

        if not 1 <= rank < size:
            raise ValueError(f"replica rank {rank} outside [1, {size})")
        if role not in ROLES:
            raise ValueError(f"replica role {role!r} not in {ROLES}")
        self.rank = int(rank)
        self.size = int(size)
        self.role = role
        self._client = client
        self._label = label
        self.engine = engine
        hb_ms = (int(config.get_flag("fleet_heartbeat_ms"))
                 if heartbeat_ms is None else int(heartbeat_ms))
        self._hb_interval = max(hb_ms, 5) / 1000.0
        self.chaos = chaos if chaos is not None else FaultPlan(
            "", kill_fn=kill_fn)
        if kill_fn is not None and chaos is not None:
            self.chaos._kill_fn = kill_fn
        # engine capability probe: the priority/deadline keywords only
        # ride when the engine's submit takes them (the router unit
        # tests' deterministic fakes keep the classic 3-arg surface)
        try:
            import inspect

            params = inspect.signature(engine.submit).parameters
            self._engine_prio = "priority" in params
            self._engine_xfer_kw = "xfer_info" in params
            self._engine_tenant = "tenant" in params
        except (TypeError, ValueError):   # builtins/partials: assume new
            self._engine_prio = True
            self._engine_xfer_kw = True
            self._engine_tenant = True
        # transfer-plane capability: an inbound payload only splices
        # when the engine can (the fakes keep the classic surface —
        # the payload is then ignored and the prompt prefills locally;
        # a stage-1 request against an engine without submit_prefill
        # errors through the normal MSG_ERR path)
        self._engine_splice = hasattr(engine, "splice")
        # publish seq resumes from the router's ack so the router's
        # in-order consumer sees ONE contiguous stream across replica
        # incarnations; subscription resumes from the router's stream
        # head — everything before it was drained + re-dispatched when
        # the router flagged our predecessor dead
        self._seq = self._read_kv_int(f"{label}/rack/{rank}", 0)
        self._released = self._seq
        head = self._read_kv_int(f"{label}/head", 0)
        self._transport = P2PTransport(
            self.rank, self.size, client, label=label,
            subscribe_to=[ROUTER_RANK],
            initial_resume={ROUTER_RANK: head})
        self._expect = head
        # ONE publisher thread owns seq allocation + the wire send:
        # the drain loop, the heartbeat thread and the engine's
        # completion callbacks all just enqueue here — no lock is ever
        # held across a send, and per-publisher wire
        # order is the outbox's FIFO order by construction
        self._out_cv = threading.Condition()
        self._outbox: "collections.deque" = collections.deque()
        self._stop = threading.Event()
        self.requests_seen = 0          # targeted reqs dequeued (chaos k)
        self.completed = 0
        self.failed = 0
        self.heartbeats = 0
        self.xfers_sent = 0             # stage-1 payloads published
        self.xfers_spliced = 0          # stage-2 payloads applied
        self._threads = [
            threading.Thread(target=self._drain_loop,
                             name=f"mvserve-replica-{rank}", daemon=True),
            threading.Thread(target=self._heartbeat_loop,
                             name=f"mvserve-hb-{rank}", daemon=True),
            threading.Thread(target=self._publish_loop,
                             name=f"mvserve-pub-{rank}", daemon=True),
        ]
        for t in self._threads:
            t.start()
        Log.info("fleet: replica %d/%d up (hb %.0f ms, resume seq %d, "
                 "head %d)", rank, size - 1, self._hb_interval * 1e3,
                 self._seq, head)

    # -- kv helpers ----------------------------------------------------------
    def _read_kv_int(self, key: str, default: int) -> int:
        try:
            if hasattr(self._client, "key_value_try_get"):
                return int(str(self._client.key_value_try_get(key)))
            return int(str(self._client.blocking_key_value_get(key, 200)))
        except Exception:
            return default

    # -- publish side --------------------------------------------------------
    def _publish(self, msg: Dict[str, Any]) -> None:
        with self._out_cv:
            self._outbox.append(msg)
            self._out_cv.notify()

    def _publish_loop(self) -> None:
        while True:
            with self._out_cv:
                while not self._outbox and not self._stop.is_set():
                    self._out_cv.wait(0.2)
                if self._stop.is_set():
                    return
                msg = self._outbox.popleft()
            # chaos wire delay stalls the publisher itself — every
            # record behind the delayed one waits too, which is what a
            # congested/flaky wire actually looks like
            delay = self.chaos.wire_delay_s()
            if delay > 0:
                time.sleep(delay)
            seq = self._seq
            self._seq = seq + 1
            self._transport.send(seq, encode_msg(msg))

    def _release_acked(self) -> None:
        """Drop retained records the router has consumed (its ack in
        the KV) — the obs plane's release frontier, replica-side."""
        ack = self._read_kv_int(f"{self._label}/rack/{self.rank}", 0)
        while self._released < ack:
            self._transport.release(self._released)
            self._released += 1

    # -- request side --------------------------------------------------------
    def _drain_loop(self) -> None:
        consumed = False
        while not self._stop.is_set():
            payload = self._transport.pop_ready(ROUTER_RANK, self._expect)
            if payload is None:
                if consumed:
                    # ack once per DRAINED BATCH, not per record: the
                    # ack only needs to be current when the router
                    # reads it (tick granularity), and a per-record
                    # key_value_set would be R synchronous KV writes
                    # per dispatched request against a real
                    # coordination service
                    self._write_ack()
                    consumed = False
                time.sleep(0.002)
                continue
            self._expect += 1
            consumed = True
            try:
                msg = decode_msg(payload)
            except ValueError:
                Log.error("fleet: replica %d got undecodable record "
                          "(seq %d)", self.rank, self._expect - 1)
                continue
            try:
                self._handle(msg)
            except Exception as exc:    # pragma: no cover - defensive
                Log.error("fleet: replica %d handler failed: %s",
                          self.rank, exc)

    def _write_ack(self) -> None:
        """Advance the router-visible consume frontier (also where a
        restarted successor resumes its publish seq from)."""
        try:
            self._client.key_value_set(
                f"{self._label}/ack/{self.rank}", str(self._expect),
                allow_overwrite=True)
        except Exception:               # pragma: no cover - kv trouble
            pass

    def _handle(self, msg: Dict[str, Any]) -> None:
        kind = msg.get("t")
        if msg.get("target") != self.rank:
            return                       # another replica's record
        if kind == MSG_PING:
            self._publish({"t": MSG_PONG, "node": self.rank,
                           "rid": msg.get("rid")})
            return
        if kind != MSG_REQ:
            return
        self.requests_seen += 1
        wedge_s = self.chaos.on_request(self.requests_seen)
        if self._stop.is_set():
            # an in-process kill_fn (replica.die) RETURNS instead of
            # os._exit'ing — honor the death here: the fatal request
            # must not still be submitted to the "dead" replica's
            # engine (it would burn slots concurrently with the
            # survivor's replay, which a real process death never does)
            return
        if wedge_s > 0:
            time.sleep(wedge_s)
        rid = msg["rid"]
        parent = None
        if msg.get("trace"):
            tid, sid = msg["trace"]
            parent = trace.SpanContext(int(tid), int(sid))
        sp = trace.start_span("replica.exec", parent=parent,
                              replica=self.rank, rid=rid)
        prompt = np.asarray(msg["prompt"], np.int32)
        # the router ships the REMAINING deadline budget (clocks are
        # per-process): re-anchor it on our monotonic clock so the
        # engine's pop-time check measures the same instant
        deadline_ms = msg.get("deadline_ms")
        deadline_s = (None if not deadline_ms
                      else float(deadline_ms) / 1e3)
        # chaos traffic faults staged at dequeue: a burst submits N
        # extra copies of this prompt straight into the local engine
        # (a one-replica traffic spike), a pool squeeze holds part of
        # the engine's KV pool hostage so preemption runs under real
        # pressure
        for _ in range(self.chaos.burst_n(self.requests_seen)):
            try:
                self.engine.submit(prompt, msg.get("max_new"))
            except Exception:            # sheds are part of the chaos
                pass
        squeeze = self.chaos.squeeze_frac(self.requests_seen)
        if squeeze is not None and hasattr(self.engine, "squeeze_pool"):
            self.engine.squeeze_pool(squeeze)
        if (self.chaos.squeeze_release(self.requests_seen)
                and hasattr(self.engine, "unsqueeze_pool")):
            self.engine.unsqueeze_pool()
        if msg.get("stage") == "prefill":
            # disaggregated stage 1: chunk-prefill the prompt into
            # paged blocks and reply with the transfer payload instead
            # of tokens ("known" = chain hashes the decode side already
            # holds — those ride as metadata, zero bytes)
            try:
                pkw = ({"tenant": msg.get("tenant")}
                       if self._engine_tenant else {})
                fut = self.engine.submit_prefill(
                    prompt, msg.get("known") or (),
                    ctx=sp.context if parent else None, **pkw)
            except Exception as exc:
                sp.end(error=type(exc).__name__)
                self.failed += 1
                err = {"t": MSG_ERR, "node": self.rank, "rid": rid,
                       "kind": "error", "what": type(exc).__name__,
                       "msg": str(exc)}
                if isinstance(exc, OverloadedError):
                    err.update(kind="overloaded", what=exc.what,
                               depth=exc.depth, cap=exc.cap,
                               retriable=exc.retriable)
                self._publish(err)
                return
            fut.add_done_callback(
                lambda f, rid=rid, sp=sp: self._reply_xfer(rid, f, sp))
            return
        xfer_info = None
        if msg.get("xfer") is not None and self._engine_splice:
            # disaggregated stage 2: splice the carried payload into
            # the local pool BEFORE submitting the prompt, so admission
            # sees the warm prefix (full hit -> CoW -> live at P-1).
            # splice degrades instead of raising — a bad/stale/dropped
            # payload just means the prompt re-prefills locally
            xfer_info = self.engine.splice(msg["xfer"])
            self.xfers_spliced += 1
        kw = {}
        if self._engine_prio:
            kw = {"priority": msg.get("prio"), "deadline_s": deadline_s}
        if xfer_info is not None and self._engine_xfer_kw:
            kw["xfer_info"] = xfer_info
        if self._engine_tenant:
            # absent on the wire (old router, archived payload) decodes
            # as None -> the engine ledger's -default_tenant
            kw["tenant"] = msg.get("tenant")
        try:
            fut = self.engine.submit(prompt, msg.get("max_new"),
                                     ctx=sp.context if parent else None,
                                     **kw)
        except OverloadedError as exc:
            sp.end(error="OverloadedError")
            self.failed += 1
            self._publish({"t": MSG_ERR, "node": self.rank, "rid": rid,
                           "kind": "overloaded", "what": exc.what,
                           "depth": exc.depth, "cap": exc.cap,
                           "retriable": exc.retriable,
                           "msg": str(exc)})
            return
        except Exception as exc:
            sp.end(error=type(exc).__name__)
            self.failed += 1
            self._publish({"t": MSG_ERR, "node": self.rank, "rid": rid,
                           "kind": "error", "what": type(exc).__name__,
                           "msg": str(exc)})
            return
        fut.add_done_callback(
            lambda f, rid=rid, sp=sp: self._reply(rid, f, sp))

    def _reply(self, rid: str, fut, sp) -> None:
        if self._stop.is_set():
            # died mid-generation: no reply — but the span still
            # closes (an unclosed span is an invariant break, and the
            # trace should SHOW the request dying on this replica)
            sp.end(error="died")
            return
        exc = fut.exception()
        if exc is not None:
            sp.end(error=type(exc).__name__)
            self.failed += 1
            err = {"t": MSG_ERR, "node": self.rank, "rid": rid,
                   "kind": "error", "what": type(exc).__name__,
                   "msg": str(exc)}
            if isinstance(exc, OverloadedError):
                err.update(kind="overloaded", what=exc.what,
                           depth=exc.depth, cap=exc.cap,
                           retriable=exc.retriable)
            self._publish(err)
            return
        reply = fut.result()
        sp.end(ok=True)
        self.completed += 1
        self._publish({
            "t": MSG_RSP, "node": self.rank, "rid": rid,
            "result": np.asarray(reply["result"], np.int32).tolist(),
            "snapshot_version": reply.get("snapshot_version"),
            "staleness_s": reply.get("staleness_s", 0.0)})

    def _reply_xfer(self, rid: str, fut, sp) -> None:
        """Stage-1 completion: publish the KV-block payload as a
        MSG_XFER record for the router to carry to the decode replica.
        The ``kv_xfer_drop`` chaos point fires here — the payload's
        K/V bytes are stripped mid-flight while the header + hash chain
        survive, so the loss is observable and the decode side
        re-prefills (latency, never tokens)."""
        if self._stop.is_set():
            sp.end(error="died")
            return
        exc = fut.exception()
        if exc is not None:
            sp.end(error=type(exc).__name__)
            self.failed += 1
            err = {"t": MSG_ERR, "node": self.rank, "rid": rid,
                   "kind": "error", "what": type(exc).__name__,
                   "msg": str(exc)}
            if isinstance(exc, OverloadedError):
                err.update(kind="overloaded", what=exc.what,
                           depth=exc.depth, cap=exc.cap,
                           retriable=exc.retriable)
            self._publish(err)
            return
        reply = fut.result()
        payload = reply["xfer"]
        self.xfers_sent += 1
        if self.chaos.drop_kv_xfer(self.xfers_sent):
            from . import kv_transfer

            payload = kv_transfer.drop_blocks(payload)
        sp.end(ok=True)
        self.completed += 1
        self._publish({
            "t": MSG_XFER, "node": self.rank, "rid": rid,
            "payload": payload,
            "snapshot_version": reply.get("snapshot_version"),
            "staleness_s": reply.get("staleness_s", 0.0)})

    # -- heartbeat side ------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        # heartbeat_scale is read PER BEAT, not folded in at init: the
        # bench/test idiom assigns replica.chaos after construction,
        # and a slow_heartbeat plan assigned that way must actually
        # slow the beats (not pass vacuously)
        while not self._stop.wait(self._hb_interval
                                  * self.chaos.heartbeat_scale):
            if self.chaos.drop_heartbeat():
                continue
            try:
                health = self.engine.health()
            except Exception as exc:    # pragma: no cover - defensive
                health = {"error": str(exc)}
            self.heartbeats += 1
            self._publish({"t": MSG_HB, "node": self.rank,
                           "n": self.heartbeats, "mono": time.monotonic(),
                           "role": self.role, "health": health})
            self._release_acked()

    # -- lifecycle -----------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        return {
            "rank": self.rank,
            "role": self.role,
            "requests_seen": self.requests_seen,
            "completed": self.completed,
            "failed": self.failed,
            "heartbeats": self.heartbeats,
            "xfers_sent": self.xfers_sent,
            "xfers_spliced": self.xfers_spliced,
            "chaos": self.chaos.stats(),
        }

    def die(self) -> None:
        """In-process analogue of ``kill_at_request``'s ``os._exit``:
        stop heartbeating and replying IMMEDIATELY and drop the wire
        mid-stream — no drain, no goodbye. The engine object survives
        (the test/bench owns its cleanup); the fleet just sees this
        replica go dark. ``FaultPlan(kill_fn=replica.die)`` wires it."""
        self._stop.set()
        with self._out_cv:
            self._outbox.clear()         # unreplied, like a real crash
            self._out_cv.notify_all()
        self._transport.stop()

    def stop(self, stop_engine: bool = True) -> None:
        """Graceful shutdown (clean exit path): stop accepting, let the
        wire drain briefly, then close. ``stop_engine=False`` leaves
        the (expensive, warm) engine alive for the next incarnation —
        the bench's A/B legs re-wrap the same engines."""
        # let the publisher flush queued replies before it is told off
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._out_cv:
                if not self._outbox:
                    break
            time.sleep(0.01)
        self._stop.set()
        with self._out_cv:
            self._out_cv.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._transport.stop()
        if stop_engine:
            stop = getattr(self.engine, "stop", None)
            if stop is not None:
                stop()


def serve_replica(rank: int, size: int, client: Any, lm,
                  label: str = LABEL, engine_kw: Optional[dict] = None,
                  warm: bool = True, role: str = "unified"
                  ) -> ReplicaServer:
    """Standalone replica bootstrap: build a warm
    :class:`~.decode_engine.DecodeEngine` over ``lm`` and put it on the
    wire, with the ``-chaos`` flag plan armed. ``role`` specializes the
    replica for a disaggregated fleet (``prefill``/``decode``;
    ``unified`` is the symmetric default). The subprocess acceptance
    test and any real deployment entry call this after ``mv.init()``
    (Session bootstrap: flags, topology, tables)."""
    from .decode_engine import DecodeEngine, DecodeEngineConfig

    engine = DecodeEngine(f"replica{rank}", lm,
                          DecodeEngineConfig(**(engine_kw or {})))
    if warm:
        engine.warmup()
    return ReplicaServer(rank, size, client, engine, label=label,
                         chaos=FaultPlan.from_flags(), role=role)
