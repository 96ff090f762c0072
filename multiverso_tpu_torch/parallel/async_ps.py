"""The async parameter-server plane: the record framing, the epoch fence
and the delta bus.

Counterpart of ``multiverso_tpu/parallel/async_ps.py``. The reference's
default mode: workers push deltas whenever they like and the server
shards apply them in arrival order (``src/server.cpp:36-60``). Every
process holds the whole table replica; in async mode (neither ``-sync``
nor ``-ma``) a group of processes runs one :class:`AsyncDeltaBus` each:

* every local add applies to the local replica at once and is
  **published**: a record (``_HEADER`` then ``MVTA`` arrays,
  ``io/stream.write_array``, byte-compatible with the JAX package's) under
  the next sequence number of this publisher;
* a drain thread polls the peers' publication counters in the group's
  coordination KV (``topology.StoreKV``) and applies their records to the
  local replica in arrival order, through the tables' remote entry points
  (``_apply_remote_dense``/``_keyed``/``_kv``, the STATE install), under
  each table's lock and on the session's device (the row scatter-add
  kernel for keyed records on the card).

Contract (JAX :24-37): each delta is applied exactly once on every
process; a process sees its own adds at once and its peers' within a
poll interval plus the wire; :meth:`AsyncDeltaBus.drain` (a collective,
which ``barrier()`` runs) returns once every delta published anywhere
before it is applied everywhere, so with a commutative updater every
replica holds the sum over workers.

Payloads ride the p2p sockets (``parallel.p2p.P2PTransport``,
``-async_p2p``, the default) or the KV itself. All ranks vote on the
plane; if one lacks p2p the whole group falls back to KV payloads, and a
rank whose vote never arrives is fatal. KV payloads above
``-async_max_record_kb`` split into PART records at consecutive sequence
numbers, reassembled before the one apply. Consumers ack each record on
an atomic counter; the publisher deletes a record (payload and ack key:
the store has no directory delete) once ``size - 1`` live peers acked it,
and blocks while its un-acked bytes exceed ``-async_max_inflight_mb``
(backpressure, counted in ``stats()["backpressure_waits"]``).

Survivor mode (``-failure_timeout_s`` > 0): ``mark_dead`` drops a rank
from the ack quorum, the drain targets and the p2p fan-out, and publishes
the declaration in the KV; ``drain`` rendezvouses the live set through
single-use KV barriers that retry until the survivors agree on it.

Dashboard monitors ``ASYNC_BUS[PUBLISH]``, ``[APPLY]`` and ``[LATENCY]``
(publish to apply, from each record's send timestamp); ``stats()``
reports bytes and MB/s both ways. The publication and consumption
counters are module-level, one bus per process at a time, and restart
with each new process group.
"""

from __future__ import annotations

import collections
import io
import struct
import threading
import time
from typing import Any, Deque, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config, trace
from ..log import Log
from ..quantization import SparseFilter, cast_host, wire_dtype

# record kinds (STATE carries the absolute table value: the fenced
# restart's rebase record, installed, not folded)
DENSE, KEYED, KV, PART, STATE = 0, 1, 2, 3, 4

_HEADER = struct.Struct("<BBiiffffdQQIQ")  # kind, n_arrays, table_id,
#                          worker_id, lr, momentum, rho, lam, send_ts,
#                          trace_id, span_id (0, 0 = untraced publish),
#                          epoch (u32; trainer incarnation, 0 =
#                          unfenced), version (u64; the publisher's
#                          post-apply table version, 0 = unknown)
_PART_HEADER = struct.Struct("<BII")   # kind=PART, part_index, n_parts

# Publication and consumption counters of this process's bus. A bus
# restarted within one group (a new session) continues them, as the KV it
# reads outlives the session; a new group restarts them with its store.
_published = 0
_consumed: dict = {}
_drain_round = 0
_counters_group: Any = None     # the group the counters above count in
_state_lock = threading.Lock()
# the counters are process-wide: one live bus per process
_active_bus: Optional["AsyncDeltaBus"] = None


def _serialize(kind: int, table_id: int, option, arrays: Sequence,
               ctx: Optional[trace.SpanContext] = None, epoch: int = 0,
               version: int = 0) -> bytes:
    """One record: the header (``send_ts`` = ``time.time()``) and the
    arrays (numpy, or torch bf16 tensors) as ``MVTA`` records."""
    from ..io.stream import write_array

    tid, sid = (ctx.trace_id, ctx.span_id) if ctx is not None else (0, 0)
    buf = io.BytesIO()
    buf.write(_HEADER.pack(kind, len(arrays), table_id,
                           int(getattr(option, "worker_id", 0)),
                           float(getattr(option, "learning_rate", 0.0)),
                           float(getattr(option, "momentum", 0.0)),
                           float(getattr(option, "rho", 0.0)),
                           float(getattr(option, "lam", 0.0)),
                           time.time(), tid, sid, int(epoch),
                           int(version)))
    for arr in arrays:
        write_array(buf, arr)
    return buf.getvalue()


def _deserialize(data: bytes):
    """``(kind, table_id, option, arrays, send_ts, ctx, epoch,
    version)``; a ``bfloat16`` array comes back as a torch CPU tensor."""
    from ..io.stream import read_array
    from ..updaters import AddOption

    buf = io.BytesIO(data)
    (kind, n_arrays, table_id, wid, lr, mom, rho, lam, ts, trace_id,
     span_id, epoch, version) = _HEADER.unpack(buf.read(_HEADER.size))
    arrays = [read_array(buf) for _ in range(n_arrays)]
    option = AddOption(worker_id=wid, learning_rate=lr, momentum=mom,
                       rho=rho, lam=lam)
    ctx = trace.SpanContext(trace_id, span_id) if trace_id else None
    return kind, table_id, option, arrays, ts, ctx, epoch, version


def _kv_get_int(client, key: str, default: int = 0) -> int:
    """Best-effort int read from the coordination KV: ``key_value_try_get``
    where the client has it, else a short blocking get."""
    try:
        if hasattr(client, "key_value_try_get"):
            return int(str(client.key_value_try_get(key)))
        return int(str(client.blocking_key_value_get(key, 200)))
    except Exception:
        return default


def claim_epoch(client, key: str = "mvps/epoch") -> int:
    """Claim the next trainer incarnation epoch in the coordination KV.

    The monotonic fencing token of the restart contract: every publish of
    the claiming incarnation carries it, and appliers reject records of a
    lower epoch than the highest seen. A transport error on the read is
    fatal (defaulting to 0 would rewind the key and fence out the
    restarted trainer); only an absent key reads as 0."""
    if hasattr(client, "key_value_try_get"):
        try:
            cur = int(str(client.key_value_try_get(key)))
        except Exception as exc:
            if "NOT_FOUND" not in str(exc) \
                    and not isinstance(exc, KeyError):
                Log.fatal(f"claim_epoch: cannot read fence key {key!r} "
                          f"({exc}) — claiming blindly could regress "
                          f"the epoch and fence out this trainer")
            cur = 0
    else:
        # a client without try-get: a short blocking get whose timeout
        # means "absent" (the first claim)
        try:
            cur = int(str(client.blocking_key_value_get(key, 2_000)))
        except Exception as exc:
            msg = str(exc)
            if (isinstance(exc, TimeoutError) or "DEADLINE" in msg
                    or "NOT_FOUND" in msg):
                cur = 0
            else:
                Log.fatal(f"claim_epoch: cannot read fence key {key!r} "
                          f"({exc}) — claiming blindly could regress "
                          f"the epoch and fence out this trainer")
    nxt = cur + 1
    client.key_value_set(key, str(nxt), allow_overwrite=True)
    return nxt


class EpochFence:
    """Highest-epoch-wins admission check for fenced publishes.

    ``admit(epoch)`` returns False for a record of a lower incarnation
    than the highest seen (and counts it); epoch 0 (unfenced) always
    passes and never advances the fence. Callers are single applier
    threads."""

    def __init__(self, name: str = "fence") -> None:
        from ..dashboard import Dashboard

        self.epoch = 0
        self.rejections = 0
        self._counter = Dashboard.get_or_create_counter(
            f"EPOCH_FENCE_REJECTIONS[{name}]")

    def admit(self, epoch: int) -> bool:
        if not epoch:
            return True
        if epoch < self.epoch:
            self.rejections += 1
            self._counter.inc()
            return False
        self.epoch = epoch
        return True


class AsyncDeltaBus:
    """Per-process async-PS data plane (publish + drain thread)."""

    def __init__(self, sess, client, poll_interval: float) -> None:
        from ..dashboard import Dashboard

        global _active_bus, _published, _consumed, _drain_round, \
            _counters_group
        self._sess = sess
        self._client = client
        self._rank = sess.rank
        self._size = sess.size
        self._interval = poll_interval
        self._filters: dict = {}   # wire dtype -> SparseFilter
        self._pub_lock = threading.Lock()
        self._drain_lock = threading.Lock()
        self._stop = threading.Event()
        self._max_record = max(
            int(config.get_flag("async_max_record_kb")), 64) << 10
        self._max_inflight = max(
            int(config.get_flag("async_max_inflight_mb")), 1) << 20
        with _state_lock:
            if _active_bus is not None:
                Log.fatal("async PS: a second AsyncDeltaBus in one process "
                          "would share the module-level sequence counters; "
                          "stop() the first bus before starting another")
            if _counters_group is not sess.group:
                # a new group: a fresh store, so fresh sequence numbers
                _published, _consumed, _drain_round = 0, {}, 0
                _counters_group = sess.group
            for r in range(self._size):
                _consumed.setdefault(r, 0)
            _active_bus = self
        # ranks declared dead (FailureDetector -> mark_dead): out of the
        # ack quorum and the drain targets. Changed without _pub_lock (a
        # publisher blocked on backpressure holds it, and the declaration
        # is what releases it)
        self._dead: set = set()
        self._survivor_mode = float(
            config.get_flag("failure_timeout_s")) > 0
        self._p2p = None
        try:
            if config.get_flag("async_p2p"):
                self._p2p = self._start_p2p()
        except BaseException:
            with _state_lock:
                _active_bus = None
            raise
        # (seq, nbytes) of own records not yet acked by every consumer;
        # drives backpressure and ack-key GC (guarded by _pub_lock)
        self._outstanding: Deque[Tuple[int, int]] = collections.deque()
        self._inflight_bytes = 0
        self._parts: dict = {}     # publisher rank -> part payloads so far
        self._t0 = time.perf_counter()
        self.pub_bytes = 0
        self.apply_bytes = 0
        self.applied = 0
        self.backpressure_waits = 0
        # trainer incarnation epoch (0 = unfenced); appliers fence on it
        self.epoch = 0
        self._fence = EpochFence(f"bus.r{self._rank}")
        self._mon_pub = Dashboard.get_or_create("ASYNC_BUS[PUBLISH]")
        self._mon_apply = Dashboard.get_or_create("ASYNC_BUS[APPLY]")
        self._mon_lat = Dashboard.get_or_create("ASYNC_BUS[LATENCY]")
        # the card the session's tables live on: "cuda" names the main
        # thread's current device, which a new thread does not inherit
        device = getattr(sess, "device", None)
        self._cuda_index = None
        if device is not None and device.type == "cuda":
            self._cuda_index = (torch.cuda.current_device()
                                if device.index is None else device.index)
        self._thread = threading.Thread(
            target=self._drain_loop, name="mvps-drain", daemon=True)
        self._thread.start()

    def _start_p2p(self):
        """The p2p payload plane, if every rank has it (JAX :272-315)."""
        from .p2p import P2PTransport

        p2p = None
        try:
            # a restarted bus resumes streams from the consumed counters
            # (a graceful restart drained first, so they equal each
            # peer's published count)
            p2p = P2PTransport(
                self._rank, self._size, self._client,
                initial_resume={r: _consumed.get(r, 0)
                                for r in range(self._size)
                                if r != self._rank},
                on_dead=self.mark_dead)
        except Exception as exc:
            Log.error("async PS: p2p transport unavailable (%s)", exc)
        # the payload plane must be agreed: one rank on KV payloads while
        # its peers publish over sockets would split the bus. Each rank
        # publishes its outcome and everyone ANDs them.
        self._client.key_value_set(f"mvps/p2p/{self._rank}",
                                   "1" if p2p else "0", allow_overwrite=True)
        all_ok = p2p is not None
        for r in range(self._size):
            if r == self._rank:
                continue
            try:
                ok = self._client.blocking_key_value_get(f"mvps/p2p/{r}",
                                                         120_000)
            except Exception as exc:
                if p2p is not None:
                    p2p.stop()
                Log.fatal(f"async PS: no p2p handshake from rank {r}: "
                          f"{exc}")
            all_ok = all_ok and str(ok) == "1"
        if not all_ok and p2p is not None:
            Log.error("async PS: a peer lacks p2p; the whole group falls "
                      "back to KV payloads")
            p2p.stop()
            p2p = None
        return p2p

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def maybe_start(cls, sess) -> Optional["AsyncDeltaBus"]:
        """Start the bus iff this session runs multi-process async PS."""
        if sess.size <= 1:
            return None
        if config.get_flag("sync") or config.get_flag("ma"):
            return None
        interval = float(config.get_flag("async_poll_ms")) / 1000.0
        bus = cls(sess, sess.client, interval)
        Log.info("async PS bus up: rank %d/%d, poll %.0f ms, payloads %s",
                 sess.rank, sess.size, interval * 1000,
                 "p2p" if bus._p2p is not None else "KV")
        return bus

    def stop(self) -> None:
        """Collective: drain everything in flight, then stop the thread."""
        global _active_bus
        try:
            self.drain()
        finally:
            # deregister even when drain() fails, but only once the drain
            # thread is gone (a live one would race a successor bus on the
            # module-level counters)
            self._stop.set()
            self._thread.join(timeout=30)
            if self._p2p is not None:
                self._p2p.stop()
            with _state_lock:
                if self._thread.is_alive():
                    Log.error("async PS: drain thread failed to stop in "
                              "30 s; the bus stays registered")
                elif _active_bus is self:
                    _active_bus = None

    # -- publish (worker -> group) ----------------------------------------
    def _acks_for(self, seq: int) -> int:
        try:
            return int(self._client.key_value_try_get(
                f"mvps/{self._rank}/{seq}/a"))
        except KeyError:   # NOT_FOUND: no consumer acked yet
            return 0

    def _reap_acks(self) -> None:
        """Advance the backpressure frontier: pop fully-acked own records
        and delete their payload and ack keys. Caller holds
        ``_pub_lock``."""
        while self._outstanding:
            seq, nbytes = self._outstanding[0]
            # dead peers leave the quorum; one that acked before dying only
            # over-satisfies the check
            if self._acks_for(seq) < self._size - 1 - len(self._dead):
                return
            key = f"mvps/{self._rank}/{seq}"
            if self._p2p is None:
                self._client.key_value_delete(key)
            self._client.key_value_delete(f"{key}/a")
            if self._p2p is not None:
                # fully acked: no reconnect can ask for it again
                self._p2p.release(seq)
            self._outstanding.popleft()
            self._inflight_bytes -= nbytes

    def _put_record(self, payload: bytes) -> None:
        """One wire record: the backpressure gate, the write, the counter.
        Caller holds ``_pub_lock``. The ack frontier is polled only once
        the bytes in flight pass half the watermark."""
        global _published
        if self._inflight_bytes + len(payload) > self._max_inflight // 2:
            self._reap_acks()
        waited = False
        deadline = time.monotonic() + 600.0
        while (self._outstanding
               and self._inflight_bytes + len(payload) > self._max_inflight):
            if not waited:
                self.backpressure_waits += 1
                Log.debug("async PS: backpressure at %.1f MB in flight",
                          self._inflight_bytes / 1e6)
                waited = True
            if self._stop.is_set():
                # dropping the record would diverge the peers that
                # consumed earlier ones from this rank: a caller error
                Log.fatal("async PS: publish raced shutdown with "
                          f"{self._inflight_bytes / 1e6:.1f} MB un-acked; "
                          "callers must drain() before stopping the bus")
            if time.monotonic() > deadline:
                Log.fatal(
                    f"async PS backpressure timed out: "
                    f"{self._inflight_bytes / 1e6:.1f} MB un-acked after "
                    f"600 s (peer dead? see parallel.FailureDetector); "
                    f"oldest seq {self._outstanding[0][0]}")
            time.sleep(self._interval)
            self._reap_acks()
        seq = _published
        if self._p2p is not None:
            # the payload rides the sockets; the counter and acks stay in
            # the KV (a consumer may see the counter before the frame and
            # simply retries)
            self._p2p.send(seq, payload)
        else:
            self._client.key_value_set_bytes(f"mvps/{self._rank}/{seq}",
                                             payload)
        _published = seq + 1
        # the counter moves after the payload is visible: a reader never
        # sees a sequence number without its record
        self._client.key_value_increment(f"mvps/{self._rank}/n", 1)
        self._outstanding.append((seq, len(payload)))
        self._inflight_bytes += len(payload)
        self.pub_bytes += len(payload)

    def _publish(self, payload: bytes) -> None:
        """One logical record, split into PART records over KV payloads
        when above ``-async_max_record_kb`` (the sockets take any size)."""
        self._mon_pub.begin()
        with self._pub_lock:
            maxb = self._max_record
            if self._p2p is not None or len(payload) <= maxb:
                self._put_record(payload)
            else:
                n_parts = -(-len(payload) // maxb)
                for i in range(n_parts):
                    chunk = payload[i * maxb:(i + 1) * maxb]
                    self._put_record(
                        _PART_HEADER.pack(PART, i, n_parts) + chunk)
        self._mon_pub.end()

    def _filter_for(self, dtype) -> SparseFilter:
        """A SparseFilter typed to the table's dtype (an f32 filter would
        downcast f64 deltas on the wire)."""
        dtype = wire_dtype(dtype)
        f = self._filters.get(dtype)
        if f is None:
            f = self._filters[dtype] = SparseFilter(clip=0.0, dtype=dtype)
        return f

    def set_epoch(self, epoch: int) -> None:
        """Stamp later publishes with a claimed incarnation epoch."""
        self.epoch = int(epoch)

    def publish_dense(self, table_id: int, delta: Any, option) -> None:
        """A whole-table delta (numpy, or a bf16 tensor) through the
        sparse wire filter."""
        sp = trace.start_span("bus.publish", table_id=table_id,
                              wire="dense")
        blobs = self._filter_for(delta.dtype).filter_in([delta.reshape(-1)])
        payload = _serialize(DENSE, table_id, option, blobs, sp.context,
                             epoch=self.epoch)
        self._publish(payload)
        sp.end(bytes=len(payload))

    def publish_keyed(self, table_id: int, ids: np.ndarray, vals: Any,
                      option) -> None:
        sp = trace.start_span("bus.publish", table_id=table_id,
                              wire="keyed")
        payload = _serialize(KEYED, table_id, option,
                             [np.ascontiguousarray(ids, np.int32), vals],
                             sp.context, epoch=self.epoch)
        self._publish(payload)
        sp.end(bytes=len(payload), rows=int(ids.shape[0]))

    def publish_state(self, table) -> None:
        """The table's absolute value (the fenced restart's rebase)."""
        arrays, version = table._state_arrays()
        sp = trace.start_span("bus.publish", table_id=table.table_id,
                              wire="state")
        payload = _serialize(STATE, table.table_id, None, arrays,
                             sp.context, epoch=self.epoch, version=version)
        self._publish(payload)
        sp.end(bytes=len(payload), version=version)

    def publish_delta(self, table, delta: Any, option) -> None:
        """A whole-table delta in its cheapest sound form (JAX :552-573):
        the touched rows (keyed) of a row table on the commutative
        ``default`` updater when at most 90% of the rows moved, else
        dense. ``delta`` is host values; they travel in the table's
        dtype."""
        delta = cast_host(delta, table.dtype)
        if (delta.ndim == 2 and table.updater.name == "default"
                and hasattr(table, "num_col")):
            moved = (delta.any(dim=1).numpy()
                     if isinstance(delta, torch.Tensor)
                     else delta.any(axis=1))
            rows = np.flatnonzero(moved)
            if rows.size <= 0.9 * delta.shape[0]:
                if rows.size:
                    self.publish_keyed(table.table_id, rows.astype(np.int32),
                                       delta[torch.from_numpy(rows)]
                                       if isinstance(delta, torch.Tensor)
                                       else delta[rows], option)
                return
        self.publish_dense(table.table_id, delta, option)

    def publish_kv(self, table_id: int, keys: np.ndarray,
                   vals: np.ndarray) -> None:
        sp = trace.start_span("bus.publish", table_id=table_id, wire="kv")
        payload = _serialize(KV, table_id, None, [keys, vals], sp.context)
        self._publish(payload)
        sp.end(bytes=len(payload))

    # -- drain (group -> local replica) ------------------------------------
    def _peer_count(self, r: int) -> int:
        # only an absent counter reads as 0: drain() pins its frontier on
        # this value, so a transport error must not pass as "nothing"
        try:
            return int(self._client.key_value_try_get(f"mvps/{r}/n"))
        except KeyError:
            return 0

    def poll_once(self) -> int:
        """Apply every peer record visible now; returns how many."""
        applied = 0
        with self._drain_lock:
            for r in range(self._size):
                if r == self._rank or r in self._dead:
                    continue
                n = self._peer_count(r)
                while _consumed[r] < n:
                    seq = _consumed[r]
                    key = f"mvps/{r}/{seq}"
                    if self._p2p is not None:
                        data = self._p2p.pop_ready(r, seq)
                        if data is None:
                            break      # frame still on the wire
                    else:
                        data = self._client.blocking_key_value_get_bytes(
                            key, 60_000)
                    self._consume(r, data)
                    with _state_lock:
                        _consumed[r] = seq + 1
                    applied += 1
                    # consumers only ack; the publisher deletes
                    self._client.key_value_increment(f"{key}/a", 1)
        return applied

    def _consume(self, publisher: int, data: bytes) -> None:
        """Reassemble PART records (consecutive seqs of one publisher) and
        apply each whole logical record once."""
        if data[:1] == bytes([PART]) and len(data) >= _PART_HEADER.size:
            _, idx, n_parts = _PART_HEADER.unpack(data[:_PART_HEADER.size])
            buf = self._parts.setdefault(publisher, [])
            if idx != len(buf):
                # parts ride consecutive sequence numbers consumed in
                # order: a part out of place means the ordering broke, and
                # applying around it would silently diverge this replica
                Log.fatal(f"async PS: part {idx}/{n_parts} from rank "
                          f"{publisher} arrived at position {len(buf)}")
            buf.append(data[_PART_HEADER.size:])
            if len(buf) < n_parts:
                return
            data = b"".join(buf)
            self._parts[publisher] = []
        self._apply(data)

    def _drain_loop(self) -> None:
        from ..log import FatalError

        if self._cuda_index is not None:
            # this thread's kernels go to the session's card, on its
            # default stream (the trainer's too: the table locks order
            # the two threads' launches)
            torch.cuda.set_device(self._cuda_index)
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except FatalError:
                # an invariant broke (logged at critical): stop consuming,
                # so drain() stalls loudly instead of passing short
                raise
            except Exception as exc:
                if not self._stop.is_set():
                    Log.error("async PS drain error: %s", exc)

    def _apply(self, data: bytes) -> None:
        (kind, table_id, option, arrays, send_ts, ctx, epoch,
         version) = _deserialize(data)
        # the carried context makes this apply a child of the remote
        # publish span: one trace across the process boundary
        sp = (trace.start_span("bus.apply", parent=ctx, table_id=table_id)
              if ctx is not None else trace.NULL_SPAN)
        if not self._fence.admit(epoch):
            # a lower incarnation's (zombie's) record: consumed, not folded
            Log.error("async PS: rejected epoch-%d record for table %d "
                      "(fence at epoch %d)", epoch, table_id,
                      self._fence.epoch)
            sp.end(error="epoch_fenced", epoch=epoch)
            return
        self._mon_apply.begin()
        table = self._sess.table(table_id)
        if kind == DENSE:
            # the publisher staged the delta in the table's dtype
            flat = self._filter_for(table.dtype).filter_out(arrays)[0]
            table._apply_remote_dense(flat.reshape(table.shape), option)
        elif kind == KEYED:
            table._apply_remote_keyed(arrays[0], arrays[1], option)
        elif kind == KV:
            table._apply_remote_kv(arrays[0], arrays[1])
        elif kind == STATE:
            table._install_state_arrays(arrays, version, epoch)
        else:
            Log.error("async PS: unknown record kind %d", kind)
        self._mon_apply.end()
        self.apply_bytes += len(data)
        self.applied += 1
        wire_lat_ms = max(0.0, (time.time() - send_ts) * 1e3)
        self._mon_lat.record(wire_lat_ms)
        sp.end(bytes=len(data), wire_latency_ms=round(wire_lat_ms, 3))

    def stats(self) -> dict:
        """Measured bus rates since this bus started (both directions)."""
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "published": _published,
            "applied": self.applied,
            "pub_bytes": self.pub_bytes,
            "apply_bytes": self.apply_bytes,
            "pub_mb_s": self.pub_bytes / 1e6 / dt,
            "apply_mb_s": self.apply_bytes / 1e6 / dt,
            "inflight_bytes": self._inflight_bytes,
            "backpressure_waits": self.backpressure_waits,
            "apply_lat_avg_ms": self._mon_lat.average_ms(),
            "epoch": self.epoch,
            "fence_epoch": self._fence.epoch,
            "fence_rejections": self._fence.rejections,
        }

    # -- failure handling --------------------------------------------------
    def mark_dead(self, ranks) -> None:
        """The FailureDetector's survivor-mode action (JAX :721-754): a
        declared-dead rank leaves the ack quorum (releasing backpressure
        its silence pinned), the drain targets and the p2p fan-out, and
        the declaration goes to the KV for the peers that have not seen
        it yet. Takes no ``_pub_lock`` (a blocked publisher holds it). The
        dead rank's last records may have reached some survivors and not
        others, bounded by the in-flight watermark."""
        ranks = {int(r) for r in ranks} - {self._rank}
        new = ranks - self._dead
        if not new:
            return
        self._dead |= new
        for r in new:
            try:
                self._client.key_value_set(f"mvps/dead/{r}", "1",
                                           allow_overwrite=True)
            except Exception:
                pass    # best effort; the peers' own detectors still fire
        if self._p2p is not None:
            self._p2p.mark_dead(new)
        Log.error("async PS: rank(s) %s declared dead; continuing with "
                  "%d live peer(s)", sorted(new),
                  self._size - 1 - len(self._dead))

    def _live_ranks(self):
        """Union the KV's dead declarations into the local set (survivor
        mode only) and return the live ranks, self included."""
        if self._survivor_mode:
            for r in range(self._size):
                if r != self._rank and r not in self._dead:
                    try:
                        self._client.key_value_try_get(f"mvps/dead/{r}")
                    except KeyError:
                        continue   # not declared: live
                    self.mark_dead({r})
        return [r for r in range(self._size) if r not in self._dead]

    def _live_barrier(self, name: str, live):
        """Rendezvous of ``live``, robust to a peer dying mid-barrier (JAX
        :773-844): in survivor mode each attempt is a fresh single-use
        barrier with a watchdog-scaled budget; a completed attempt
        publishes its participants, so a rank whose own wait ran out as
        the barrier completed joins it instead of retrying alone; a failed
        attempt re-unions the live list and retries. Returns the live
        list."""
        if not self._survivor_mode:
            self._client.wait_at_barrier(name, 600_000, live)
            return live
        deadline = time.monotonic() + 600.0
        per_try_ms = int(max(
            2.0 * float(config.get_flag("failure_timeout_s")), 5.0) * 1000)
        attempt = 0
        win_key = f"{name}/win"
        while True:
            attempt += 1
            try:
                self._client.wait_at_barrier(
                    f"{name}/t{attempt}", per_try_ms, live)
                self._client.key_value_set(
                    win_key, f"{attempt}:{','.join(map(str, live))}",
                    allow_overwrite=True)
                return live
            except TimeoutError as exc:
                try:
                    won = self._client.key_value_try_get(win_key)
                except KeyError:
                    won = None     # no attempt completed yet
                if won is not None:
                    _, _, members = won.partition(":")
                    winners = {int(r) for r in members.split(",") if r}
                    if self._rank in winners:
                        Log.info("async PS: barrier %s completed (%s) "
                                 "while this rank's wait ran out; joining "
                                 "it", name, won)
                        return live
                    Log.error("async PS: barrier %s completed without "
                              "this rank (%s): the survivors declared it "
                              "dead", name, won)
                if time.monotonic() > deadline:
                    Log.fatal(f"async PS live barrier {name} failed after "
                              f"600 s: {exc}")
                live = [r for r in self._live_ranks() if r in live]

    # -- quiesce -----------------------------------------------------------
    def drain(self, tag: str = "drain") -> None:
        """Collective flush among the live processes (JAX :847-898):
        barrier A pins the publication frontier, each process consumes up
        to the pinned counters, barrier B confirms it everywhere. A peer
        declared dead meanwhile leaves the targets and barrier B."""
        global _drain_round
        with _state_lock:
            _drain_round += 1
            rnd = _drain_round
        live = self._live_ranks()
        live = self._live_barrier(f"mvps/{tag}/{rnd}/a", live)
        targets = {r: self._peer_count(r) for r in live if r != self._rank}
        last_progress = time.monotonic()
        while True:
            targets = {r: n for r, n in targets.items()
                       if r not in self._dead}
            # under the drain lock: a record the drain thread has counted
            # consumed is acked too before this rank may pass barrier B
            # (its publisher reaps after B and must see every ack)
            with self._drain_lock:
                missing = {r: n - _consumed[r] for r, n in targets.items()
                           if _consumed[r] < n}
            if not missing:
                break
            if self.poll_once() == 0:
                if time.monotonic() - last_progress > 60.0:
                    Log.fatal(
                        f"async PS drain stalled 60 s waiting on records "
                        f"{missing} (rank->count); peer dead or transport "
                        f"broken; see parallel.FailureDetector")
                time.sleep(0.002)      # p2p frames may still be in flight
            else:
                last_progress = time.monotonic()
        live = [r for r in self._live_ranks() if r in live]
        self._live_barrier(f"mvps/{tag}/{rnd}/b", live)
        # every own record is applied (and acked) everywhere live now
        with self._pub_lock:
            self._reap_acks()
