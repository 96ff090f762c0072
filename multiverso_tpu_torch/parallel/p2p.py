"""Peer-to-peer TCP record transport (the ``mvserve`` fleet's wire).

Counterpart of ``multiverso_tpu/parallel/p2p.py``, byte-compatible with
it: a JAX publisher and a port subscriber interoperate in both
directions over one KV. The KV client is the JAX package's duck type
(``key_value_set``, ``blocking_key_value_get`` and, optionally,
``key_value_try_get``); it carries only the control plane, endpoint
discovery, while payload bytes ride direct per-pair sockets:

* every rank listens on an ephemeral port and advertises
  ``{label}/ep/{rank} = host:port`` in the KV;
* a subscriber connects to each publisher it reads and sends a hello,
  ``<IQ`` (its own rank, the sequence number it wants to resume from);
  records flow publisher -> subscriber down that connection, so ordering
  per publisher is TCP's;
* frames are ``<QI`` (sequence number, length) + payload; the sequence
  number is authoritative, and a gap fails loudly.

Reconnect: a broken subscription re-fetches the publisher's endpoint and
reconnects with a hello carrying the next sequence number it expects;
the publisher replays from its RETAINED window, which holds every record
not yet released by :meth:`P2PTransport.release` (the consumers' acks
drive it). A duplicate subscription from the same peer REPLACES the old
sender. Failed connects back off on :func:`reconnect_backoff_s`.

Threads: one accept loop, one sender per live subscription (a cursor
over the retained window), one receiver per subscription (appending to
an in-order inbox that :meth:`P2PTransport.pop_ready` drains). All
daemon; :meth:`P2PTransport.stop` closes sockets and joins.
"""

from __future__ import annotations

import collections
import random
import socket
import struct
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from ..log import Log

_FRAME = struct.Struct("<QI")   # seq, payload length
_HELLO = struct.Struct("<IQ")   # subscriber rank, resume-from seq
_HELLO_TIMEOUT_S = 5.0          # accept-loop budget for the 12-byte hello
_BACKOFF_BASE_S = 0.05          # first reconnect delay
_BACKOFF_CAP_S = 2.0            # reconnect delay ceiling


def reconnect_backoff_s(attempt: int, base_s: float = _BACKOFF_BASE_S,
                        cap_s: float = _BACKOFF_CAP_S,
                        rng: Optional[random.Random] = None) -> float:
    """Delay before reconnect ``attempt`` (0-based): the capped
    exponential ceiling ``min(cap, base * 2**attempt)``, jittered into
    ``[ceiling/2, ceiling]`` when ``rng`` is given. The old fixed
    50 ms loop hammered a flapping peer's listener (and the KV
    endpoint lookup in front of it) at 20 Hz per subscriber forever;
    the schedule keeps the first retries prompt and the steady state
    polite, and the jitter keeps a fleet's subscribers from re-landing
    as one synchronized thundering herd."""
    if attempt < 0:
        raise ValueError(f"attempt is 0-based, got {attempt}")
    # clamp the exponent: a peer down for ~35 min would push 2**attempt
    # past float range and the OverflowError would kill the subscriber
    # thread — permanently losing the subscription right when patience
    # was the whole point
    ceiling = min(cap_s, base_s * (2.0 ** min(attempt, 64)))
    if rng is None:
        return ceiling
    return ceiling * (0.5 + 0.5 * rng.random())


def _local_host() -> str:
    """Advertised host: MV_P2P_HOST overrides; default = the hostname's
    address (localhost setups resolve to 127.x and work either way)."""
    import os

    host = os.environ.get("MV_P2P_HOST")
    if host:
        return host
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


class P2PTransport:
    """Direct-socket record plane between the processes of one bus."""

    def __init__(self, rank: int, size: int, client,
                 label: str = "mvps", connect_timeout_s: float = 60.0,
                 initial_resume: Optional[Dict[int, int]] = None,
                 on_dead=None,
                 subscribe_to: Optional[List[int]] = None) -> None:
        self._rank = rank
        self._size = size
        self._client = client
        self._label = label
        # bus hook for TRANSPORT-declared deaths (out-of-contract resume):
        # without it the bus's ack quorum keeps counting the rejected peer
        # and the publisher can only exit via the 600-s backpressure fatal.
        # Invoked WITHOUT _out_cv held — the bus's mark_dead re-enters
        # p2p.mark_dead, which takes the (non-reentrant) lock.
        self._on_dead = on_dead
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # publisher side: retained un-GC'd records (seq -> payload) + the
        # next seq to be published; per-subscriber senders are cursors
        # over this window (guarded by _lock / signalled via _out_cv)
        self._retained: Dict[int, bytes] = {}
        self._next_seq: Optional[int] = None
        self._out_cv = threading.Condition(self._lock)
        # peer -> sender state dict; identity is the liveness token — a
        # sender whose state is no longer registered has been replaced
        self._senders: Dict[int, dict] = {}
        # consumer side: per-publisher in-order inboxes + next expected seq
        self._in: Dict[int, Deque[Tuple[int, bytes]]] = {
            r: collections.deque() for r in range(size) if r != rank}
        self._expect: Dict[int, int] = {
            r: int((initial_resume or {}).get(r, 0)) for r in self._in}
        self._dead: set = set()
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        # reconnect jitter stream (rank-seeded: deterministic per
        # process, decorrelated across the mesh)
        self._backoff_rng = random.Random(0x9B2C ^ rank)

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("", 0))
        self._listener.listen(size)
        port = self._listener.getsockname()[1]
        # allow_overwrite: the KV outlives the Session; a restarted bus
        # re-advertises its (new) endpoint
        client.key_value_set(f"{label}/ep/{rank}",
                             f"{_local_host()}:{port}", allow_overwrite=True)
        self._spawn(self._accept_loop, "p2p-accept")
        # records flow publisher -> subscriber, so which streams exist
        # is the SUBSCRIBER's choice: the default (None) is the bus's
        # full mesh, while a hub-topology plane (the obs collector is
        # the only consumer) subscribes each rank to exactly the peers
        # it reads — an empty list publishes only, and no redundant
        # copy of any record ever crosses the wire
        subs = list(self._in) if subscribe_to is None else [
            r for r in subscribe_to if r in self._in]
        for r in subs:
            self._spawn(self._subscribe, f"p2p-sub-{r}", r,
                        connect_timeout_s)

    def _spawn(self, fn, name, *args) -> None:
        t = threading.Thread(target=fn, name=name, args=args, daemon=True)
        t.start()
        # prune retired senders so reconnect churn can't grow the join
        # list without bound (under _lock: __init__ and the accept loop
        # spawn concurrently, and a lost append would skip a join)
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _track(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)

    def _close(self, conn: Optional[socket.socket]) -> None:
        if conn is None:
            return
        with self._lock:
            self._conns.discard(conn)
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    # -- publisher side ----------------------------------------------------
    def send(self, seq: int, payload: bytes) -> None:
        """Retain one record and wake the per-subscriber senders
        (non-blocking; the bus's in-flight-bytes watermark bounds the
        retained window — see :meth:`release`)."""
        with self._out_cv:
            self._retained[seq] = payload
            self._next_seq = seq + 1
            self._out_cv.notify_all()

    def release(self, seq: int) -> None:
        """Drop a fully-acknowledged record from the retained window.

        Called by the bus's ack-GC frontier (`_reap_acks`) — once every
        live consumer acked ``seq``, no reconnect can legitimately ask
        for it again (a consumer only acks what it consumed, and resumes
        strictly after what it consumed)."""
        with self._out_cv:
            self._retained.pop(seq, None)

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return                       # listener closed by stop()
            try:
                # a short hello deadline: a half-open connection (client
                # stalled between connect and sendall) must not wedge the
                # single accept thread — every OTHER peer's reconnect
                # funnels through it. socket.timeout is an OSError, so
                # the silent client lands in the except below.
                conn.settimeout(_HELLO_TIMEOUT_S)
                hello = self._read_exact(conn, _HELLO.size)
                peer, resume = _HELLO.unpack(hello)
                conn.settimeout(None)   # streaming is deadline-free again
            except OSError:
                conn.close()
                continue
            if (peer in self._dead or peer == self._rank
                    or not 0 <= peer < self._size):
                # declared-dead (or out-of-contract resurrected) peers and
                # bogus hellos (port scanner, wrong-label client, own
                # rank) get no stream; closing here keeps the reject
                # bounded instead of granting a replay sender slot
                conn.close()
                continue
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._track(conn)
            state = {"peer": peer, "conn": conn, "cursor": resume}
            with self._lock:
                old = self._senders.pop(peer, None)
                self._senders[peer] = state
            # a duplicate subscribe REPLACES the old sender: closing its
            # socket errors out any blocked send; the registry check below
            # exits it even when it was idle-waiting
            if old is not None:
                self._close(old["conn"])
            self._spawn(self._send_loop, f"p2p-send-{peer}", state)

    def _send_loop(self, state: dict) -> None:
        peer: int = state["peer"]
        conn: socket.socket = state["conn"]
        cursor: int = state["cursor"]
        while True:
            with self._out_cv:
                while (not self._stop.is_set()
                       and self._senders.get(peer) is state
                       and peer not in self._dead
                       and (self._next_seq is None
                            or cursor >= self._next_seq)):
                    self._out_cv.wait(0.2)
                if (self._stop.is_set() or peer in self._dead
                        or self._senders.get(peer) is not state):
                    if self._senders.get(peer) is state:
                        self._senders.pop(peer, None)
                    break
                payload = self._retained.get(cursor)
            if payload is None:
                # only reachable for a resurrected peer whose records were
                # GC'd after it was declared dead — out of contract.
                # Mark it dead transport-side so its retry loop gets a
                # bounded reject at accept instead of a fresh sender +
                # error line per attempt.
                Log.error("p2p: rank %d resumed from seq %d which is "
                          "already released (declared dead earlier?); "
                          "rejecting its stream", peer, cursor)
                with self._out_cv:
                    self._dead.add(peer)
                    self._senders.pop(peer, None)
                # surface the death to the bus (outside the lock — see
                # __init__) so its ack quorum shrinks NOW instead of
                # burning the 600-s backpressure deadline into Log.fatal
                if self._on_dead is not None:
                    try:
                        self._on_dead({peer})
                    except Exception as exc:
                        Log.error("p2p: on_dead hook failed for rank %d: "
                                  "%s", peer, exc)
                break
            try:
                # sendmsg scatters header + payload in one syscall without
                # concatenating (the concat alone costs a payload-sized
                # memcpy per subscriber on multi-MB records)
                self._send_frame(conn, cursor, payload)
            except OSError:
                # the subscriber reconnects with its own resume point;
                # this sender just retires
                with self._lock:
                    if self._senders.get(peer) is state:
                        self._senders.pop(peer, None)
                break
            cursor += 1
        # every exit path closes + untracks this connection (a replaced
        # sender's conn was already closed by the accept loop — _close is
        # idempotent)
        self._close(conn)

    @staticmethod
    def _send_frame(conn: socket.socket, seq: int, payload: bytes) -> None:
        header = _FRAME.pack(seq, len(payload))
        view = memoryview(payload)
        sent = conn.sendmsg([header, view])
        # sendmsg may send partially; finish the remainder with sendall
        if sent < len(header) + len(view):
            if sent < len(header):
                conn.sendall(header[sent:])
                conn.sendall(view)
            else:
                conn.sendall(view[sent - len(header):])

    # -- consumer side -----------------------------------------------------
    @staticmethod
    def _read_exact(conn: socket.socket, n: int) -> bytearray:
        # recv_into a preallocated buffer: no per-chunk allocations, no
        # final copy (callers treat the result as read-only bytes-like)
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            r = conn.recv_into(view[got:], n - got)
            if r == 0:
                raise OSError("connection closed")
            got += r
        return buf

    def _endpoint(self, publisher: int, timeout_ms: int) -> Tuple[str, int]:
        ep = self._client.blocking_key_value_get(
            f"{self._label}/ep/{publisher}", timeout_ms)
        host, _, port = str(ep).rpartition(":")
        return host, int(port)

    def _connect(self, publisher: int, first: bool,
                 timeout_s: float) -> Optional[socket.socket]:
        """One connected+hello'd socket to ``publisher``, or None.

        The FIRST subscription bounds endpoint discovery by
        ``timeout_s`` (a peer that never comes up fails the bus
        handshake anyway); reconnects retry indefinitely — transient
        breaks are the transport's job, permanent death is the
        FailureDetector's (`mark_dead` ends the retries). Failed
        attempts back off on the capped-exponential-with-jitter
        schedule (:func:`reconnect_backoff_s`); a successful connect
        resets it."""
        deadline = time.monotonic() + timeout_s
        attempt = 0
        while not self._stop.is_set() and publisher not in self._dead:
            try:
                # re-fetch each attempt: a restarted publisher
                # re-advertises a NEW ephemeral port
                host, port = self._endpoint(publisher, 5_000)
                conn = socket.create_connection((host, port), timeout=5)
            except Exception as exc:
                if first and time.monotonic() > deadline:
                    Log.error("p2p: no endpoint from rank %d within "
                              "%.0f s: %s", publisher, timeout_s, exc)
                    return None
                time.sleep(reconnect_backoff_s(attempt,
                                               rng=self._backoff_rng))
                attempt += 1
                continue
            # create_connection leaves its 5 s connect timeout on the
            # socket; a publisher idle longer than that (jit compile,
            # barrier) must read as silence, not a broken stream
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            try:
                with self._lock:
                    resume = self._expect[publisher]
                conn.sendall(_HELLO.pack(self._rank, resume))
            except OSError:
                self._close(conn)
                time.sleep(reconnect_backoff_s(attempt,
                                               rng=self._backoff_rng))
                attempt += 1
                continue
            self._track(conn)
            return conn
        return None

    def _subscribe(self, publisher: int, timeout_s: float) -> None:
        first = True
        fails = 0
        while not self._stop.is_set() and publisher not in self._dead:
            conn = self._connect(publisher, first, timeout_s)
            if conn is None:
                return
            first = False
            inbox = self._in[publisher]
            delivered = False
            try:
                while not self._stop.is_set():
                    hdr = self._read_exact(conn, _FRAME.size)
                    seq, length = _FRAME.unpack(hdr)
                    payload = self._read_exact(conn, length)
                    with self._lock:
                        if seq != self._expect[publisher]:
                            # TCP + replay-from-resume preserve per-
                            # publisher order; anything else is a broken
                            # transport invariant (same posture as
                            # pop_ready / the PART reassembly check)
                            Log.fatal(
                                f"p2p: rank {publisher} stream out of "
                                f"order: got seq {seq}, expected "
                                f"{self._expect[publisher]}")
                        inbox.append((seq, payload))
                        self._expect[publisher] = seq + 1
                    delivered = True
            except OSError as exc:
                if self._stop.is_set() or publisher in self._dead:
                    return
                with self._lock:
                    resume = self._expect[publisher]
                Log.info("p2p: stream from rank %d broke (%s); "
                         "reconnecting from seq %d", publisher, exc, resume)
            finally:
                self._close(conn)
            # a stream the publisher keeps closing without delivering
            # anything (out-of-contract reject) backs off instead of
            # spinning the accept loop at ~20 Hz; a delivering stream
            # resets the schedule — its next break reconnects promptly
            fails = 0 if delivered else fails + 1
            time.sleep(reconnect_backoff_s(fails, rng=self._backoff_rng))

    def pop_ready(self, publisher: int, expected_seq: int
                  ) -> Optional[bytes]:
        """Return the payload for ``expected_seq`` if it is the inbox head.

        TCP preserves per-publisher order, so the head either IS the
        expected record or hasn't arrived yet; anything else is a broken
        transport invariant and fails loudly (same posture as the PART
        reassembly check)."""
        with self._lock:
            inbox = self._in[publisher]
            if not inbox:
                return None
            seq, payload = inbox[0]
            if seq != expected_seq:
                Log.fatal(f"p2p: rank {publisher} stream out of order: "
                          f"seq {seq} at head, expected {expected_seq}")
            inbox.popleft()
            return payload

    # -- failure handling (wired by the bus, driven by FailureDetector) ----
    def mark_dead(self, ranks) -> None:
        """Stop queueing to / expecting from / reconnecting to dead peers;
        their senders exit and release any cursor state. Closing the
        conns matters: a sender to a wedged peer is typically blocked in
        ``sendall`` (full TCP buffers), where no cv notify reaches it —
        only erroring the syscall out does."""
        dropped = []
        with self._out_cv:
            for r in ranks:
                self._dead.add(r)
                state = self._senders.pop(r, None)
                if state is not None:
                    dropped.append(state)
            self._out_cv.notify_all()
        for state in dropped:
            self._close(state["conn"])

    def stop(self) -> None:
        self._stop.set()
        # close() alone does not reliably interrupt a thread blocked in
        # accept(); on a busy mesh a peer's reconnect attempt wakes it
        # by accident, but a QUIET topology (param plane, a stopped
        # fleet) left the accept thread parked until the joiner's 5-s
        # timeout expired — one self-connect wakes it deterministically
        # (the dummy conn closes immediately, so the hello read fails
        # fast and the loop observes the stop flag)
        try:
            port = self._listener.getsockname()[1]
            socket.create_connection(("127.0.0.1", port),
                                     timeout=0.2).close()
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            self._close(c)
        for t in self._threads:
            t.join(timeout=5)
