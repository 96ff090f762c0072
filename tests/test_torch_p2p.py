"""The port's peer-to-peer record transport against the JAX package's.

``multiverso_tpu_torch.parallel.p2p`` is the ``mvserve`` fleet's wire.
Held here: the frame layout on a raw socket (``<IQ`` hello, ``<QI``
frames), resume after a broken subscription, release of the retained
window, a duplicate subscription replacing the old sender, the
reconnect schedule equal to the JAX package's, and a JAX transport and a
port transport exchanging records both ways over one KV, sequence
numbers and bytes equal. Mirrors of ``tests/test_p2p_robustness.py``: a
silent hello that must not wedge the accept loop, an out-of-contract
resume reported through ``on_dead``, and a flapping endpoint whose
retries sleep the growing schedule before the stream resumes.
"""

import random
import socket
import threading
import time

import pytest

from multiverso_tpu.parallel import p2p as jp2p
from multiverso_tpu_torch.parallel import p2p as tp2p


class _KV:
    """The client calls the transport makes, over a local dict."""

    def __init__(self):
        self._d = {}
        self._cv = threading.Condition()

    def key_value_set(self, key, val, allow_overwrite=False):
        with self._cv:
            self._d[key] = val
            self._cv.notify_all()

    def blocking_key_value_get(self, key, timeout_ms):
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while key not in self._d:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"NOT_FOUND: {key}")
                self._cv.wait(left)
            return self._d[key]

    def key_value_try_get(self, key):
        with self._cv:
            if key not in self._d:
                raise KeyError(f"NOT_FOUND: {key}")
            return self._d[key]


def _drain(tp, publisher, start, count, timeout=20.0):
    """Pop ``count`` in-order records from ``start`` (pop_ready fails
    loudly on a gap at the head)."""
    got = []
    deadline = time.monotonic() + timeout
    seq = start
    while len(got) < count:
        payload = tp.pop_ready(publisher, seq)
        if payload is None:
            assert time.monotonic() < deadline, \
                f"timed out at seq {seq} with {len(got)}/{count}"
            time.sleep(0.005)
            continue
        got.append(bytes(payload))
        seq += 1
    return got


def _read_exact(conn, n):
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        assert chunk, "connection closed early"
        buf += chunk
    return buf


@pytest.fixture
def pair():
    kv = _KV()
    a = tp2p.P2PTransport(0, 2, kv, label="t")
    b = tp2p.P2PTransport(1, 2, kv, label="t")
    yield kv, a, b
    a.stop()
    b.stop()


def test_frames_on_the_wire_are_the_jax_layout():
    """A raw subscriber: the ``<IQ`` hello (rank, resume seq) gets
    ``<QI`` (seq, length) + payload frames, from the resume point on; the
    endpoint is advertised at ``{label}/ep/{rank}``."""
    assert tp2p._FRAME.format == jp2p._FRAME.format == "<QI"
    assert tp2p._HELLO.format == jp2p._HELLO.format == "<IQ"
    kv = _KV()
    pub = tp2p.P2PTransport(0, 2, kv, label="raw", subscribe_to=[])
    try:
        payloads = [bytes([i]) * (7 + i) for i in range(5)]
        for i, p in enumerate(payloads):
            pub.send(i, p)
        host, _, port = str(kv.blocking_key_value_get("raw/ep/0", 1000)
                            ).rpartition(":")
        conn = socket.create_connection((host, int(port)), timeout=5)
        conn.sendall(tp2p._HELLO.pack(1, 2))          # resume from seq 2
        for i in range(2, 5):
            seq, n = tp2p._FRAME.unpack(_read_exact(conn, 12))
            assert (seq, n) == (i, len(payloads[i]))
            assert _read_exact(conn, n) == payloads[i]
        conn.close()
    finally:
        pub.stop()


def test_broken_subscription_resumes_without_loss(pair):
    """Every established socket closed mid-stream: the subscription
    reconnects with its resume point and the publisher replays from its
    retained window, nothing lost, duplicated or reordered."""
    _, a, b = pair
    payloads = [bytes([i]) * (1 << 12) for i in range(40)]
    for i in range(10):
        a.send(i, payloads[i])
    assert _drain(b, 0, 0, 10) == payloads[:10]
    for tp in (a, b):
        with tp._lock:
            conns = list(tp._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
    for i in range(10, 40):
        a.send(i, payloads[i])
    assert _drain(b, 0, 10, 30) == payloads[10:]


def test_release_bounds_retained_window(pair):
    _, a, b = pair
    for i in range(8):
        a.send(i, b"x" * 100)
    _drain(b, 0, 0, 8)
    for i in range(6):
        a.release(i)
    with a._lock:
        assert set(a._retained) == {6, 7}


def test_duplicate_subscribe_replaces_sender(pair):
    """A second subscription from the same rank replaces the old sender:
    one sender registered, the old connection closed, and the stream
    still delivers exactly once in order."""
    kv, a, b = pair
    a.send(0, b"first")
    assert _drain(b, 0, 0, 1) == [b"first"]
    with a._lock:
        old_state = a._senders[1]
    host, _, port = str(kv.blocking_key_value_get("t/ep/0", 1000)
                        ).rpartition(":")
    rogue = socket.create_connection((host, int(port)), timeout=5)
    rogue.sendall(tp2p._HELLO.pack(1, 1))
    deadline = time.monotonic() + 10
    while True:
        with a._lock:
            state = a._senders.get(1)
            n = len(a._senders)
        if state is not None and state is not old_state and n == 1:
            break
        assert time.monotonic() < deadline, "old sender never replaced"
        time.sleep(0.01)
    deadline = time.monotonic() + 10
    while old_state["conn"].fileno() != -1:
        assert time.monotonic() < deadline, "old conn never closed"
        time.sleep(0.01)
    rogue.close()
    for i in range(1, 6):
        a.send(i, bytes([i]))
    assert _drain(b, 0, 1, 5) == [bytes([i]) for i in range(1, 6)]


@pytest.mark.parametrize("attempt", [0, 1, 3, 7, 40, 5000])
def test_reconnect_backoff_equals_jax(attempt):
    """The same schedule, deterministic and jittered from one seed."""
    assert tp2p.reconnect_backoff_s(attempt) == \
        jp2p.reconnect_backoff_s(attempt)
    ra, rb = random.Random(attempt), random.Random(attempt)
    assert [tp2p.reconnect_backoff_s(attempt, rng=ra) for _ in range(8)] \
        == [jp2p.reconnect_backoff_s(attempt, rng=rb) for _ in range(8)]
    with pytest.raises(ValueError):
        tp2p.reconnect_backoff_s(-1)


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_jax_and_port_transports_interoperate(publisher):
    """Rank 0 is one package's transport, rank 1 the other's, over one
    KV: each publishes to the other, and every record arrives with its
    sequence number and its bytes."""
    kv = _KV()
    mods = {"jax": jp2p, "port": tp2p}
    other = "port" if publisher == "jax" else "jax"
    a = mods[publisher].P2PTransport(0, 2, kv, label="mix")
    b = mods[other].P2PTransport(1, 2, kv, label="mix")
    try:
        ab = [bytes([i % 251]) * (1 + 97 * i) for i in range(12)]
        ba = [b"reply-%d" % i for i in range(7)]
        for i, p in enumerate(ab):
            a.send(i, p)
        for i, p in enumerate(ba):
            b.send(i, p)
        assert _drain(b, 0, 0, len(ab)) == ab
        assert _drain(a, 1, 0, len(ba)) == ba
        # a later record still rides the same stream, in order
        a.send(len(ab), b"tail")
        assert _drain(b, 0, len(ab), 1) == [b"tail"]
    finally:
        a.stop()
        b.stop()


def test_silent_hello_does_not_wedge_accept_loop(monkeypatch):
    """tests/test_p2p_robustness.py:223: a connection that never sends
    its hello is dropped after the hello timeout, and a real subscriber
    queued behind it still gets its stream."""
    monkeypatch.setattr(tp2p, "_HELLO_TIMEOUT_S", 0.3)
    kv = _KV()
    a = tp2p.P2PTransport(0, 2, kv, label="s")
    b = silent = None
    try:
        host, _, port = str(kv.blocking_key_value_get("s/ep/0", 1000)
                            ).rpartition(":")
        silent = socket.create_connection((host, int(port)), timeout=5)
        time.sleep(0.05)
        b = tp2p.P2PTransport(1, 2, kv, label="s")
        a.send(0, b"r0")
        assert _drain(b, 0, 0, 1, timeout=15) == [b"r0"]
    finally:
        if silent is not None:
            silent.close()
        if b is not None:
            b.stop()
        a.stop()


def test_out_of_contract_resume_surfaces_death_to_bus():
    """tests/test_p2p_robustness.py:255: a peer resuming below the
    released window is dead to the transport, and ``on_dead`` reports it
    so the bus's ack quorum shrinks too."""
    kv = _KV()
    reported = []
    # a publisher alone (no subscription of its own to wait out at stop)
    a = tp2p.P2PTransport(0, 2, kv, label="d", subscribe_to=[],
                          on_dead=lambda ranks: reported.extend(ranks))
    conn = None
    try:
        a.send(0, b"x")
        a.send(1, b"y")
        a.release(0)
        a.release(1)
        host, _, port = str(kv.blocking_key_value_get("d/ep/0", 1000)
                            ).rpartition(":")
        # rank 1 resuming from the released seq 0
        conn = socket.create_connection((host, int(port)), timeout=5)
        conn.sendall(tp2p._HELLO.pack(1, 0))
        deadline = time.monotonic() + 10
        while reported != [1]:
            assert time.monotonic() < deadline, "on_dead never fired"
            time.sleep(0.01)
        assert 1 in a._dead
    finally:
        if conn is not None:
            conn.close()
        a.stop()


def test_flapping_endpoint_backs_off_then_resumes(monkeypatch):
    """tests/test_p2p_robustness.py:359: a subscriber whose publisher's
    endpoint lookup fails 4 times sleeps the growing schedule (the last
    retry past 0.2 s, the first at most 0.05 s), then resumes from its
    retained window with nothing lost."""
    kv = _KV()
    a = tp2p.P2PTransport(0, 2, kv, label="flap")
    b = tp2p.P2PTransport(1, 2, kv, label="flap")
    try:
        payloads = [bytes([i]) * 256 for i in range(12)]
        for i in range(6):
            a.send(i, payloads[i])
        assert _drain(b, 0, 0, 6) == payloads[:6]
        sleeps = []
        real_sleep = time.sleep
        monkeypatch.setattr(
            tp2p.time, "sleep",
            lambda s: (sleeps.append(s), real_sleep(min(s, 0.02)))[1])
        fails = {"left": 4}
        endpoint = b._endpoint

        def flaky(publisher, timeout_ms):
            if publisher == 0 and fails["left"] > 0:
                fails["left"] -= 1
                raise OSError("endpoint lookup down (staged flap)")
            return endpoint(publisher, timeout_ms)

        monkeypatch.setattr(b, "_endpoint", flaky)
        with b._lock:
            conns = list(b._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        deadline = time.monotonic() + 20
        while fails["left"] > 0:
            assert time.monotonic() < deadline, (fails, sleeps)
            real_sleep(0.01)
        for i in range(6, 12):
            a.send(i, payloads[i])
        assert _drain(b, 0, 6, 6, timeout=30) == payloads[6:]
        retry_sleeps = [s for s in sleeps if s >= 0.025]
        assert len(retry_sleeps) >= 4, sleeps
        assert min(retry_sleeps) <= 0.05
        assert max(retry_sleeps) > 0.2, retry_sleeps
    finally:
        a.stop()
        b.stop()
