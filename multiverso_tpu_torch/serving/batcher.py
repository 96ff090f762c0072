"""Micro-batching request scheduler: bounded queue -> padded shape buckets.

Counterpart of ``multiverso_tpu/serving/batcher.py``. One model's flush
thread sends a batch on either trigger:

* **size**: ``max_batch`` requests are waiting;
* **deadline**: the oldest waiting request has aged ``deadline_ms``.

A flushed batch pads up to a shape bucket (powers of two up to
``max_batch``), so a workload runs one signature per bucket. Past
``max_queue`` waiting requests ``submit`` sheds with the typed
:class:`OverloadedError`. The idle wait is untimed (``submit`` and
``stop`` notify), so an idle model never wakes. Per-reply latency lands
in ``SERVE_LAT[name]``; ``slo_lat_ms`` > 0 registers its windowed p99
SLO. The decode engine uses the error types and the buckets too.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Deque, List, Optional, Sequence, Tuple

from .. import trace
from ..dashboard import Dashboard
from ..log import Log


class OverloadedError(RuntimeError):
    """Typed fast-reject: the model is out of a bounded resource. ``what``
    names the resource; ``retriable`` says whether a retry can succeed."""

    def __init__(self, model: str, depth: int, cap: int,
                 what: str = "queue depth", retriable: bool = True) -> None:
        super().__init__(
            f"serving {what} for {model!r} at cap ({depth}/{cap}); "
            "request shed")
        self.model = model
        self.depth = depth
        self.cap = cap
        self.what = what
        self.retriable = bool(retriable)


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before it completed."""


def shape_buckets(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch`` (``max_batch`` always included)."""
    buckets: List[int] = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (callers guarantee n <= max(buckets))."""
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


@dataclass
class BatcherConfig:
    max_batch: int = 32
    deadline_ms: float = 2.0
    max_queue: int = 256
    buckets: Optional[Tuple[int, ...]] = None   # default: shape_buckets()
    # windowed p99 reply-latency SLO (None = the -slo_lat_ms flag; 0 = none)
    slo_lat_ms: Optional[float] = None

    def resolved_buckets(self) -> Tuple[int, ...]:
        return tuple(self.buckets) if self.buckets else shape_buckets(
            self.max_batch)

    def resolved_slo_lat_ms(self) -> float:
        if self.slo_lat_ms is not None:
            return float(self.slo_lat_ms)
        from ..config import get_flag

        return float(get_flag("slo_lat_ms"))


class _Pending:
    __slots__ = ("payload", "future", "t_enq", "ctx")

    def __init__(self, payload: Any,
                 ctx: Optional[trace.SpanContext] = None) -> None:
        self.payload = payload
        self.future: Future = Future()
        self.t_enq = time.monotonic()
        # the submitter's root-span context: the flush thread's spans join
        # the request's trace
        self.ctx = ctx


class MicroBatcher:
    """One model's queue + flush thread.

    ``run_batch(payloads, bucket) -> results`` executes a flushed batch
    (``len(payloads) <= bucket``; the workload pads to ``bucket``) and
    returns one result per payload, in order. A batch that raises fails
    the futures of that batch only.
    """

    def __init__(self, name: str,
                 run_batch: Callable[[List[Any], int], List[Any]],
                 config: Optional[BatcherConfig] = None) -> None:
        self.name = name
        self.config = config or BatcherConfig()
        self._buckets = self.config.resolved_buckets()
        if self.config.max_batch > self._buckets[-1]:
            Log.fatal(f"batcher {name!r}: max_batch {self.config.max_batch} "
                      f"exceeds the largest bucket {self._buckets[-1]}")
        self._run_batch = run_batch
        self._q: Deque[_Pending] = collections.deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = threading.Event()
        # -- stats ----------------------------------------------------------
        self.hist = Dashboard.get_or_create_histogram(f"SERVE_LAT[{name}]")
        slo_lat = self.config.resolved_slo_lat_ms()
        if slo_lat > 0:
            Dashboard.set_slo(f"SERVE_LAT[{name}]", slo_lat)
        self.shed_counter = Dashboard.get_or_create_counter(
            f"SERVE_SHED[{name}]")
        self.completed = 0
        self.shed = 0
        self.t_first: Optional[float] = None
        # returns from the idle wait (an idle model never wakes)
        self.idle_wakeups = 0
        # recent (n, bucket, cause) flush records
        self.flushes: Deque[Tuple[int, int, str]] = collections.deque(
            maxlen=1024)
        self._thread = threading.Thread(
            target=self._loop, name=f"serve-batch-{name}", daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, payload: Any,
               ctx: Optional[trace.SpanContext] = None) -> Future:
        """Enqueue one request; sheds at the queue-depth cap. ``ctx`` is
        the request's trace handoff token (or None)."""
        if self._stop.is_set():
            raise RuntimeError(f"batcher {self.name!r} is stopped")
        p = _Pending(payload, ctx)
        with self._cv:
            if self._stop.is_set():
                # re-checked under the lock: stop() may have drained since
                raise RuntimeError(f"batcher {self.name!r} is stopped")
            if len(self._q) >= self.config.max_queue:
                self.shed += 1
                self.shed_counter.inc()
                raise OverloadedError(self.name, len(self._q),
                                      self.config.max_queue)
            if self.t_first is None:
                self.t_first = p.t_enq
            self._q.append(p)
            self._cv.notify()
        return p.future

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._q)

    # -- flush thread -------------------------------------------------------
    def _loop(self) -> None:
        deadline_s = self.config.deadline_ms / 1e3
        max_batch = self.config.max_batch
        while True:
            with self._cv:
                while not self._q and not self._stop.is_set():
                    self._cv.wait()
                    self.idle_wakeups += 1
                if self._stop.is_set() and not self._q:
                    return
                # wait for a full batch, bounded by the oldest request's
                # deadline (submit() notifies on growth)
                cause = "size"
                while len(self._q) < max_batch and not self._stop.is_set():
                    remaining = deadline_s - (
                        time.monotonic() - self._q[0].t_enq)
                    if remaining <= 0:
                        cause = "deadline"
                        break
                    self._cv.wait(remaining)
                if self._stop.is_set():
                    cause = "stop"        # the final drain
                batch = [self._q.popleft()
                         for _ in range(min(max_batch, len(self._q)))]
            self._flush(batch, cause)

    def _flush(self, batch: List[_Pending], cause: str) -> None:
        # claim every future first: a request cancelled while queued is
        # skipped instead of raising InvalidStateError in this thread
        live = [p for p in batch if p.future.set_running_or_notify_cancel()]
        bucket = bucket_for(len(batch), self._buckets)
        t_claim = time.monotonic()
        if trace.enabled():
            for p in live:
                if p.ctx is not None:
                    trace.record_span("queue.wait", p.ctx, p.t_enq, t_claim,
                                      cause=cause)
        error = None
        try:
            results = self._run_batch([p.payload for p in batch], bucket)
        except Exception as exc:
            error = exc
        now = time.monotonic()
        if trace.enabled():
            err_attr = ({"error": type(error).__name__} if error is not None
                        else {})
            for p in live:
                if p.ctx is not None:
                    trace.record_span("batch.exec", p.ctx, t_claim, now,
                                      bucket=bucket, batch_n=len(batch),
                                      cause=cause, **err_attr)
        if error is not None:
            for p in live:
                p.future.set_exception(error)
            return
        self.flushes.append((len(batch), bucket, cause))
        done = 0
        for p, r in zip(batch, results):
            if p.future.running():          # claimed above, not cancelled
                p.future.set_result(r)
                self.hist.record((now - p.t_enq) * 1e3)
                done += 1
        self.completed += done

    # -- stats / lifecycle --------------------------------------------------
    def stats(self) -> dict:
        elapsed = (time.monotonic() - self.t_first) if self.t_first else 0.0
        issued = self.completed + self.shed
        return {
            "completed": self.completed,
            "shed": self.shed,
            "shed_rate": self.shed / issued if issued else 0.0,
            "qps": self.completed / elapsed if elapsed > 0 else 0.0,
            **{k: v for k, v in self.hist.summary().items() if k != "count"},
        }

    def stop(self) -> None:
        """Flush whatever is queued, then retire the thread."""
        with self._cv:
            self._stop.set()
            self._cv.notify_all()
        self._thread.join(timeout=10)
