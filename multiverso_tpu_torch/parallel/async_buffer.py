"""Host-side double buffering (counterpart of
``multiverso_tpu/parallel/async_buffer.py``).

* :class:`ASyncBuffer` — the reference ``ASyncBuffer``
  (``include/multiverso/util/async_buffer.h:11-116``): a background thread
  fills the buffer the consumer does not hold.
* :func:`prefetch_iterator` — the loader thread.
* :class:`PipelinedGetter` — the LogReg ``GetPipelineTable`` pattern
  (``LR/src/model/ps_model.cpp:236``): the next sync window's keys are
  pulled on a thread while the current window trains. The pull is a
  table ``get_keys`` (the row gather kernel and a readback) taken under
  the table lock on the same CUDA stream as the trainer's adds, so it
  sees every add enqueued before it.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class ASyncBuffer(Generic[T]):
    """Two buffers + one background filler thread."""

    def __init__(self, buffer0: T, buffer1: T,
                 fill_fn: Callable[[T], None]) -> None:
        self._buffers = [buffer0, buffer1]
        self._fill_fn = fill_fn
        self._ready: "queue.Queue[int]" = queue.Queue(maxsize=2)
        self._todo: "queue.Queue[Optional[int]]" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._consumer_idx: Optional[int] = None
        self._stopped = False
        self._thread.start()
        self._todo.put(0)  # prefetch into buffer 0 immediately

    def _main(self) -> None:
        while True:
            idx = self._todo.get()
            if idx is None:
                return
            self._fill_fn(self._buffers[idx])
            self._ready.put(idx)

    def get(self) -> T:
        """Wait for the prefetched buffer, hand it out, prefetch the other.
        Acquiring buffer ``i`` releases the one held before, which (two
        buffers) is always ``1 - i``: it becomes the next fill target."""
        if self._stopped:
            raise RuntimeError("ASyncBuffer is stopped; call restart() first")
        idx = self._ready.get()
        self._consumer_idx = idx
        self._todo.put(1 - idx)
        return self._buffers[idx]

    def join(self) -> None:
        """Stop the filler thread (reference ``Join``); restartable."""
        if self._stopped:
            return
        self._todo.put(None)
        self._thread.join()
        self._stopped = True

    def restart(self) -> None:
        if not self._stopped:
            return
        self._stopped = False
        self._thread = threading.Thread(target=self._main, daemon=True)
        self._thread.start()
        if self._ready.empty() and self._todo.empty():
            # nothing prefetched and nothing scheduled: prime the buffer
            # the consumer does not hold
            idx = self._consumer_idx
            self._todo.put(1 - idx if idx is not None else 0)


def prefetch_iterator(iterable, depth: int = 2):
    """Background-thread prefetch of an iterator.

    The loader-thread pattern (reference ``BlockQueue`` +
    ``LoadDataFromFile`` thread, ``WE/src/distributed_wordembedding.cpp:
    33-56``): the producer runs ``depth`` items ahead on a daemon thread so
    host batch building overlaps the device's steps. Items come out in the
    producer's order; an exception in the producer is raised at the
    consumer, after the items before it. Closing the generator early stops
    the producer at its next item.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(entry) -> bool:
        # bounded put that gives up when the consumer is gone, so an
        # abandoned generator does not leak a thread blocked on a full queue
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            try:
                for item in iterable:
                    if not put((None, item)):
                        return
            except BaseException as exc:  # raised again at the consumer
                put((exc, None))
                return
            put((done, None))
        finally:
            close = getattr(iterable, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    try:
        while True:
            exc, item = q.get()
            if exc is done:
                return
            if exc is not None:
                raise exc
            yield item
    finally:
        stop.set()


class PipelinedGetter:
    """Double-buffered table Gets keyed by a per-window keyset: while the
    consumer trains on window *i*'s parameters, the next window's keyset
    is being fetched. ``get(next_keys)`` returns the fetch in flight and
    starts the one for ``next_keys``."""

    def __init__(self, fetch_fn: Callable[[object], object]) -> None:
        self._fetch_fn = fetch_fn
        self._thread: Optional[threading.Thread] = None
        self._result_q: "queue.Queue" = queue.Queue(maxsize=1)

    def prime(self, keys) -> None:
        """Start the first fetch (on a background thread)."""
        self._start(keys)

    def _start(self, keys) -> None:
        def run():
            self._result_q.put(self._fetch_fn(keys))

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def get(self, next_keys=None):
        """Wait on the fetch in flight; optionally start the next one."""
        if self._thread is None:
            raise RuntimeError("call prime(keys) before get()")
        result = self._result_q.get()
        self._thread.join()
        self._thread = None
        if next_keys is not None:
            self._start(next_keys)
        return result
