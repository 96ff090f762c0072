"""The loader thread (counterpart of ``prefetch_iterator`` in
``multiverso_tpu/parallel/async_buffer.py``)."""

from __future__ import annotations

import queue
import threading


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
