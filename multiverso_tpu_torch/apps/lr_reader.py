"""Async sample readers for the LogisticRegression app.

Counterpart of ``multiverso_tpu/apps/lr_reader.py`` (the reference's
background ``SampleReader`` family, ``LR/src/reader.{h,cpp}``): a loader
thread parses ahead into a bounded ring while the trainer consumes
samples, and per-window *keysets* (the feature keys the next window of
samples touches) are published on a queue so that the pipelined sparse
model pulls exactly the rows the next sync window needs (the reference
keyset queue, ``LR/src/reader.cpp:159-198``, consumed by
``PSModel::GetPipelineTable``, ``LR/src/model/ps_model.cpp:236``).

Reader variants (factory :func:`sample_iterator`, ``SampleReader::Get``,
``LR/src/reader.cpp:212-229``):

* ``default`` — libsvm ``label k:v ...`` (sparse) or ``label v v ...``
  (dense) text (``LR/src/reader.cpp:169-207``);
* ``weight`` — ``label:weight k:v ...``; feature values are scaled by the
  sample weight, the bias is not (``LR/src/reader.cpp:233-278``);
* ``bsparse`` — packed binary sparse records
  ``<u64 nkeys> <i32 label> <f64 weight> <u64 keys[nkeys]>`` whose every
  feature value is the record weight (``LR/src/reader.cpp:382-444``);
  :func:`write_bsparse` writes the format. The port always reads it with
  the Python reader below: the JAX package's optional C++ parser
  (``native.parse_bsparse``, JAX :143-160) waits for ``native.py``
  (ROADMAP.md Queue 1 item 9). Both give the same samples.

None of the readers appends the bias term: the model classes own the bias
key (``LogRegConfig.input_size``), so every reader and the test path share
one convention.
"""

from __future__ import annotations

import queue
import struct
import threading
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..io.stream import TextReader, open_stream
from ..log import Log

#: (label, keys, values) — keys int64, values float64.
Sample = Tuple[float, np.ndarray, np.ndarray]

_BSPARSE_HEAD = struct.Struct("<qid")  # nkeys, label, weight


def _parse_features(parts: List[str], sparse: bool, input_size: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Feature tokens (already split) -> (keys, values)."""
    if sparse:
        keys, vals = [], []
        for tok in parts:
            k, _, v = tok.partition(":")
            keys.append(int(k))
            vals.append(float(v) if v else 1.0)
        return np.asarray(keys, np.int64), np.asarray(vals, np.float64)
    vals = np.zeros(input_size, np.float64)
    dense = [float(t) for t in parts]
    vals[: len(dense)] = dense
    return np.arange(len(dense), dtype=np.int64), vals


def parse_default(line: str, sparse: bool, input_size: int) -> Sample:
    """``label k:v ...`` / ``label v v ...`` (``LR/src/reader.cpp:169``)."""
    parts = line.split()
    keys, vals = _parse_features(parts[1:], sparse, input_size)
    return float(parts[0]), keys, vals


def parse_weighted(line: str, sparse: bool, input_size: int) -> Sample:
    """``label:weight k:v ...`` — values scaled by the sample weight
    (``WeightedSampleReader::ParseLine``, ``LR/src/reader.cpp:233``)."""
    parts = line.split()
    head, _, wtok = parts[0].partition(":")
    weight = float(wtok) if wtok else 1.0
    keys, vals = _parse_features(parts[1:], sparse, input_size)
    return float(head), keys, vals * weight


def write_bsparse(path: str, samples: Iterable[Sample]) -> int:
    """Write packed binary sparse records; returns the record count.

    Layout per record matches ``BSparseSampleReader::ParseSample``
    (``LR/src/reader.cpp:382-444``): ``<u64 nkeys><i32 label><f64 weight>``
    then ``nkeys`` little-endian u64 keys.  The per-record scalar feature
    value is stored as the *weight* (the format carries keys only).
    """
    count = 0
    with open_stream(path, "wb") as stream:
        for label, keys, values in samples:
            keys = np.asarray(keys, np.int64)
            vals = np.asarray(values, np.float64)
            weight = float(vals[0]) if vals.size else 1.0
            stream.write(_BSPARSE_HEAD.pack(keys.size, int(label), weight))
            stream.write(keys.astype("<i8").tobytes())
            count += 1
    return count


def iter_bsparse(path: str, chunk_size: int = 1 << 20) -> Iterator[Sample]:
    """Stream bsparse records (``BSparseSampleReader``, chunked reads
    mirroring ``LoadDataChunk``, ``LR/src/reader.cpp:367-379``)."""
    with open_stream(path, "rb") as stream:
        buf = b""
        offset = 0
        while True:
            if len(buf) - offset < _BSPARSE_HEAD.size:
                buf = buf[offset:] + stream.read(chunk_size)
                offset = 0
                if len(buf) < _BSPARSE_HEAD.size:
                    if buf:
                        raise EOFError(
                            f"truncated bsparse record header in {path}")
                    return
            nkeys, label, weight = _BSPARSE_HEAD.unpack_from(buf, offset)
            offset += _BSPARSE_HEAD.size
            nbytes = 8 * nkeys
            while len(buf) - offset < nbytes:
                more = stream.read(max(chunk_size, nbytes))
                if not more:
                    raise EOFError(f"truncated bsparse record in {path}")
                buf = buf[offset:] + more
                offset = 0
            keys = np.frombuffer(buf, "<i8", nkeys, offset).astype(np.int64)
            offset += nbytes
            yield float(label), keys, np.full(nkeys, weight, np.float64)


def sample_iterator(reader_type: str, files: str, sparse: bool,
                    input_size: int) -> Iterator[Sample]:
    """Reader factory (``SampleReader::Get``, ``LR/src/reader.cpp:212``).

    ``files`` is a comma-separated list read in order, like the reference's
    multi-file ``files_`` vector (``LR/src/reader.cpp:150-155``).
    """
    paths = [p for p in (s.strip() for s in files.split(",")) if p]
    if reader_type == "bsparse":
        if not sparse:
            Log.fatal("bsparse reader requires sparse=true "
                      "(LR/src/reader.cpp:296 LR_CHECK(sparse))")
        for path in paths:
            yield from iter_bsparse(path)
        return
    parse = parse_weighted if reader_type == "weight" else parse_default
    if reader_type not in ("default", "weight"):
        Log.fatal(f"unknown reader_type {reader_type!r} "
                  "(expected default|weight|bsparse)")
    for path in paths:
        with TextReader(path) as reader:
            for line in reader:
                if line.strip():
                    yield parse(line, sparse, input_size)


class AsyncSampleReader:
    """Background-thread sample pipeline with per-window keyset publication.

    The loader thread parses ahead into a bounded queue (the reference's
    ring of ``max_row_buffer_count`` samples, ``LR/src/reader.cpp:128``)
    while the trainer consumes; every ``window_size`` samples the set of
    keys they touch is published so :meth:`next_keyset` can drive a
    pipelined pull of exactly the rows the *next* sync window needs
    (reference ``keys_`` queue + ``GetKeys``).

    Keysets always include ``bias_key`` when given, matching the reference
    appending the bias row to every keyset (``LR/src/reader.cpp:186-194``).
    """

    _DONE = object()

    def __init__(self, samples: Iterable[Sample], window_size: int,
                 bias_key: Optional[int] = None,
                 buffer_samples: int = 4096) -> None:
        self._samples = samples
        self._window = max(int(window_size), 1)
        self._bias_key = bias_key
        self._queue: "queue.Queue" = queue.Queue(max(buffer_samples, 1))
        self._keysets: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._main, name="mv-sample-reader", daemon=True)
        self._thread.start()

    def _main(self) -> None:
        touched: set = set()
        count = 0
        try:
            for sample in self._samples:
                if self._stop.is_set():
                    return
                touched.update(int(k) for k in sample[1])
                count += 1
                if count == self._window:
                    self._publish_keyset(touched)
                    touched, count = set(), 0
                while not self._stop.is_set():
                    try:
                        self._queue.put(sample, timeout=0.1)
                        break
                    except queue.Full:
                        continue
            if touched:
                self._publish_keyset(touched)
        except BaseException as exc:  # surfaced on the consumer side
            self._error = exc
        finally:
            self._queue.put(self._DONE)

    def _publish_keyset(self, touched: set) -> None:
        if self._bias_key is not None:
            touched.add(int(self._bias_key))
        self._keysets.put(np.asarray(sorted(touched), np.int64))

    def __iter__(self) -> Iterator[Sample]:
        while True:
            item = self._queue.get()
            if item is self._DONE:
                if self._error is not None:
                    raise self._error
                return
            yield item

    def next_keyset(self, timeout: Optional[float] = None
                    ) -> Optional[np.ndarray]:
        """Keyset for the next window; None only once the stream is drained.

        Blocks while the producer is still parsing (by default without
        limit — a slow source delays the pull, it doesn't disable it). With
        ``timeout`` set, expiry raises :class:`TimeoutError` so a slow
        producer is never mistaken for end-of-stream.
        """
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._keysets.get(timeout=0.1)
            except queue.Empty:
                if not self._thread.is_alive() and self._keysets.empty():
                    return None
                if timeout is not None:
                    timeout -= 0.1
                    if timeout <= 0:
                        raise TimeoutError(
                            "next_keyset: producer still running after "
                            "timeout")

    def close(self) -> None:
        self._stop.set()
        # drain so the producer can observe the stop flag promptly
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass


def batched(samples: Iterable[Sample], batch_size: int
            ) -> Iterator[List[Sample]]:
    """Group a sample stream into minibatches (trailing partial included)."""
    batch: List[Sample] = []
    for sample in samples:
        batch.append(sample)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
