"""Local streams, a buffered text reader and the ``MVTA`` array record.

Counterpart of ``multiverso_tpu/io/stream.py``:

* :class:`URI`, :func:`open_stream` and :class:`TextReader` (JAX
  :28-118) for local paths and ``file://`` URIs. Any other scheme raises
  :class:`~..log.FatalError`: ``register_scheme``, ``memory://``,
  ``gs://`` and ``hdfs://`` wait for the durability slice (ROADMAP.md
  Queue 1 item 7), and a remote URI is never opened as a local path.
* ``write_array``, ``_read_record_header`` and ``read_array`` (JAX
  :122-218), byte for byte: ``b"MVTA"``, a ``<B`` dtype-tag length, the
  ASCII tag (numpy's ``dtype.str``, e.g. ``<f4``, or the name of an
  extension dtype), a ``<B`` ndim, one ``<q`` per dimension, then the raw
  C-order buffer.

numpy has no bfloat16 and the port does not need ``ml_dtypes``: a torch
bf16 tensor is written as its raw 16-bit words tagged ``bfloat16`` (the
JAX package's bytes for an ``ml_dtypes`` array) and a ``bfloat16``
record reads back as a torch CPU bf16 tensor. Every other record reads
back as a numpy array. ``validate_record_stream`` waits for item 7 too.
"""

from __future__ import annotations

import io as _io
import os
import struct
from typing import Any, BinaryIO, Iterator, Optional

import numpy as np
import torch

from ..log import Log


class URI:
    """Scheme/host/path split (``io.h:24-56``); a bare path is ``file``."""

    def __init__(self, uri: str) -> None:
        self.uri = uri
        if "://" in uri:
            self.scheme, rest = uri.split("://", 1)
            if "/" in rest:
                self.host, path = rest.split("/", 1)
                self.path = "/" + path
            else:
                self.host, self.path = rest, "/"
        else:
            self.scheme, self.host, self.path = "file", "", uri


def open_stream(uri: str, mode: str = "rb") -> BinaryIO:
    """``StreamFactory::GetStream``: a binary stream on a local path or a
    ``file://`` URI; a write creates the parent directories."""
    parsed = URI(uri)
    if parsed.scheme != "file":
        Log.fatal(f"no stream handler for scheme {parsed.scheme!r} ({uri}): "
                  f"only local paths and file:// are ported to "
                  f"multiverso_tpu_torch (remote schemes wait for ROADMAP.md "
                  f"Queue 1 item 7)")
    if "b" not in mode:
        mode += "b"
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(parsed.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(parsed.path, mode)


class TextReader:
    """Buffered line reader (``io.h:114-130``): lines decoded as UTF-8
    with replacement, line ends stripped."""

    def __init__(self, uri: str, buf_size: int = 1 << 20) -> None:
        self._stream = open_stream(uri, "rb")
        self._reader = _io.BufferedReader(self._stream, buffer_size=buf_size)

    def get_line(self) -> Optional[str]:
        line = self._reader.readline()
        if not line:
            return None
        return line.decode("utf-8", errors="replace").rstrip("\r\n")

    def __iter__(self) -> Iterator[str]:
        while True:
            line = self.get_line()
            if line is None:
                return
            yield line

    def close(self) -> None:
        self._reader.close()

    def __enter__(self) -> "TextReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

_MAGIC = b"MVTA"
BF16_TAG = "bfloat16"


def write_array(stream: BinaryIO, array: Any) -> None:
    """Append one record of ``array`` (numpy or torch) to ``stream``."""
    if isinstance(array, torch.Tensor) and array.dtype == torch.bfloat16:
        t = array.detach().contiguous().cpu()
        tag, shape = BF16_TAG, tuple(t.shape)
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        if isinstance(array, torch.Tensor):
            array = array.detach().cpu().numpy()
        array = np.ascontiguousarray(array)
        tag = (array.dtype.str if array.dtype.kind != "V"
               else array.dtype.name)
        shape, raw = array.shape, array.tobytes()
    dtype_tag = tag.encode("ascii")
    stream.write(_MAGIC)
    stream.write(struct.pack("<B", len(dtype_tag)))
    stream.write(dtype_tag)
    stream.write(struct.pack("<B", len(shape)))
    for dim in shape:
        stream.write(struct.pack("<q", dim))
    stream.write(raw)


def _read_record_header(stream: BinaryIO):
    """``(dtype, shape)`` of the next record, or None at a clean EOF;
    ``dtype`` is a numpy dtype, or ``torch.bfloat16`` for a ``bfloat16``
    tag. Raises ValueError on a malformed or truncated header."""
    magic = stream.read(4)
    if not magic:
        return None
    if magic != _MAGIC:
        raise ValueError(f"bad table record magic {magic!r}")
    head = stream.read(1)
    if len(head) < 1:
        raise ValueError("truncated record header")
    (tag_len,) = struct.unpack("<B", head)
    tag = stream.read(tag_len)
    ndim_b = stream.read(1)
    if len(tag) < tag_len or len(ndim_b) < 1:
        raise ValueError("truncated record header")
    (ndim,) = struct.unpack("<B", ndim_b)
    dims = stream.read(8 * ndim)
    if len(dims) < 8 * ndim:
        raise ValueError("truncated record header")
    shape = (tuple(struct.unpack(f"<{ndim}q", dims)) if ndim else ())
    if tag == BF16_TAG.encode("ascii"):
        return torch.bfloat16, shape
    try:
        dtype = np.dtype(tag.decode("ascii"))
    except (TypeError, UnicodeDecodeError):
        raise ValueError(f"unknown dtype tag {tag!r}") from None
    return dtype, shape


def read_array(stream: BinaryIO) -> Any:
    """The next record: a numpy array, or a torch CPU bf16 tensor."""
    try:
        header = _read_record_header(stream)
    except ValueError as exc:
        Log.fatal(f"bad table record: {exc}")
    if header is None:
        Log.fatal("bad table record: unexpected end of stream")
    dtype, shape = header
    count = int(np.prod(shape)) if shape else 1
    if dtype is torch.bfloat16:
        words = np.frombuffer(stream.read(count * 2), np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
    buf = stream.read(count * dtype.itemsize)
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()
