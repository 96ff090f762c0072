"""URI-dispatched binary streams, a buffered text reader and the ``MVTA``
array record.

Counterpart of ``multiverso_tpu/io/stream.py``:

* :class:`URI`, :func:`register_scheme`, :func:`open_stream`,
  :func:`is_remote` and :class:`TextReader` (JAX :28-118). ``file://``
  URIs and bare paths open local files; ``memory://`` registers on first
  use (``io/remote.py``, an in-process object store). ``gs://`` and
  ``hdfs://`` raise :class:`~..log.FatalError` before any import is tried:
  their backends (tensorstore, fsspec over WebHDFS) wait for ROADMAP.md
  Queue 1 item 7b. A scheme with no handler never opens as a local path.
* ``write_array``, ``_read_record_header``, ``read_array`` and
  ``validate_record_stream`` (JAX :122-218), byte for byte: ``b"MVTA"``,
  a ``<B`` dtype-tag length, the ASCII tag (numpy's ``dtype.str``, e.g.
  ``<f4``, or the name of an extension dtype), a ``<B`` ndim, one ``<q``
  per dimension, then the raw C-order buffer.

numpy has no bfloat16 and the port does not need ``ml_dtypes``: a torch
bf16 tensor is written as its raw 16-bit words tagged ``bfloat16`` (the
JAX package's bytes for an ``ml_dtypes`` array) and a ``bfloat16``
record reads back as a torch CPU bf16 tensor. Every other record reads
back as a numpy array.
"""

from __future__ import annotations

import io as _io
import os
import struct
from typing import Any, BinaryIO, Callable, Dict, Iterator, Optional

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


_OPENERS: Dict[str, Callable[[URI, str], BinaryIO]] = {}

# schemes whose backends are not ported: refused before any import
_UNPORTED_SCHEMES = {
    "gs": "gs:// (GCS objects over tensorstore)",
    "hdfs": "hdfs:// (WebHDFS over fsspec)",
}


def register_scheme(scheme: str, opener: Callable[[URI, str], BinaryIO]
                    ) -> None:
    _OPENERS[scheme] = opener


def _open_local(uri: URI, mode: str) -> BinaryIO:
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(uri.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    return open(uri.path, mode)


register_scheme("file", _open_local)


def open_stream(uri: str, mode: str = "rb") -> BinaryIO:
    """``StreamFactory::GetStream`` (``src/io/io.cpp:8-21``): a binary
    stream from the scheme's opener; a local write creates the parent
    directories."""
    parsed = URI(uri)
    opener = _OPENERS.get(parsed.scheme)
    if opener is None and parsed.scheme in _UNPORTED_SCHEMES:
        Log.fatal(f"no stream handler for {uri}: "
                  f"{_UNPORTED_SCHEMES[parsed.scheme]} is not ported to "
                  f"multiverso_tpu_torch yet (ROADMAP.md Queue 1 item 7b)")
    if opener is None and parsed.scheme == "memory":
        # the in-process object store registers on first use, as the JAX
        # package's remote backends do
        from . import remote

        remote.register()
        opener = _OPENERS.get(parsed.scheme)
    if opener is None:
        Log.fatal(f"no stream handler for scheme {parsed.scheme!r} ({uri})")
    if "b" not in mode:
        mode += "b"
    return opener(parsed, mode)


def is_remote(path: str) -> bool:
    """True when ``path`` is a non-file URI (no local mkdir/exists)."""
    return URI(path).scheme != "file"


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


def validate_record_stream(path: str) -> Optional[str]:
    """Cheap completeness check of a local record file: walks the record
    headers (the shared parser) and checks that every payload fits in the
    file, without loading the arrays; the checkpoint layer's torn-file
    detector. None when complete, else a short reason."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            while True:
                pos = f.tell()
                try:
                    header = _read_record_header(f)
                except ValueError as exc:
                    return f"{exc} at byte {pos}"
                if header is None:
                    return None                   # clean EOF
                dtype, shape = header
                count = int(np.prod(shape)) if shape else 1
                itemsize = 2 if dtype is torch.bfloat16 else dtype.itemsize
                need = count * itemsize
                if size - f.tell() < need:
                    return (f"truncated payload at byte {pos} "
                            f"(record needs {need} bytes)")
                f.seek(need, 1)
    except OSError as exc:
        return str(exc)


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
