"""The ``memory://`` object store: an in-process stand-in for object storage.

Counterpart of the ``memory://`` half of ``multiverso_tpu/io/remote.py``
(:35-185), which keeps its objects in tensorstore's memory driver under
one shared context. Here the store is a plain process-wide dict under one
lock, with the same semantics:

* ``memory://name/path`` — the host part (``name``) is a namespace; the
  object's key is ``name/path``;
* a write stream buffers locally and commits ONE object at ``close``
  (object stores have no append: the reference's HDFS stream commits on
  ``Flush``/close the same way); a ``with`` block that raises, or
  :meth:`_MemoryWriteStream.abort`, commits nothing;
* a read stream copies the object once; reading a missing object raises
  ``FileNotFoundError``;
* :func:`exists`, :func:`list_subdirs_with` and :func:`delete_prefix` are
  the three probes a checkpoint root needs (step discovery, manifest
  checks, pruning).

``gs://`` (GCS over tensorstore) and ``hdfs://`` (WebHDFS over fsspec) are
not here: they wait for ROADMAP.md Queue 1 item 7b, and ``io/stream``
refuses them before any import. The lock is a plain ``threading.Lock``
(the JAX package's lock-order witness is ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import io
import threading
from typing import BinaryIO, Dict, List

from ..log import Log
from .stream import URI, register_scheme

_lock = threading.Lock()
_objects: Dict[str, bytes] = {}   # "namespace/key" -> committed bytes


def _key_for(uri) -> str:
    """The store key of a parsed ``memory://`` URI."""
    if uri.scheme != "memory":
        Log.fatal(f"unsupported remote scheme {uri.scheme!r} ({uri.uri}): "
                  f"only memory:// is ported to multiverso_tpu_torch "
                  f"(ROADMAP.md Queue 1 item 7b)")
    key = uri.path.lstrip("/")
    return f"{uri.host}/{key}" if uri.host else key


class _MemoryReadStream(io.BytesIO):
    """Whole-object read stream."""

    def __init__(self, key: str, uri: str) -> None:
        with _lock:
            data = _objects.get(key)
        if data is None:
            raise FileNotFoundError(uri)
        super().__init__(data)


class _MemoryWriteStream(io.BytesIO):
    """Buffered write stream; commits one object at close."""

    def __init__(self, key: str) -> None:
        super().__init__()
        self._key = key
        self._aborted = False

    def abort(self) -> None:
        """Discard the buffer: the next close() commits nothing."""
        self._aborted = True

    def __exit__(self, exc_type, exc, tb):
        # a `with` block that raises mid-write must not publish the
        # truncated object beside the manifest-last protocol
        if exc_type is not None:
            self._aborted = True
        return super().__exit__(exc_type, exc, tb)

    def close(self) -> None:
        if not self.closed and not self._aborted:
            data = self.getvalue()
            with _lock:
                _objects[self._key] = data
        super().close()


def open_remote(uri, mode: str) -> BinaryIO:
    """Scheme opener for :func:`io.stream.register_scheme`."""
    key = _key_for(uri)
    if "w" in mode:
        return _MemoryWriteStream(key)
    if "a" in mode:
        Log.fatal(f"append mode unsupported on object store: {uri.uri}")
    return _MemoryReadStream(key, uri.uri)


def exists(uri_str: str) -> bool:
    """Object existence probe (manifest checks on remote checkpoints)."""
    key = _key_for(URI(uri_str))
    with _lock:
        return key in _objects


def list_subdirs_with(root_uri: str, filename: str) -> List[str]:
    """Immediate subdirectory names under ``root_uri`` that hold
    ``filename`` (checkpoint-step discovery: "directories" are key
    prefixes on an object store)."""
    prefix = _key_for(URI(root_uri)).rstrip("/")
    prefix = prefix + "/" if prefix else ""
    with _lock:
        keys = list(_objects)
    names = set()
    for key in keys:
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        if len(parts) == 2 and parts[1] == filename:
            names.add(parts[0])
    return sorted(names)


def delete_prefix(dir_uri: str) -> None:
    """Delete every object under ``dir_uri`` (remote checkpoint pruning)."""
    prefix = _key_for(URI(dir_uri)).rstrip("/") + "/"
    with _lock:
        for key in [k for k in _objects if k.startswith(prefix)]:
            del _objects[key]


def register() -> None:
    register_scheme("memory", open_remote)
