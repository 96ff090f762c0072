"""I/O layer of the port (counterpart of ``multiverso_tpu/io``): URI
streams (local paths, ``file://``, ``memory://``), the text reader, the
``MVTA`` array record (``stream``), the ``memory://`` object store
(``remote``), the write-ahead delta journal (``wal``) and session
checkpoints (``checkpoint``). ``gs://``, ``hdfs://`` and the orbax
checkpoints wait (ROADMAP.md Queue 1 items 7b and 8)."""

from .stream import (URI, TextReader, open_stream, read_array,
                     register_scheme, write_array)

__all__ = ["URI", "TextReader", "open_stream", "read_array",
           "register_scheme", "write_array"]
