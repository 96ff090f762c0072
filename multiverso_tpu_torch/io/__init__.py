"""I/O layer of the port (counterpart of ``multiverso_tpu/io``): local
streams (``open_stream``, ``TextReader``) and the ``MVTA`` array record
framing of ``io/stream.py``. Remote schemes, checkpoints and the WAL wait
for the durability slice (ROADMAP.md Queue 1 item 7)."""

from .stream import URI, TextReader, open_stream, read_array, write_array

__all__ = ["URI", "TextReader", "open_stream", "read_array", "write_array"]
